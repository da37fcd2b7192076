"""The decoder model, dense and ssm (RWKV6) families: ``ModelConfig``, the
parameter module, init, forward, logits and losses.

``Model`` is an ``nn.Module`` that holds the parameters; the forward
functions are plain functions of ``(cfg, params, batch)`` like the JAX
package's, where ``params`` is the module's :meth:`Model.tree` — a nested
dict of tensors in the JAX layouts, with ``blocks`` a list of per-layer
dicts (the JAX package stacks them on a leading L axis;
``checkpoint/jax_bridge.py`` converts).

The moe / hybrid / audio / vlm families and ``remat="dots"`` are not
ported (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import ssm as S

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 1024
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    layer_pattern: Tuple[str, ...] = ("global",)   # cycled; "local"|"global"
    global_layer_indices: Tuple[int, ...] = ()     # explicit global islands (hymba)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    post_block_norm: bool = False                  # gemma2 post-norms
    mlp_activation: str = "silu"
    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_local_groups: bool = False
    first_k_dense: int = 0
    d_ff_dense: int = 0
    # ssm / hybrid
    ssm_state: int = 0
    # frontend stubs
    frontend: Optional[str] = None                 # audio_frames | vision_patches
    num_patches: int = 0
    # misc
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    # perf knobs
    remat: str = "full"                            # none | full | dots
    scan_layers: bool = True                       # JAX-only (layers always loop)
    attn_backend: str = "auto"                     # auto | dense | chunked | flash
    attn_chunk: int = 0
    loss_chunk: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def is_local_pattern(self) -> np.ndarray:
        """(L,) bool: which layers use the sliding window."""
        idx = np.arange(self.num_layers)
        if self.global_layer_indices:
            return ~np.isin(idx, np.asarray(self.global_layer_indices))
        pat = np.array([p == "local" for p in self.layer_pattern])
        return pat[idx % len(pat)]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm") or cfg.frontend is not None \
            or cfg.first_k_dense:
        raise NotImplementedError(
            f"model family '{cfg.family}' (frontend {cfg.frontend}) is not "
            "ported to repro_torch yet; only the dense and ssm families are "
            "(see ROADMAP.md)")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat='{cfg.remat}' is not ported (use 'none' or 'full'; see ROADMAP.md)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One residual block's parameters (JAX layouts): attention + MLP
    (dense), or RWKV time mix + channel mix (ssm)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H, Hkv, Dh, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.d_ff)
        dt = cfg.dtype

        def w(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.ln1 = w(D, dtype=torch.float32)
        self.ln2 = w(D, dtype=torch.float32)
        if cfg.family == "ssm":
            self.time = nn.ParameterDict({n: w(*shape, dtype=t) for n, (shape, t)
                                          in S.rwkv_time_shapes(cfg, dt).items()})
            self.channel = nn.ParameterDict({n: w(*shape, dtype=t) for n, (shape, t)
                                             in S.rwkv_channel_shapes(cfg, dt).items()})
            return
        self.attn = nn.ParameterDict({"wq": w(D, H, Dh), "wk": w(D, Hkv, Dh),
                                      "wv": w(D, Hkv, Dh), "wo": w(H, Dh, D)})
        if cfg.qkv_bias:
            self.attn.update({"bq": w(H, Dh), "bk": w(Hkv, Dh), "bv": w(Hkv, Dh)})
        self.mlp = nn.ParameterDict({"w_gate": w(D, Fd), "w_up": w(D, Fd),
                                     "w_down": w(Fd, D)})
        if cfg.post_block_norm:
            self.ln1_post = w(D, dtype=torch.float32)
            self.ln2_post = w(D, dtype=torch.float32)

    def tree(self) -> Dict[str, Any]:
        if hasattr(self, "time"):
            return {"ln1": self.ln1, "time": dict(self.time),
                    "ln2": self.ln2, "channel": dict(self.channel)}
        out: Dict[str, Any] = {"ln1": self.ln1, "attn": dict(self.attn),
                               "ln2": self.ln2, "mlp": dict(self.mlp)}
        if hasattr(self, "ln1_post"):
            out["ln1_post"], out["ln2_post"] = self.ln1_post, self.ln2_post
        return out


class Model(nn.Module):
    """All parameters of one decoder. Values are uninitialized until
    :func:`init_params` draws them or the JAX bridge loads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = nn.Parameter(torch.empty((V, D), dtype=cfg.dtype, device=device))
        self.final_norm = nn.Parameter(torch.empty(D, dtype=torch.float32, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((D, V), dtype=cfg.dtype, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))

    def tree(self) -> Dict[str, Any]:
        """The parameter pytree the forward functions take."""
        out: Dict[str, Any] = {"embed": self.embed, "final_norm": self.final_norm,
                               "blocks": [b.tree() for b in self.blocks]}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        return out


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """A ``Model`` with values drawn from ``generator`` (on ``device``) with
    the JAX package's distributions: normal weights scaled by fan-in
    (embed × 0.02), zero norm scales and biases; the RWKV params as
    ``models/ssm.py`` draws them. The draws differ from
    ``jax.random``'s; load JAX weights through ``checkpoint/jax_bridge.py``
    where bit-equal weights matter."""
    model = Model(cfg, device)
    D, H, Dh, Fd = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff

    def normal_(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=p.device)
        p.copy_((x * scale).to(p.dtype))

    normal_(model.embed, 0.02)
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        normal_(model.lm_head, D ** -0.5)
    for b in model.blocks:
        b.ln1.zero_()
        b.ln2.zero_()
        if cfg.family == "ssm":
            S.init_rwkv_time_params(b.time, cfg, generator)
            S.init_rwkv_channel_params(b.channel, cfg, generator)
            continue
        for name in ("wq", "wk", "wv"):
            normal_(b.attn[name], D ** -0.5)
        normal_(b.attn["wo"], (H * Dh) ** -0.5)
        for name in ("bq", "bk", "bv"):
            if name in b.attn:
                b.attn[name].zero_()
        normal_(b.mlp["w_gate"], D ** -0.5)
        normal_(b.mlp["w_up"], D ** -0.5)
        normal_(b.mlp["w_down"], Fd ** -0.5)
        if cfg.post_block_norm:
            b.ln1_post.zero_()
            b.ln2_post.zero_()
    return model


def _tree(params) -> Dict[str, Any]:
    return params.tree() if isinstance(params, Model) else params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, p, x, positions, is_local: bool):
    """One residual block of the config's family."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    if cfg.family == "ssm":
        t_out, _ = S.rwkv_time_mix(cfg, p["time"], h)
        x = x + t_out
        c_out, _ = S.rwkv_channel_mix(cfg, p["channel"],
                                      L.rms_norm(x, p["ln2"], cfg.rms_eps))
        return x + c_out
    attn_out, _ = L.attention(cfg, p["attn"], h, positions, is_local=is_local)
    if cfg.post_block_norm:
        attn_out = L.rms_norm(attn_out, p["ln1_post"], cfg.rms_eps)
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    ff = L.mlp(cfg, p["mlp"], h2)
    if cfg.post_block_norm:
        ff = L.rms_norm(ff, p["ln2_post"], cfg.rms_eps)
    return x + ff


# ---------------------------------------------------------------------------
# forward / loss / features
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S) int32, loss_mask (B,S) f32)."""
    _check_supported(cfg)
    params = _tree(params)
    tokens = batch["tokens"]
    x = torch.nn.functional.embedding(tokens.long(), params["embed"])
    B, Sq = tokens.shape
    positions = torch.arange(Sq, dtype=torch.int32,
                             device=tokens.device).expand(B, Sq)
    mask = torch.ones((B, Sq), dtype=torch.float32, device=tokens.device)
    return x, positions, mask


def forward_hiddens(cfg: ModelConfig, params, batch
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward through the stack → (hiddens (B,S,D), loss_mask (B,S)).

    ``remat="full"`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), the port of
    ``jax.checkpoint`` per scanned block."""
    params = _tree(params)
    x, positions, mask = embed_inputs(cfg, params, batch)
    is_local = cfg.is_local_pattern()
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for i, p in enumerate(params["blocks"]):
        local = bool(is_local[i])
        if remat:
            x = checkpoint(_apply_block, cfg, p, x, positions, local,
                           use_reentrant=False)
        else:
            x = _apply_block(cfg, p, x, positions, local)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, mask


def logits_from_hiddens(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    params = _tree(params)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap(h @ head, cfg.final_logit_softcap)


def _nll(cfg: ModelConfig, params, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, S) next-token negative log-likelihood; seq-chunked with
    ``cfg.loss_chunk`` so the (B, S, V) float32 log-softmax never
    materializes whole."""
    S = h.shape[1]
    C = cfg.loss_chunk if cfg.loss_chunk and S > cfg.loss_chunk else S
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of loss_chunk {C}")
    out = []
    for c0 in range(0, S, C):
        logits = logits_from_hiddens(cfg, params, h[:, c0:c0 + C])
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        out.append(-torch.gather(logp, -1, labels[:, c0:c0 + C, None].long())[..., 0])
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE over valid positions."""
    h, mask = forward_hiddens(cfg, params, batch)
    nll = _nll(cfg, params, h, batch["labels"])
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"nll": loss}


def per_example_loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """(B,) per-sequence loss — GRAFT's per-sample signal."""
    h, mask = forward_hiddens(cfg, params, batch)
    nll = _nll(cfg, params, h, batch["labels"])
    return torch.sum(nll * mask, dim=1) / torch.clamp(torch.sum(mask, dim=1), min=1.0)
