"""The decoder model of every family of the JAX package: dense, moe, ssm
(RWKV6), hybrid (Hymba), audio (dense blocks over frame embeddings, the
``audio_frames`` frontend) and vlm (dense blocks over patch embeddings and
text tokens, the ``vision_patches`` frontend): ``ModelConfig``, the
parameter module, init, forward, logits and losses.

``Model`` is an ``nn.Module`` that holds the parameters; the forward
functions are plain functions of ``(cfg, params, batch)`` like the JAX
package's, where ``params`` is the module's :meth:`Model.tree` — a nested
dict of tensors in the JAX layouts, with ``blocks`` a list of per-layer
dicts (the JAX package stacks them on a leading L axis;
``checkpoint/jax_bridge.py`` converts) and, for a config with
``first_k_dense``, ``first_blocks`` a list of dense per-layer dicts (a list
in the JAX tree too).

``_apply_block`` also runs one block against a decode cache
(``models/decode.py``), as the JAX block does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.numerics import take_last, take_rows
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


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
_FRONTENDS = (None, "audio_frames", "vision_patches")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family '{cfg.family}' ({' | '.join(_FAMILIES)})")
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(f"unknown frontend '{cfg.frontend}' (audio_frames | vision_patches)")
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat '{cfg.remat}' (none | full | dots)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One residual block's parameters (JAX layouts): attention + MLP
    (dense, audio and vlm, or ``dense=True`` for a ``first_blocks`` layer of
    width ``d_ff_dense``), attention + MoE (moe), RWKV time mix + channel mix
    (ssm), or attention ∥ SSM heads + MLP (hybrid)."""

    def __init__(self, cfg: ModelConfig, device=None, dense: bool = False):
        super().__init__()
        D, H, Hkv, Dh, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.d_ff)
        dt = cfg.dtype
        fam = "dense" if dense else cfg.family

        def w(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        def pdict(shapes):
            return nn.ParameterDict({n: w(*shape, dtype=t) for n, (shape, t) in shapes.items()})

        self.ln1 = w(D, dtype=torch.float32)
        self.ln2 = w(D, dtype=torch.float32)
        if fam == "ssm":
            self.time = pdict(S.rwkv_time_shapes(cfg, dt))
            self.channel = pdict(S.rwkv_channel_shapes(cfg, dt))
            return
        self.attn = nn.ParameterDict({"wq": w(D, H, Dh), "wk": w(D, Hkv, Dh),
                                      "wv": w(D, Hkv, Dh), "wo": w(H, Dh, D)})
        if cfg.qkv_bias:
            self.attn.update({"bq": w(H, Dh), "bk": w(Hkv, Dh), "bv": w(Hkv, Dh)})
        if fam == "moe":
            self.moe = pdict(L.moe_shapes(cfg, dt))
            return
        if fam == "hybrid":
            self.ssm = pdict(S.ssm_shapes(cfg, dt))
        if dense and cfg.d_ff_dense:
            Fd = cfg.d_ff_dense
        self.mlp = nn.ParameterDict({"w_gate": w(D, Fd), "w_up": w(D, Fd),
                                     "w_down": w(Fd, D)})
        if cfg.post_block_norm and fam in ("dense", "audio", "vlm"):
            self.ln1_post = w(D, dtype=torch.float32)
            self.ln2_post = w(D, dtype=torch.float32)

    def tree(self) -> Dict[str, Any]:
        if hasattr(self, "time"):
            return {"ln1": self.ln1, "time": dict(self.time),
                    "ln2": self.ln2, "channel": dict(self.channel)}
        out: Dict[str, Any] = {"ln1": self.ln1, "attn": dict(self.attn), "ln2": self.ln2}
        for name in ("moe", "ssm", "mlp"):
            if hasattr(self, name):
                out[name] = dict(getattr(self, name))
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
        if cfg.first_k_dense:
            self.first_blocks = nn.ModuleList(Block(cfg, device, dense=True)
                                              for _ in range(cfg.first_k_dense))
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers - cfg.first_k_dense))

    def tree(self) -> Dict[str, Any]:
        """The parameter pytree the forward functions take."""
        out: Dict[str, Any] = {"embed": self.embed, "final_norm": self.final_norm,
                               "blocks": [b.tree() for b in self.blocks]}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        if self.cfg.first_k_dense:
            out["first_blocks"] = [b.tree() for b in self.first_blocks]
        return out


def _leaf_paths(prefix: str, block: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """``(prefix/<name>[/<leaf>], value)`` for each leaf of one block dict."""
    out = []
    for name, sub in block.items():
        if isinstance(sub, dict):
            out += [(f"{prefix}/{name}/{leaf}", t) for leaf, t in sub.items()]
        else:
            out.append((f"{prefix}/{name}", sub))
    return out


def stacked_leaves(model: Model) -> List[Tuple[str, List[torch.Tensor]]]:
    """The JAX param tree's leaves as ``(path, tensors)``, paths as the JAX
    checkpointer flattens them: a ``blocks/<name>[/<leaf>]`` path holds one
    tensor per block (the JAX tree stacks them on a leading L axis), every
    other path one tensor — ``first_blocks/<i>/<name>[/<leaf>]`` among them
    (a list of unstacked blocks in the JAX tree)."""
    tree = model.tree()
    out = [(k, [v]) for k, v in tree.items() if k not in ("blocks", "first_blocks")]
    for i, blk in enumerate(tree.get("first_blocks", [])):
        out += [(path, [t]) for path, t in _leaf_paths(f"first_blocks/{i}", blk)]
    per_block = [_leaf_paths("blocks", b) for b in tree["blocks"]]
    out += [(path, [leaves[j][1] for leaves in per_block])
            for j, (path, _) in enumerate(per_block[0])]
    return out


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """A ``Model`` with values drawn from ``generator`` (on ``device``) with
    the JAX package's distributions: normal weights scaled by fan-in
    (embed × 0.02; the MoE router, float32, × D^-0.5), zero norm scales and
    biases; the RWKV and SSM head params as ``models/ssm.py`` draws them. The draws differ from
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
    for b in list(getattr(model, "first_blocks", [])) + list(model.blocks):
        b.ln1.zero_()
        b.ln2.zero_()
        if hasattr(b, "time"):
            S.init_rwkv_time_params(b.time, cfg, generator)
            S.init_rwkv_channel_params(b.channel, cfg, generator)
            continue
        for name in ("wq", "wk", "wv"):
            normal_(b.attn[name], D ** -0.5)
        normal_(b.attn["wo"], (H * Dh) ** -0.5)
        for name in ("bq", "bk", "bv"):
            if name in b.attn:
                b.attn[name].zero_()
        if hasattr(b, "moe"):
            normal_(b.moe["router"], D ** -0.5)
            normal_(b.moe["w_gate"], D ** -0.5)
            normal_(b.moe["w_up"], D ** -0.5)
            normal_(b.moe["w_down"], Fd ** -0.5)
            continue
        if hasattr(b, "ssm"):
            S.init_ssm_params(b.ssm, cfg, generator)
        normal_(b.mlp["w_gate"], D ** -0.5)
        normal_(b.mlp["w_up"], D ** -0.5)
        normal_(b.mlp["w_down"], b.mlp["w_down"].shape[0] ** -0.5)
        if hasattr(b, "ln1_post"):
            b.ln1_post.zero_()
            b.ln2_post.zero_()
    return model


def _tree(params) -> Dict[str, Any]:
    return params.tree() if isinstance(params, Model) else params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, p, x, positions, is_local: bool,
                 dense_override: bool = False, cache=None, cache_index: int = 0):
    """One residual block of the config's family (dense for a
    ``first_blocks`` layer) → ``(x, new layer cache)``. With ``cache`` (the
    layer's dict of ``models/decode.py``) the block runs S new positions
    against it from ``cache_index`` and returns the updated cache, else
    ``None``. A one-token step through a MoE block is dropless, as in JAX."""
    fam = "dense" if dense_override else cfg.family
    new_cache = None if cache is None else {}
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    if fam == "ssm":
        t_out, t_state = S.rwkv_time_mix(cfg, p["time"], h,
                                         state=None if cache is None else cache["time"])
        x = x + t_out
        c_out, c_state = S.rwkv_channel_mix(
            cfg, p["channel"], L.rms_norm(x, p["ln2"], cfg.rms_eps),
            state=None if cache is None else cache["channel"])
        if cache is not None:
            new_cache["time"], new_cache["channel"] = t_state, c_state
        return x + c_out, new_cache
    attn_out, attn_cache = L.attention(
        cfg, p["attn"], h, positions, is_local=is_local,
        cache=None if cache is None else cache["attn"], cache_index=cache_index)
    if fam == "hybrid":                 # attention and SSM heads in parallel
        ssm_out, ssm_state = S.ssm_heads(cfg, p["ssm"], h,
                                         state=None if cache is None else cache["ssm"])
        attn_out = attn_out + ssm_out
        if cache is not None:
            new_cache["ssm"] = ssm_state
    if cfg.post_block_norm:
        attn_out = L.rms_norm(attn_out, p["ln1_post"], cfg.rms_eps)
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    if fam == "moe":
        ff = L.moe(cfg, p["moe"], h2, dropless=cache is not None and x.shape[1] == 1)
    else:
        ff = L.mlp(cfg, p["mlp"], h2)
    if cfg.post_block_norm:
        ff = L.rms_norm(ff, p["ln2_post"], cfg.rms_eps)
    if cache is not None:
        new_cache["attn"] = attn_cache
    return x + ff, new_cache


# the ops whose outputs ``remat="dots"`` keeps: PyTorch's matrix products,
# the twin of jax.checkpoint_policies.checkpoint_dots (dot_general)
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


# ---------------------------------------------------------------------------
# forward / loss / features
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S) int32, loss_mask (B,S) f32).

    The frontend decides the input: ``frame_embeds`` (audio: every position
    labeled), ``patch_embeds`` followed by the embedded ``tokens`` (vlm: the
    mask is 0 on the patches and 1 on the text), or the embedded ``tokens``."""
    _check_supported(cfg)
    params = _tree(params)
    if cfg.family == "audio" or cfg.frontend == "audio_frames":
        x = batch["frame_embeds"].to(cfg.dtype)
        B, Sq = x.shape[:2]
        mask = torch.ones((B, Sq), dtype=torch.float32, device=x.device)
    elif cfg.family == "vlm" or cfg.frontend == "vision_patches":
        patches = batch["patch_embeds"].to(cfg.dtype)
        tok = take_rows(params["embed"], batch["tokens"])
        x = torch.cat([patches, tok], dim=1)
        B, Sq = x.shape[:2]
        mask = torch.cat([torch.zeros((B, patches.shape[1]), dtype=torch.float32,
                                      device=x.device),
                          torch.ones(batch["tokens"].shape, dtype=torch.float32,
                                     device=x.device)], dim=1)
    else:
        x = take_rows(params["embed"], batch["tokens"])
        B, Sq = x.shape[:2]
        mask = torch.ones((B, Sq), dtype=torch.float32, device=x.device)
    positions = torch.arange(Sq, dtype=torch.int32, device=x.device).expand(B, Sq)
    return x, positions, mask


def forward_hiddens(cfg: ModelConfig, params, batch
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward through the stack → (hiddens (B,S,D), loss_mask (B,S)).

    The ``first_blocks`` run first, dense, global and never recomputed, as
    in the JAX package. Then each block of the stack: ``remat="full"``
    recomputes it in the backward pass (``torch.utils.checkpoint``,
    non-reentrant), the port of ``jax.checkpoint`` per scanned block;
    ``remat="dots"`` keeps the outputs of its matrix products and recomputes
    the rest (selective checkpointing), the port of ``checkpoint_dots``. A
    kernel called through an extension (flash, RWKV) is no matrix product to
    the dispatcher and is recomputed, as a ``pallas_call`` is under
    ``checkpoint_dots``."""
    params = _tree(params)
    x, positions, mask = embed_inputs(cfg, params, batch)
    is_local = cfg.is_local_pattern()
    for p in params.get("first_blocks", []):
        x, _ = _apply_block(cfg, p, x, positions, False, dense_override=True)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    for i, p in enumerate(params["blocks"]):
        local = bool(is_local[cfg.first_k_dense + i])
        if remat == "full":
            x, _ = checkpoint(_apply_block, cfg, p, x, positions, local,
                              use_reentrant=False)
        elif remat == "dots":
            x, _ = checkpoint(_apply_block, cfg, p, x, positions, local,
                              use_reentrant=False, context_fn=_DOTS_CONTEXT)
        else:
            x, _ = _apply_block(cfg, p, x, positions, local)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, mask


def logits_from_hiddens(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    params = _tree(params)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap(h @ head, cfg.final_logit_softcap)


def _pad_labels(labels: torch.Tensor, S: int) -> torch.Tensor:
    """Labels of width S: a vlm batch's text labels are left-padded with 0
    over the patch positions (which the loss mask zeroes)."""
    if labels.shape[1] != S:
        pad = torch.zeros((labels.shape[0], S - labels.shape[1]), dtype=labels.dtype,
                          device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return labels


def _nll(cfg: ModelConfig, params, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, S) next-token negative log-likelihood, ``labels`` padded to S by
    ``_pad_labels``; seq-chunked with ``cfg.loss_chunk`` so the (B, S, V)
    float32 log-softmax never materializes whole."""
    S = h.shape[1]
    labels = _pad_labels(labels, S)
    C = cfg.loss_chunk if cfg.loss_chunk and S > cfg.loss_chunk else S
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of loss_chunk {C}")
    out = []
    for c0 in range(0, S, C):
        logits = logits_from_hiddens(cfg, params, h[:, c0:c0 + C])
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        out.append(-take_last(logp, labels[:, c0:c0 + C]))
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


def pooled_hiddens(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, D) float32 mean of the final hiddens over the loss mask: the
    matrix the feature sources factor (a vlm batch pools its text positions
    only)."""
    return torch.sum(h.to(torch.float32) * mask[..., None], dim=1) / \
        torch.clamp(torch.sum(mask, dim=1), min=1.0)[:, None]


def pooled_features(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """(B, D) mean-pooled final hiddens — GRAFT's feature source."""
    return pooled_hiddens(*forward_hiddens(cfg, params, batch))
