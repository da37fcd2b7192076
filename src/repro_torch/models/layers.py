"""Transformer building blocks: RMSNorm, RoPE, GQA attention (sliding
window, logit softcap, QKV bias), gated MLP.

Functional like the JAX package: every block is ``f(cfg, params, x, ...)``
with ``params`` a dict of tensors, in the JAX layouts (``wq`` (D,H,Dh),
``wk``/``wv`` (D,Hkv,Dh), ``wo`` (H,Dh,D)), so weights cross between the
packages without transposes.

Attention runs one of three backends: ``flash`` (the hand-written Hopper
kernels of ``kernels/flash_attention.py``, one forward launch per layer and
a dQ and a dK/dV launch in its backward), or the dense or KV-chunked path
as plain tensor ops, which is what the JAX package leaves to XLA outside
the flash kernel. The KV-cache (decode) branch and the MoE layer are not
ported (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as flash_lib


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int32."""
    half = x.shape[-1] // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq      # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),  # jax.nn.gelu
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_FLASH_BLOCKS = (128, 64, 32, 16, 8)


def _flash_blocks(S: int, T: int):
    """Largest of the JAX kernel's tile sizes dividing the q/kv lengths
    (None = none fit) — the JAX package's block rule."""
    bq = next((b for b in _FLASH_BLOCKS if S % b == 0), None)
    bk = next((b for b in _FLASH_BLOCKS if T % b == 0), None)
    return bq, bk


def _flash_feasible(cfg, S: int, T: int) -> bool:
    """The JAX block rule plus the Hopper kernels' own limits (head dim,
    shared memory, bf16/f32). The JAX package's 12 MB VMEM guard on the
    whole K/V stream is not copied: the Hopper kernels tile KV, so T is not
    limited, and a shape the TPU would route to chunked can go to flash here."""
    bq, bk = _flash_blocks(S, T)
    return (bq is not None and bk is not None and flash_lib.supports(cfg.head_dim)
            and cfg.param_dtype in ("bfloat16", "float32"))


def resolve_attn_backend(cfg, S: int, T: int, device) -> str:
    """Training backend for this shape on ``device`` → flash | chunked | dense.

    "auto" takes flash on a CUDA device when the shape is feasible, as the
    JAX package does on the TPU, and the dense/chunked paths on the CPU (the
    plain flash version is slower there than the dense path); explicit
    "flash" runs the kernels on CUDA tensors and their plain versions on CPU
    tensors, and falls back to the chunked/dense path only when the shape is
    not feasible.
    """
    b = getattr(cfg, "attn_backend", "auto")
    chunked = "chunked" if cfg.attn_chunk and T > cfg.attn_chunk else "dense"
    if b == "dense":
        return "dense"
    if b == "chunked":
        return chunked
    if b == "flash":
        return "flash" if _flash_feasible(cfg, S, T) else chunked
    if b == "auto":
        if torch.device(device).type == "cuda" and _flash_feasible(cfg, S, T):
            return "flash"
        return chunked
    raise ValueError(f"unknown attn_backend: {b!r}")


def _flash_attention(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     is_local: bool) -> torch.Tensor:
    """One flash launch per layer. q (B,S,H,Dh) pre-scaled (kernel scale 1);
    k/v (B,S,Hkv,Dh). Streams fold head-major (a copy) so q stream i reads kv
    stream i // group without repeating K/V. Assumes contiguous from-zero
    positions (``forward_hiddens``' layout)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]

    def fold(x, heads):
        return x.transpose(1, 2).contiguous().view(B * heads, S, Dh)

    window = cfg.sliding_window if cfg.sliding_window is not None and is_local else None
    out = flash_lib.flash_attention(
        fold(q, H), fold(k, Hkv), fold(v, Hkv), causal=True, window=window,
        softcap=cfg.attn_logit_softcap, group=H // Hkv, scale=1.0)
    return out.view(B, H, S, Dh).transpose(1, 2)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).reshape(*x.shape[:-1], H, K)


def attention(cfg, p, x: torch.Tensor, positions: torch.Tensor,
              *, is_local: bool = False, cache: Optional[dict] = None,
              cache_index=None) -> Tuple[torch.Tensor, None]:
    """GQA self-attention with a causal (+ optional sliding window) mask.
    x: (B, S, D). Returns ``(out, None)`` (no cache: decode is not ported)."""
    if cache is not None:
        raise NotImplementedError(
            "the KV-cache (decode/serving) path is not ported to repro_torch "
            "yet (see ROADMAP.md)")
    B, S, D = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.query_scale is not None:
        q = q * cfg.query_scale
    else:
        q = q / torch.tensor(math.sqrt(Dh), dtype=torch.float32,
                             device=q.device).to(q.dtype)

    backend = resolve_attn_backend(cfg, S, S, x.device)
    if backend == "flash":
        out = _flash_attention(cfg, q, k, v, is_local)
        return out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D), None
    qpos, kpos = positions[:, :, None], positions[:, None, :]
    mask = kpos <= qpos                                             # (B,S,T)
    if cfg.sliding_window is not None and is_local:
        mask = mask & (kpos > qpos - cfg.sliding_window)

    group = H // Hkv
    qg = q.reshape(B, S, Hkv, group, Dh)
    if backend == "chunked":
        out = _chunked_attention(cfg, qg, k, v, mask)
    else:
        logits = torch.einsum("bskgh,btkh->bkgst", qg, k)          # (B,Hkv,g,S,T)
        logits = softcap(logits, cfg.attn_logit_softcap)
        logits = torch.where(mask[:, None, None], logits.to(torch.float32),
                             torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    out = out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D)
    return out, None


def _chunked_attention(cfg, qg: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``cfg.attn_chunk``.

    qg: (B,S,Hkv,g,Dh); k/v: (B,T,Hkv,Dh); mask: (B,S,T) bool. Returns
    (B,S,Hkv,g,Dh) in v's dtype. A chunk whose mask row is all false keeps
    ``m`` at -1e30 and contributes p = 0 (the masked-row guard).
    """
    B, S, Hkv, g, Dh = qg.shape
    T = k_all.shape[1]
    C = cfg.attn_chunk
    if T % C:
        raise ValueError(f"sequence {T} is not a multiple of attn_chunk {C}")
    m = torch.full((B, Hkv, g, S), -1e30, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, Hkv, g, S), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Hkv, g, S, Dh), dtype=torch.float32, device=qg.device)
    neg = torch.tensor(-1e30, device=qg.device)
    for c0 in range(0, T, C):
        k_i, v_i, mask_i = k_all[:, c0:c0 + C], v_all[:, c0:c0 + C], mask[..., c0:c0 + C]
        s = torch.einsum("bskgh,btkh->bkgst", qg, k_i)
        s = softcap(s, cfg.attn_logit_softcap).to(torch.float32)
        s = torch.where(mask_i[:, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(m_new[..., None] > -0.5e30,
                        torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p.to(v_i.dtype), v_i).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v_all.dtype)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU per cfg.mlp_activation)."""
    act = _activation(cfg.mlp_activation)
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
