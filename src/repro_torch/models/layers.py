"""Transformer building blocks: RMSNorm, RoPE, GQA attention (sliding
window, logit softcap, QKV bias), gated MLP.

Functional like the JAX package: every block is ``f(cfg, params, x, ...)``
with ``params`` a dict of tensors, in the JAX layouts (``wq`` (D,H,Dh),
``wk``/``wv`` (D,Hkv,Dh), ``wo`` (H,Dh,D)), so weights cross between the
packages without transposes.

Attention runs the dense or the KV-chunked path as plain tensor ops, which
is what the JAX package leaves to XLA outside the flash kernel. The flash
backend (a hand-written kernel) is the port's next slice: ``flash`` raises,
and ``auto`` resolves to the dense/chunked path for now. The KV-cache
(decode) branch and the MoE layer are not ported (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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

def resolve_attn_backend(cfg, S: int, T: int) -> str:
    """Training backend for this shape → chunked | dense.

    ``flash`` is the hand-written kernel of the port's next slice and raises
    until then; ``auto`` takes the dense/chunked path (on the TPU the JAX
    package picks flash for it).
    """
    b = getattr(cfg, "attn_backend", "auto")
    chunked = "chunked" if cfg.attn_chunk and T > cfg.attn_chunk else "dense"
    if b == "dense":
        return "dense"
    if b in ("chunked", "auto"):
        return chunked
    if b == "flash":
        raise NotImplementedError(
            "attn_backend='flash' needs the flash-attention kernels, which are "
            "the port's next slice (see ROADMAP.md); use 'dense' or 'chunked'")
    raise ValueError(f"unknown attn_backend: {b!r}")


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

    backend = resolve_attn_backend(cfg, S, S)
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
