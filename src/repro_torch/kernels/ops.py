"""Public wrappers over the port's kernels — the twin of the JAX package's
``repro/kernels/ops.py``, with the same names, signatures and returns.

Each takes the JAX function's layouts, casts to float32 (as the JAX
wrappers do) and goes to the hand-written kernel for CUDA tensors, to the
kernel's plain PyTorch version for CPU tensors (``kernels/*.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fast_maxvol as _fm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import graft_select as _gs
from repro_torch.kernels import projection_sweep as _ps
from repro_torch.kernels import rwkv_scan as _rw


def _f32(*tensors):
    return [t.to(torch.float32).contiguous() for t in tensors]


def fast_maxvol(V: torch.Tensor, rank: int) -> torch.Tensor:
    """Pivot indices (rank,) — Fast MaxVol."""
    pivots, _ = _fm.fast_maxvol(*_f32(V), rank)
    return pivots


def fast_maxvol_with_logvol(V: torch.Tensor, rank: int):
    """``(pivots (rank,), logvol ())``."""
    return _fm.fast_maxvol(*_f32(V), rank)


def projection_sweep(G: torch.Tensor, g_bar: torch.Tensor) -> torch.Tensor:
    """Prefix projection errors (R,) — the two-pass Gram-Schmidt sweep."""
    return _ps.projection_sweep(*_f32(G, g_bar))


def fused_graft_select(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
                       rank: int):
    """One GRAFT refresh (MaxVol + gather + sweep) in ONE launch. Returns
    ``(pivots (rank,), errors (rank,), G_sel (d, rank))``."""
    pivots, errors, _, gsel = _gs.graft_select(*_f32(V, G, g_bar), rank)
    return pivots, errors, gsel


def fused_graft_select_batched(V: torch.Tensor, G: torch.Tensor,
                               g_bar: torch.Tensor, rank: int):
    """A microbatch stack of refreshes in ONE launch. Returns ``(pivots (B,
    rank), errors (B, rank), G_sel (B, d, rank))``."""
    pivots, errors, _, gsel = _gs.graft_select_batched(*_f32(V, G, g_bar), rank)
    return pivots, errors, gsel


def rwkv_scan(r, k, v, w, u, chunk: int = 32):
    """The RWKV6 recurrence over r/k/v/w (BH, T, D) and u (BH, D) → (BH, T,
    D) float32, differentiable. ``T`` must be divisible by ``chunk``, as in
    the JAX function; the Hopper kernels choose their own time tiles, so
    ``chunk`` does not change the result."""
    T = r.shape[1]
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    return _rw.rwkv_scan(*_f32(r, k, v, w, u))


def flash_attention(q, k, v, causal: bool = True, window=None, softcap=None,
                    block_q: int = 128, block_k: int = 128, group: int = 1,
                    scale=None):
    """Flash attention over q (B·H, S, Dh), k/v (B·Hkv, T, Dh) —
    differentiable, GQA via ``group``. The Hopper kernels choose their own
    tiles; ``block_q``/``block_k`` are held to the JAX function's rule that
    they divide the sequence lengths."""
    Sq, T = q.shape[1], k.shape[1]
    if Sq % block_q or T % block_k:
        raise ValueError(f"Sq={Sq} % {block_q} or T={T} % {block_k} != 0")
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, group=group, scale=scale)
