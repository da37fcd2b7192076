"""One whole GRAFT selection refresh: the hand-written Hopper kernel and its
plain PyTorch twin.

``graft_select(V, G, g_bar, rank)`` is the port of the JAX package's
``fused_graft_select_pallas`` (``repro/kernels/graft_select.py``): Fast
MaxVol pivots over ``V (K, R)``, the exact gather ``G_sel = G[:, pivots]``
and the CGS2 prefix projection errors of ``G_sel`` against ``ĝ``, plus the
log-volume. Returns ``(pivots (rank,) int32, errors (rank,) f32, logvol ()
f32, G_sel (d, rank) f32)``.

* For CUDA tensors it launches ``csrc/graft_select.cu`` (one thread block,
  one launch) and counts the launch in ``graft_select.launches``. A build or
  launch failure raises; nothing falls back to the twin.
* For CPU tensors it runs ``graft_select_reference``, the same function as
  plain torch ops built from ``core.maxvol`` and ``core.projection``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import maxvol as maxvol_lib
from repro_torch.core import projection as proj_lib

# what one Hopper thread block can address as shared memory (227 KB)
SMEM_LIMIT_BYTES = 232_448
_WARPS = 8        # csrc/graft_select.cu kThreads / 32


def smem_bytes(K: int, R: int, rank: int) -> int:
    """Dynamic shared memory of one refresh block — the same sum as
    ``smem_words`` in ``csrc/graft_select.cu``: V's working copy (K·R
    floats) dominates; the rest is per-row / per-column scratch."""
    return 4 * (K * R + 2 * K + R + (_WARPS + 2) * rank + 2 * _WARPS + 2)


def graft_select_reference(V: torch.Tensor, G: torch.Tensor,
                           g_bar: torch.Tensor, rank: int):
    """The plain twin: the fused function as torch ops on any device."""
    pivots, logvol = maxvol_lib.fast_maxvol(V, rank)
    G_sel = G.to(torch.float32).index_select(1, pivots)
    errors = proj_lib.prefix_projection_errors(G_sel, g_bar)
    return pivots, errors, logvol, G_sel


def _check(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
           rank: int) -> Tuple[int, int, int]:
    if V.ndim != 2 or G.ndim != 2 or g_bar.ndim != 1:
        raise ValueError(f"expected V (K,R), G (d,K), g_bar (d,); got "
                         f"{tuple(V.shape)}, {tuple(G.shape)}, {tuple(g_bar.shape)}")
    K, R = V.shape
    d, Kg = G.shape
    if Kg != K:
        raise ValueError(f"V rows {K} != G columns {Kg}")
    if g_bar.shape != (d,):
        raise ValueError(f"g_bar shape {tuple(g_bar.shape)} != ({d},)")
    if not 1 <= rank <= min(K, R):
        raise ValueError(f"rank {rank} not in [1, min{tuple(V.shape)}]")
    return K, R, d


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/graft_select.cu``, built at first use,
    with its signature declared: every pointer and the stream as
    ``c_void_p`` (a plain int would cut them to 32 bits)."""
    from repro_torch.kernels import build
    fn = build.load("graft_select").lib.graft_select_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(V, G, g_bar, rank: int, K: int, R: int, d: int):
    for name, t in (("V", V), ("G", G), ("g_bar", g_bar)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != V.device:
            raise ValueError(f"{name} on {t.device}, V on {V.device}")
    smem = smem_bytes(K, R, rank)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"graft_select keeps V (K={K}, R={R}: {K * R * 4} bytes) in shared "
            f"memory and needs {smem} bytes, above the {SMEM_LIMIT_BYTES} bytes "
            "(227 KB) one Hopper thread block can use; shrink K or R")
    fn = _launcher()
    dev = V.device
    pivots = torch.empty(rank, dtype=torch.int32, device=dev)
    errors = torch.empty(rank, dtype=torch.float32, device=dev)
    logvol = torch.empty(1, dtype=torch.float32, device=dev)
    G_sel = torch.empty((d, rank), dtype=torch.float32, device=dev)
    Qt = torch.empty((rank, d), dtype=torch.float32, device=dev)  # Qᵀ scratch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(V.data_ptr(), G.data_ptr(), g_bar.data_ptr(),
                 pivots.data_ptr(), errors.data_ptr(), logvol.data_ptr(),
                 G_sel.data_ptr(), Qt.data_ptr(), 1, K, R, d, rank, smem, stream)
    if err != 0:
        raise RuntimeError(f"graft_select kernel launch failed: cudaError {err}")
    graft_select.launches += 1
    return pivots, errors, logvol[0], G_sel


def graft_select(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
                 rank: int):
    """One refresh. V: (K, R); G: (d, K); g_bar: (d,). Returns
    ``(pivots, errors, logvol, G_sel)``. CUDA tensors go to the kernel
    (float32, contiguous, else it raises); CPU tensors to the twin."""
    K, R, d = _check(V, G, g_bar, rank)
    if V.device.type == "cpu" and G.device.type == "cpu" and g_bar.device.type == "cpu":
        return graft_select_reference(V, G, g_bar, rank)
    if V.device.type != "cuda":
        raise ValueError(f"graft_select runs on CUDA or CPU tensors, got {V.device}")
    return _launch(V, G, g_bar, rank, K, R, d)


graft_select.launches = 0   # kernel launches, counted where they happen
