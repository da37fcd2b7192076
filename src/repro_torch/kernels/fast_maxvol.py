"""Fast MaxVol alone: the hand-written Hopper kernel and its plain PyTorch
version.

``fast_maxvol(V, rank)`` is the port of the JAX package's
``fast_maxvol_pallas`` (``repro/kernels/fast_maxvol.py``): ``rank`` greedy
pivots over ``V (K, R)`` with the safe-pivot guard and the rank-1
elimination that keeps the pivot row, and ``logvol = Σ log|pivot|``.
Returns ``(pivots (rank,) int32, logvol () f32)``.

* For CUDA tensors it launches ``fast_maxvol_kernel`` of
  ``csrc/graft_select.cu`` (stage 1 of the fused refresh, one thread
  block) and counts the launch in ``fast_maxvol.launches``. V's working copy
  sits in shared memory when it fits one block, else in a global scratch
  (the plans of ``kernels/graft_select.py``, bit-equal). A build or launch
  failure raises; nothing falls back to the plain version.
* For CPU tensors it runs ``core.maxvol.fast_maxvol``.

It refuses what the JAX kernel refuses: ``rank > min(K, R)`` and a V of
more than 8 MB.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis import smem
from repro_torch.core import maxvol as maxvol_lib
from repro_torch.kernels import build
from repro_torch.kernels import graft_select as gs

V_LIMIT_BYTES = 8 * 1024 * 1024   # the JAX kernel's VMEM guard


def cost(K: int, R: int, rank: int) -> Tuple[int, int]:
    """(operations, bytes): MaxVol's operations; V read once, the pivots
    and logvol written once, 4-byte words."""
    return gs.maxvol_flops(K, R, rank), 4 * (K * R + rank + 1)


def _check(V: torch.Tensor, rank: int) -> None:
    if V.ndim != 2:
        raise ValueError(f"expected V (K, R), got {tuple(V.shape)}")
    K, R = V.shape
    if rank > min(K, R):
        raise ValueError(f"rank {rank} > min{tuple(V.shape)}")
    if rank < 1:
        raise ValueError(f"rank {rank} < 1")
    if K * R * 4 > V_LIMIT_BYTES:
        raise ValueError("feature matrix exceeds the VMEM budget; shrink K or R")


def fast_maxvol(V: torch.Tensor, rank: int, *, plan: Optional[str] = None):
    """``(pivots, logvol)`` of V (K, R). CUDA tensors go to the kernel
    (float32, contiguous, else it raises); CPU tensors to the plain version.
    ``plan`` forces the shared or global plan; leave it ``None``."""
    _check(V, rank)
    if not build.route("fast_maxvol", V):
        return maxvol_lib.fast_maxvol(V, rank)
    build.check_kernel_operands(V=V)
    K, R = V.shape
    plan = gs.resolve_plan(K, R, rank, plan)
    dev = V.device
    pivots = torch.empty(rank, dtype=torch.int32, device=dev)
    logvol = torch.empty(1, dtype=torch.float32, device=dev)
    work = torch.empty(smem.work_words(K, R), dtype=torch.float32, device=dev) \
        if plan == "global" else None
    if build.abstract("fast_maxvol", lambda: cost(K, R, rank), V):
        return pivots, logvol[0]
    gs.launch("fast_maxvol", dev, (V, pivots, logvol, work), (K, R, rank, int(plan == "global")))
    fast_maxvol.launches += 1
    return pivots, logvol[0]


def library_smem_bytes(K: int, R: int, rank: int, plan: str) -> int:
    """The C library's own sum for the MaxVol block under ``plan`` (-1 above
    227 KB); ``analysis/smem.py`` ``fast_maxvol_smem`` mirrors it."""
    return gs.launchers()["fast_maxvol_smem_bytes"](K, R, rank, int(plan == "global"))


fast_maxvol.launches = 0   # kernel launches, counted where they happen
