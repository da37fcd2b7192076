"""The prefix projection-error sweep alone: the hand-written Hopper kernel
and its plain PyTorch version.

``projection_sweep(G, g_bar)`` is the port of the JAX package's
``projection_sweep_pallas`` (``repro/kernels/projection_sweep.py``): for
every prefix rank r of ``G (d, R)``, ``err[r-1] = clip(1 − ‖Q_rᵀ ĝ‖², 0,
1)`` with ``ĝ = ḡ/√(ḡ·ḡ + 1e-12)`` and ``Q`` built by two classical
Gram-Schmidt passes per column (a column whose residual norm is ≤ 1e-8 is
zeroed). Returns ``errors (R,) f32``.

* For CUDA tensors it launches ``projection_sweep_kernel`` of
  ``csrc/graft_select.cu`` (stage 3 of the fused refresh, one thread block
  looping over d in strides, the basis in a global scratch) and counts the
  launch in ``projection_sweep.launches``. It stages G's columns and ĝ into
  the basis first, as the fused kernel does, so its errors are bit-equal to
  the fused kernel's on the same gathered columns. A build or launch failure
  raises; nothing falls back to the plain version.
* For CPU tensors it runs ``core.projection.prefix_projection_errors``.

It refuses what the JAX kernel refuses: ``d·(2R+1)`` float32 words above
12 MB. The per-column reduction scratch sits in shared memory when it fits
one block, else in a global scratch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import projection as proj_lib
from repro_torch.kernels import build
from repro_torch.kernels import graft_select as gs

_WARPS = 8        # csrc/graft_select.cu kThreads / 32


def red_words(R: int) -> int:
    """The reduction scratch (two slots of per-warp partials and the
    coefficients), ``sweep_red_words`` in the CUDA source."""
    return (2 * _WARPS + 1) * R


def smem_bytes(R: int, global_red: bool) -> int:
    """Dynamic shared memory of the sweep block (``sweep_smem_words``): the
    reduction scratch unless ``global_red``, and G's staging tiles."""
    return 4 * ((0 if global_red else red_words(R)) + gs.tile_words(R))


def _check(G: torch.Tensor, g_bar: torch.Tensor) -> None:
    if G.ndim != 2:
        raise ValueError(f"expected G (d, R), got {tuple(G.shape)}")
    d, R = G.shape
    if g_bar.shape != (d,):
        raise ValueError(f"g_bar shape {tuple(g_bar.shape)} != ({d},)")
    if d * (2 * R + 1) * 4 > gs.VMEM_BUDGET_BYTES:
        raise ValueError("G exceeds the single-block VMEM budget; reduce d or R")


def projection_sweep(G: torch.Tensor, g_bar: torch.Tensor, *,
                     plan: Optional[str] = None) -> torch.Tensor:
    """Prefix projection errors (R,) of G (d, R) against g_bar (d,). CUDA
    tensors go to the kernel (float32, contiguous, else it raises); CPU
    tensors to the plain version. ``plan`` forces the reduction scratch into
    shared or global memory; leave it ``None``."""
    _check(G, g_bar)
    if not build.route("projection_sweep", G, g_bar):
        return proj_lib.prefix_projection_errors(G, g_bar)
    build.check_kernel_operands(G=G, g_bar=g_bar)
    d, R = G.shape
    dev = G.device
    fits = smem_bytes(R, False) <= gs.SMEM_LIMIT_BYTES
    if plan not in (None,) + gs.PLANS or (plan == "shared" and not fits):
        raise ValueError(f"plan {plan!r} is not one of {gs.PLANS} that R={R} fits")
    global_red = plan == "global" or not fits
    errors = torch.empty(R, dtype=torch.float32, device=dev)
    Qt = torch.empty(gs.basis_words(d, R), dtype=torch.float32, device=dev)   # Qᵀ and ĝ
    red = torch.empty(red_words(R), dtype=torch.float32, device=dev) if global_red else None
    gs.launch("projection_sweep", dev, (G, g_bar, errors, Qt, red),
              (d, R, int(global_red)))
    projection_sweep.launches += 1
    return errors


projection_sweep.launches = 0   # kernel launches, counted where they happen
