"""Fast MaxVol (the paper's sampler) as plain PyTorch ops.

Operates on a feature matrix ``V ∈ R^{K×R}`` whose columns are ordered by
decreasing relevance (see ``repro_torch.core.features``). Step ``j`` picks
``p_j = argmax_i |r_j(i)|`` where ``r_j`` is column ``j`` of the residual
matrix after eliminating the previously selected pivot rows — a rank-1
update per step, ``O(K·R²)`` in all.

Rounding decides pivots once the requested rank exceeds the true rank of
``V``: the residual columns are then rounding noise and the argmax picks
among it. The JAX reference, as XLA compiles it for the CPU, contracts the
elimination ``W - factor * pivot_row`` into a fused multiply-add (one
rounding). So does this module, and so does the CUDA kernel
(``csrc/graft_select.cu``, ``__fmaf_rn``): here the product of two float32
values is formed exactly in float64 and the difference rounds to float32.
That equals a fused multiply-add except when the exact difference needs
more than 53 bits AND lies within 2^-53 of a float32 rounding midpoint —
float64 then rounds twice. The factor is an IEEE division in all three.
The float64 product is a deliberate wide site (``wide_allowed``), which the
step audit reports as info.
``torch.argmax`` takes the first index on ties, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.analysis.launch_audit import wide_allowed
from repro_torch.core.numerics import device_scalar, safe_pivot


def fast_maxvol(V: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select ``rank`` rows of ``V`` (K×R) greedily maximizing submatrix volume.

    Returns ``(pivots, logvol)``: int32 row indices in selection order
    (prefixes are the Fast MaxVol solutions for smaller ranks) and
    ``log |det V[pivots, :rank]|`` accumulated from the pivot magnitudes.
    Runs on ``V``'s device without a host sync: the pivot indexes with
    tensor ops (a 0-d index tensor would be read to the host), so the loop
    also traces on fake tensors.
    """
    K, R = V.shape
    if rank > min(K, R):
        raise ValueError(f"rank {rank} exceeds feature matrix dims {tuple(V.shape)}")
    W = V.to(torch.float32).clone()
    avail = torch.ones(K, dtype=torch.bool, device=V.device)
    pivots = torch.zeros(rank, dtype=torch.int32, device=V.device)
    logvol = torch.zeros((), dtype=torch.float32, device=V.device)
    minus_one = device_scalar(-1.0, torch.float32, V.device)
    for j in range(rank):
        col = W[:, j]
        # residual column scores; already-selected rows can never win
        scores = torch.where(avail, col.abs(), minus_one)
        pj = torch.argmax(scores).view(1)
        pivot_row = W.index_select(0, pj)              # (1, R), a copy
        pivot_val = safe_pivot(pivot_row[0, j])
        factor = col / pivot_val                       # (K,)
        # W - factor ⊗ pivot_row with one rounding (see the module docstring)
        with wide_allowed("maxvol_exact_product"):
            W = (W.double() - factor.double()[:, None] * pivot_row.double()
                 ).to(torch.float32)
        W.index_copy_(0, pj, pivot_row)                # keep the pivot row intact
        avail.index_fill_(0, pj, False)
        pivots[j] = pj[0].to(torch.int32)
        logvol = logvol + torch.log(pivot_val.abs())
    return pivots, logvol
