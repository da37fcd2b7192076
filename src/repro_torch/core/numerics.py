"""Shared numerical guards for the MaxVol family.

One definition of the degenerate-pivot guard, used by the plain PyTorch
MaxVol (``core/maxvol.py``) and mirrored in the CUDA kernel
(``csrc/graft_select.cu``): the pivot tie-break under rank deficiency must
be bit-identical across implementations or the pivots drift apart.
"""
from __future__ import annotations

import torch

# magnitude below which a pivot counts as a degenerate (eliminated) column
PIVOT_EPS = 1e-12


def safe_pivot(x: torch.Tensor) -> torch.Tensor:
    """Guard a pivot value away from exact zero, preserving its sign."""
    sign = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    return torch.where(x.abs() < PIVOT_EPS, sign * PIVOT_EPS, x)
