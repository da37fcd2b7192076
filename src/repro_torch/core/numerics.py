"""Shared numerical guards.

* The degenerate-pivot guard of the MaxVol family, used by the plain
  PyTorch MaxVol (``core/maxvol.py``) and mirrored in the CUDA kernel
  (``csrc/graft_select.cu``): the pivot tie-break under rank deficiency
  must be bit-identical across implementations or the pivots drift apart.
* JAX's fill mode for out-of-range indices (``take_rows``,
  ``take_last``, ``one_hot_valid``). ``jnp.take``, ``take_along_axis``
  and ``one_hot`` give a NaN row, a NaN entry and a zero row for an index
  they cannot read, where PyTorch's ``embedding``/``gather``/``scatter_add_``
  raise (on the card: a device-side assert that ends the CUDA context).
  A poisoned batch (``resilience.chaos``, ``BAD_TOKEN_ID``) relies on the
  fill. Each helper clamps the index and masks: no host read, nothing that
  can assert, and bit-equal results for indices in range.
"""
from __future__ import annotations

from typing import Tuple

import torch

# magnitude below which a pivot counts as a degenerate (eliminated) column
PIVOT_EPS = 1e-12


def safe_pivot(x: torch.Tensor) -> torch.Tensor:
    """Guard a pivot value away from exact zero, preserving its sign."""
    sign = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    return torch.where(x.abs() < PIVOT_EPS, sign * PIVOT_EPS, x)


def _wrapped(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index safe to read, validity): as ``jnp.take`` normalizes them, an
    index in [-n, 0) counts from the end; one outside [-n, n) is invalid and
    reads row 0 in its place."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ``embedding`` whose row for an
    invalid id is NaN and passes no gradient to ``table``."""
    safe, valid = _wrapped(ids, table.shape[0])
    rows = torch.nn.functional.embedding(safe, table)
    return rows.masked_fill(~valid[..., None], float("nan"))


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx[..., None], -1)[..., 0]``: the entry of
    an invalid index is NaN and passes no gradient to ``x``."""
    safe, valid = _wrapped(idx, x.shape[-1])
    out = torch.gather(x, -1, safe[..., None])[..., 0]
    return out.masked_fill(~valid, float("nan"))


def one_hot_valid(labels: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index safe to scatter at, validity) for ``jax.nn.one_hot(labels,
    n)``, which is a zero row for a label outside [0, n) — negative ones
    included, unlike ``take``."""
    idx = labels.long()
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid
