"""Streaming cross-batch selection: a SAGE-style gradient-sketch reservoir —
the port of the JAX package's ``selection/streaming.py``.

The carry (``SketchCarry``, fixed footprint, checkpointed with the train
state under ``sampler_carry/.sketch`` and its siblings) holds:

  * ``sketch`` — an (L, d) frequent-directions sketch of every gradient
    embedding matrix ``G`` the refreshes have seen (Liberty 2013): each
    update appends the new rows, keeps the top-L directions of the combined
    matrix and shrinks their energy by the (L+1)-th eigenvalue;
  * ``g_ema`` — the decayed stream mean gradient (bias-corrected at use);
  * ``count`` / ``agreement`` — refresh count and the last batch↔stream
    agreement, float32 scalars.

A refresh measures the agreement ``a = cos(ḡ, P_sketch ḡ)`` against the
sketch before this batch is absorbed, absorbs the batch, and runs the
UNMODIFIED ``graft.pivot_and_sweep`` (under ``use_pallas`` one launch of
the ``graft_select`` kernel) against ``g̃ = (1 − β)·ḡ + β·ĝ_stream`` with
``β = stream_mix · a``; the weights blend the uniform ones with a masked
softmax of the pivots' cosines to ``g̃`` by the same β. At β = 0 (the first
refresh: the sketch is empty) this is exactly plain GRAFT, bit for bit.

The arithmetic is the reference's with one deliberate deviation: the Gram
eigendecomposition of ``fd_update`` runs in float64 (rounded back to
float32; a ``wide_allowed`` site, which the step audit reports as info), because MKL's float32 ``syevd`` fails to converge on it when the
sketch still has many exact zero rows (56 of 72 at smoke size). A side
effect: the reference keeps rounding-noise rows (images of null-space
eigenvectors, norms ~1e-6 of the real rows) that pass
``sketch_projection``'s ``norm > 1e-8`` guard, so from its third refresh on
(while K·refreshes < L) its agreement follows its eigensolver's rounding;
the port's null-space rows stay below the guard (``ROADMAP.md``, C).

Memory: the carry is ``L·d + d + 2`` float32 values — 590 KB at L 64 and
minicpm-2b's d 2304.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.launch_audit import wide_allowed
from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.core import projection as proj_lib
from repro_torch.core.features import LINALG_SYNC, _finite
from repro_torch.core.numerics import device_scalar
from repro_torch.selection import graft as graft_lib
from repro_torch.selection.base import (CarrySpec, GraftConfig, Sampler,
                                        SelectionInputs, SelectionState)
from repro_torch.selection.registry import register

_EPS = 1e-12
_F = np.float32


class SketchCarry(NamedTuple):
    """The streaming sampler's cross-step state (all float32)."""
    sketch: torch.Tensor      # (L, d) frequent-directions sketch rows
    g_ema: torch.Tensor       # (d,) decayed stream mean gradient (uncorrected)
    count: torch.Tensor       # () reservoir updates absorbed so far
    agreement: torch.Tensor   # () last cos(ḡ, P_sketch ḡ) diagnostic


def init_sketch_carry(cfg: GraftConfig, spec: CarrySpec) -> SketchCarry:
    d, dev = int(spec.grad_dim), spec.device
    return SketchCarry(
        sketch=torch.zeros((cfg.sketch_rows, d), dtype=torch.float32, device=dev),
        g_ema=torch.zeros((d,), dtype=torch.float32, device=dev),
        count=torch.zeros((), dtype=torch.float32, device=dev),
        agreement=torch.zeros((), dtype=torch.float32, device=dev),
    )


def fd_update(cfg: GraftConfig, sketch: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """One frequent-directions round: absorb the rows of ``Gᵀ`` (K, d) into
    the decayed (L, d) sketch at fixed footprint, through the small
    (L+K, L+K) Gram eigendecomposition — never an SVD of a d-wide matrix.
    The eigendecomposition is taken in float64 (see the module docstring)."""
    L = cfg.sketch_rows
    stacked = torch.cat([float(_F(cfg.sketch_decay)) * sketch, G.to(torch.float32).T], 0)
    with wide_allowed("fd_update_eigh"), sync_allowed(LINALG_SYNC):
        evals, evecs = (x.to(torch.float32) for x in torch.linalg.eigh(
            _finite(stacked @ stacked.T).to(torch.float64)))         # ascending
    evals = torch.flip(evals, (0,))
    evecs = torch.flip(evecs, (1,))
    rows = evecs[:, :L].T @ stacked                      # σᵢ·vᵢᵀ, largest first
    # FD shrinkage: subtract the (L+1)-th eigenvalue from every kept energy
    delta = evals[L] if stacked.shape[0] > L else torch.zeros_like(evals[0])
    shrunk = torch.clamp(evals[:L] - delta, min=0.0)
    scale = torch.sqrt(shrunk / torch.clamp(evals[:L], min=_EPS))
    return rows * scale[:, None]


def sketch_projection(sketch: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Project ``g`` onto the span of the sketch rows (orthogonal by FD
    construction; rows at or below the 1e-8 norm guard contribute nothing)."""
    norms = torch.linalg.norm(sketch, dim=1, keepdim=True)           # (L, 1)
    unit = torch.where(norms > 1e-8, sketch / (norms + _EPS), torch.zeros_like(sketch))
    return unit.T @ (unit @ g.to(torch.float32))


def stream_agreement(sketch: torch.Tensor, g_bar: torch.Tensor) -> torch.Tensor:
    """cos(ḡ, P_sketch ḡ) ∈ [0, 1]; 0 for an empty sketch."""
    proj = sketch_projection(sketch, g_bar)
    return torch.clamp(proj_lib.cosine_alignment(proj, g_bar), 0.0, 1.0)


def streaming_select_fn(cfg: GraftConfig, inputs: SelectionInputs,
                        carry: SketchCarry, step: torch.Tensor):
    """The ``Sampler.select_fn`` body: one agreement-driven refresh. The
    agreement is measured against the sketch BEFORE this batch is absorbed
    (history vs now). The scalars are float32 as in the reference."""
    g_bar = inputs.g_bar.to(torch.float32)
    agreement = stream_agreement(carry.sketch, g_bar)

    decay = _F(cfg.sketch_decay)
    count = carry.count + 1.0
    g_ema = float(decay) * carry.g_ema + float(_F(1.0) - decay) * g_bar
    sketch = fd_update(cfg, carry.sketch, inputs.G)

    # bias-corrected stream mean: the EMA of n terms has total weight 1 − decayⁿ
    decay_t = device_scalar(float(decay), torch.float32, count.device)
    corr = torch.clamp(1.0 - torch.pow(decay_t, count), min=_EPS)
    g_stream = g_ema / corr

    beta = float(_F(cfg.stream_mix)) * agreement
    g_tilde = (1.0 - beta) * g_bar + beta * g_stream

    pivots, errors, G_sel = graft_lib.pivot_and_sweep(cfg, inputs.V, inputs.G, g_tilde)

    # GRAFT's rank decision on the blended target, then the β-blend of the
    # uniform weights with a masked softmax of the pivots' cosines to g̃
    rank, err = proj_lib.select_rank(errors, cfg.rset, cfg.eps)
    active = (torch.arange(cfg.r_max, device=errors.device) < rank).to(torch.float32)
    uniform = active / torch.clamp(active.sum(), min=1.0)
    G_sel = G_sel.to(torch.float32)
    col_norms = torch.linalg.norm(G_sel, dim=0)
    cos = (G_sel.T @ g_tilde) / torch.clamp(col_norms * torch.linalg.norm(g_tilde), min=_EPS)
    soft = torch.softmax(torch.where(active > 0.0, cos, -torch.inf), dim=0)
    weights = (1.0 - beta) * uniform + beta * soft
    state = SelectionState(
        pivots=pivots, weights=weights, rank=rank, last_error=err,
        alignment=proj_lib.cosine_alignment(G_sel @ weights, g_tilde), step=step)
    return state, SketchCarry(sketch=sketch, g_ema=g_ema, count=count, agreement=agreement)


STREAMING_GRAFT = register(Sampler(
    "streaming_graft", select_fn=streaming_select_fn, init_carry_fn=init_sketch_carry))

__all__ = ["SketchCarry", "init_sketch_carry", "fd_update", "sketch_projection",
           "stream_agreement", "streaming_select_fn", "STREAMING_GRAFT"]
