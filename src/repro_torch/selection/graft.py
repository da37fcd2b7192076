"""GRAFT selector — the paper's Algorithm 1 in PyTorch.

Pipeline per refresh step (every ``S`` iterations):
  1. features: V = f(batch) ∈ R^{K×R_max}, relevance-ordered columns
  2. Fast MaxVol: pivot order p (prefixes = candidate subsets for every rank)
  3. gradient matrix G[:, j] = grad-embedding of sample p_j; ḡ = batch mean
  4. prefix projection errors d_r; R* = smallest candidate rank with d ≤ ε
  5. emit (pivots, R*, weights) — weights mask pivots beyond R* so the
     train step keeps a static shape (R_max) while training on R* samples.
"""
from __future__ import annotations

import torch

from repro_torch.core import maxvol as maxvol_lib
from repro_torch.core import projection as proj_lib
from repro_torch.selection.base import GraftConfig, SelectionInputs, SelectionState

GraftState = SelectionState


def pivot_and_sweep(cfg: GraftConfig, V: torch.Tensor, G: torch.Tensor,
                    g_bar: torch.Tensor):
    """Stages 2-4 of the refresh: ``(pivots, prefix errors, G_sel)``.

    With ``cfg.use_pallas`` this is the hand-written kernel
    (``kernels/graft_select.py``: one launch on the card); otherwise the
    unfused chain ``fast_maxvol`` → ``index_select`` →
    ``prefix_projection_errors``, the JAX reference configuration.
    """
    if cfg.use_pallas:
        from repro_torch.kernels.graft_select import graft_select as fused
        pivots, errors, _, G_sel = fused(
            V.to(torch.float32).contiguous(), G.to(torch.float32).contiguous(),
            g_bar.to(torch.float32).contiguous(), cfg.r_max)
        return pivots, errors, G_sel
    pivots, _ = maxvol_lib.fast_maxvol(V, cfg.r_max)
    G_sel = G.index_select(1, pivots)                     # (d, R_max)
    errors = proj_lib.prefix_projection_errors(G_sel, g_bar)
    return pivots, errors, G_sel


def _finalize(cfg: GraftConfig, pivots: torch.Tensor, errors: torch.Tensor,
              G_sel: torch.Tensor, g_bar: torch.Tensor,
              step: torch.Tensor) -> SelectionState:
    """Rank decision + weights + diagnostics (device ops, no host sync)."""
    rank, err = proj_lib.select_rank(errors, cfg.rset, cfg.eps)
    active = (torch.arange(cfg.r_max, device=errors.device) < rank).to(torch.float32)
    weights = active / torch.clamp(active.sum(), min=1.0)
    g_sub = G_sel.to(torch.float32) @ weights             # subset mean gradient
    align = proj_lib.cosine_alignment(g_sub, g_bar)
    return SelectionState(pivots=pivots, weights=weights, rank=rank,
                          last_error=err, alignment=align, step=step)


def graft_select(cfg: GraftConfig, V: torch.Tensor, G: torch.Tensor,
                 g_bar: torch.Tensor, step: torch.Tensor) -> SelectionState:
    """One selection refresh. V: (K, R_max) features (relevance-ordered);
    G: (d, K) per-sample grad embeddings; ḡ: (d,). Returns new state."""
    pivots, errors, G_sel = pivot_and_sweep(cfg, V, G, g_bar)
    return _finalize(cfg, pivots, errors, G_sel, g_bar, step)


def stack_states(states) -> SelectionState:
    """Stack per-row states on a new leading axis (the JAX ``vmap`` output
    layout)."""
    return SelectionState(*(torch.stack(field) for field in zip(*states)))


def graft_select_batched(cfg: GraftConfig, V: torch.Tensor, G: torch.Tensor,
                         g_bar: torch.Tensor, step) -> SelectionState:
    """A whole microbatch stack of refreshes: V (B, K, R_max), G (B, d, K),
    ḡ (B, d). Semantically a loop of ``graft_select`` (the JAX ``vmap``);
    with ``cfg.use_pallas`` the stack runs as ONE launch of the batched
    kernel, then the epilogue per row (device ops, no host sync)."""
    step = torch.as_tensor(step, dtype=torch.int32, device=V.device)
    if cfg.use_pallas:
        from repro_torch.kernels.graft_select import graft_select_batched as fused
        pivots, errors, _, G_sel = fused(
            V.to(torch.float32).contiguous(), G.to(torch.float32).contiguous(),
            g_bar.to(torch.float32).contiguous(), cfg.r_max)
        return stack_states([_finalize(cfg, pivots[b], errors[b], G_sel[b],
                                       g_bar[b], step) for b in range(V.shape[0])])
    return stack_states([graft_select(cfg, V[b], G[b], g_bar[b], step)
                         for b in range(V.shape[0])])


def graft_sampler_fn(cfg: GraftConfig, inputs: SelectionInputs,
                     step: torch.Tensor) -> SelectionState:
    """Registry adapter: the ``Sampler.fn`` signature over ``graft_select``."""
    return graft_select(cfg, inputs.V, inputs.G, inputs.g_bar, step)


__all__ = ["GraftConfig", "GraftState", "SelectionState", "graft_select",
           "graft_select_batched", "graft_sampler_fn", "pivot_and_sweep"]
