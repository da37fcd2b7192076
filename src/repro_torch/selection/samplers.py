"""Default sampler implementations behind the registry — the port of the JAX
package's ``selection/samplers.py``.

``graft`` is the paper's method (dynamic rank R* ≤ R_max); everything else
selects a fixed R_max-sample subset so fraction sweeps are apples-to-apples:

  * ``random``      — uniform R-of-K (needs ``inputs.key``, a generator)
  * ``loss_topk``   — highest per-sample score/loss (needs ``inputs.scores``)
  * ``full``        — first R_max samples (with R_max = K: no selection)
  * ``el2n``        — largest gradient-embedding norm (needs scores: the
                      probe forward that scales G)
  * ``gradmatch``   — OMP matching of the mean gradient, weights
                      re-normalized to sum 1 for training
  * ``craig``       — facility-location greedy, cluster-share weights
  * ``glister``     — one-step validation-gain greedy (ḡ as the val gradient)

All return a :class:`SelectionState` filled by ``finalize_state``, so the
telemetry (rank / proj_error / alignment) is comparable across strategies.
Importing this module registers them, and the streaming sampler with them.
"""
from __future__ import annotations

import torch

from repro_torch.core import baselines as baselines_lib
from repro_torch.selection.base import (GraftConfig, Sampler, SelectionInputs,
                                        SelectionState, finalize_state)
from repro_torch.selection.graft import graft_sampler_fn
from repro_torch.selection.registry import register


def _uniform_weights(r_max: int, device) -> torch.Tensor:
    return torch.full((r_max,), 1.0 / r_max, dtype=torch.float32, device=device)


def _finalize(cfg: GraftConfig, inputs: SelectionInputs, pivots, weights,
              step) -> SelectionState:
    return finalize_state(cfg, pivots, weights, cfg.r_max, inputs.G, inputs.g_bar, step)


def random_fn(cfg: GraftConfig, inputs: SelectionInputs,
              step: torch.Tensor) -> SelectionState:
    pivots, weights = baselines_lib.random_subset(inputs.key, inputs.V.shape[0],
                                                  cfg.r_max, inputs.V.device)
    return _finalize(cfg, inputs, pivots, weights, step)


def loss_topk_fn(cfg: GraftConfig, inputs: SelectionInputs,
                 step: torch.Tensor) -> SelectionState:
    pivots = torch.argsort(-inputs.scores, stable=True)[:cfg.r_max].to(torch.int32)
    return _finalize(cfg, inputs, pivots, _uniform_weights(cfg.r_max, pivots.device), step)


def full_fn(cfg: GraftConfig, inputs: SelectionInputs,
            step: torch.Tensor) -> SelectionState:
    pivots = torch.arange(cfg.r_max, dtype=torch.int32, device=inputs.V.device)
    return _finalize(cfg, inputs, pivots, _uniform_weights(cfg.r_max, pivots.device), step)


def el2n_fn(cfg: GraftConfig, inputs: SelectionInputs,
            step: torch.Tensor) -> SelectionState:
    pivots, weights = baselines_lib.el2n_topk(inputs.G, cfg.r_max)
    return _finalize(cfg, inputs, pivots, weights, step)


def gradmatch_fn(cfg: GraftConfig, inputs: SelectionInputs,
                 step: torch.Tensor) -> SelectionState:
    pivots, w = baselines_lib.gradmatch_omp(inputs.G, inputs.g_bar, cfg.r_max)
    total = torch.sum(w)
    weights = torch.where(total > 1e-12, w / torch.clamp(total, min=1e-12),
                          _uniform_weights(cfg.r_max, w.device))
    return _finalize(cfg, inputs, pivots, weights, step)


def craig_fn(cfg: GraftConfig, inputs: SelectionInputs,
             step: torch.Tensor) -> SelectionState:
    pivots, weights = baselines_lib.craig_greedy(inputs.G, cfg.r_max)
    return _finalize(cfg, inputs, pivots, weights, step)


def glister_fn(cfg: GraftConfig, inputs: SelectionInputs,
               step: torch.Tensor) -> SelectionState:
    pivots, weights = baselines_lib.glister_greedy(inputs.G, inputs.g_bar, cfg.r_max)
    return _finalize(cfg, inputs, pivots, weights, step)


GRAFT = register(Sampler("graft", graft_sampler_fn))
RANDOM = register(Sampler("random", random_fn, needs_key=True))
LOSS_TOPK = register(Sampler("loss_topk", loss_topk_fn, needs_scores=True))
FULL = register(Sampler("full", full_fn))
EL2N = register(Sampler("el2n", el2n_fn, needs_scores=True))
GRADMATCH = register(Sampler("gradmatch", gradmatch_fn))
CRAIG = register(Sampler("craig", craig_fn))
GLISTER = register(Sampler("glister", glister_fn))

# the streaming sketch sampler lives in its own module; importing it here
# keeps "import repro_torch.selection.samplers" enough to fill the registry
from repro_torch.selection import streaming as _streaming  # noqa: E402,F401
