"""Compatibility re-export — the GRAFT selector lives in
``repro_torch.selection``, as the JAX package's ``core/graft.py`` points to
``repro.selection``.

``selection/graft.py`` holds the algorithm and ``selection/engine.py`` the
multi-batch and sharded data-parallel paths. Existing imports keep working;
new code should import from ``repro_torch.selection``.
"""
from repro_torch.selection.base import GraftConfig, SelectionState, init_state
from repro_torch.selection.graft import (GraftState, graft_select,  # noqa: F401
                                         graft_select_batched, maybe_refresh,
                                         pivot_and_sweep, select_from_batch)

__all__ = ["GraftConfig", "GraftState", "SelectionState", "init_state",
           "graft_select", "maybe_refresh", "select_from_batch"]
