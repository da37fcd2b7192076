"""Subset selection: the samplers (GRAFT, the baselines the paper compares
against, the streaming sketch reservoir), their protocol, their input
sources and the single- and multi-batch engines.

    from repro_torch.selection import GraftConfig, engine

    cfg = GraftConfig(rset=(4, 8, 16), use_pallas=True)
    state, carry = engine.select_batch(cfg, "graft", V, G, g_bar)       # one batch
    states, cs = engine.select_multi_batch(cfg, "graft", Vs, Gs, gbs)   # a stack

Under ``use_pallas`` the multi-batch GRAFT path is one launch of the batched
kernel, and ``graft`` and ``streaming_graft`` refresh through the
``graft_select`` kernel. ``registry.available()`` lists the samplers,
``sources.available_features()`` / ``sources.available_grad_sources()`` the
input paths. The sharded engine of the JAX package is still to port
(``ROADMAP.md``).
"""
from repro_torch.selection import samplers as _samplers  # noqa: F401 (registers defaults)
from repro_torch.selection import engine, registry, sources, streaming
from repro_torch.selection.base import (Carry, CarrySpec, GraftConfig, Sampler,
                                        SamplerConfig, SelectionInputs,
                                        SelectionState, init_state)
from repro_torch.selection.engine import select_batch, select_multi_batch
from repro_torch.selection.graft import (GraftState, graft_select,
                                         graft_select_batched, pivot_and_sweep)
from repro_torch.selection.registry import available, get_sampler, register

__all__ = [
    "GraftConfig", "SamplerConfig", "Sampler", "SelectionInputs",
    "SelectionState", "GraftState", "Carry", "CarrySpec", "init_state",
    "graft_select", "graft_select_batched", "pivot_and_sweep",
    "select_batch", "select_multi_batch", "available", "get_sampler",
    "register", "engine", "registry", "sources", "streaming",
]
