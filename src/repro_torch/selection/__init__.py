"""Subset selection: the GRAFT sampler, its protocol and its input sources.

    from repro_torch.selection import GraftConfig, registry

    cfg = GraftConfig(rset=(4, 8, 16), use_pallas=True)
    state, carry = registry.get_sampler("graft").select(
        cfg, SelectionInputs(V, G, g_bar))

The engine paths (multi-batch, sharded), the overlap scheduler, the
streaming reservoir and the baseline samplers of the JAX package are still
to port (``ROADMAP.md``).
"""
from repro_torch.selection import registry, sources
from repro_torch.selection.base import (Carry, CarrySpec, GraftConfig, Sampler,
                                        SamplerConfig, SelectionInputs,
                                        SelectionState, init_state)
from repro_torch.selection.graft import GraftState, graft_select, pivot_and_sweep
from repro_torch.selection.registry import available, get_sampler, register

__all__ = [
    "GraftConfig", "SamplerConfig", "Sampler", "SelectionInputs",
    "SelectionState", "GraftState", "Carry", "CarrySpec", "init_state",
    "graft_select", "pivot_and_sweep", "available", "get_sampler", "register",
    "registry", "sources",
]
