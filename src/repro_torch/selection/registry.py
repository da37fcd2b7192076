"""Name → Sampler registry (the port has the ``graft`` sampler only)."""
from __future__ import annotations

from typing import Tuple, Union

from repro_torch.registry import Registry
from repro_torch.selection.base import Sampler
from repro_torch.selection.graft import graft_sampler_fn

_REGISTRY: Registry = Registry(
    "sampler", not_ported=("random", "loss_topk", "full", "el2n", "gradmatch",
                           "craig", "glister", "streaming_graft"))


def register(sampler: Sampler, *, overwrite: bool = False) -> Sampler:
    return _REGISTRY.register(sampler.name, sampler, overwrite=overwrite)


def get_sampler(name_or_sampler: Union[str, Sampler]) -> Sampler:
    if isinstance(name_or_sampler, Sampler):
        return name_or_sampler
    return _REGISTRY.get(name_or_sampler)


def available() -> Tuple[str, ...]:
    return _REGISTRY.available()


GRAFT = register(Sampler("graft", graft_sampler_fn))
