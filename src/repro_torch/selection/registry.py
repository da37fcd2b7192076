"""Name → Sampler registry.

A thin skin over the generic :class:`repro_torch.registry.Registry`: the
default samplers (``selection/samplers.py``, ``selection/streaming.py``)
register themselves on import and are loaded lazily on the first lookup,
as in the JAX package; external code adds strategies with :func:`register`.
"""
from __future__ import annotations

from typing import Tuple, Union

from repro_torch.registry import Registry
from repro_torch.selection.base import Sampler


def _load_defaults() -> None:
    from repro_torch.selection import samplers as _  # noqa: F401
    from repro_torch.selection import streaming as _s  # noqa: F401


_REGISTRY: Registry = Registry("sampler", ensure_defaults=_load_defaults)


def register(sampler: Sampler, *, overwrite: bool = False) -> Sampler:
    return _REGISTRY.register(sampler.name, sampler, overwrite=overwrite)


def get_sampler(name_or_sampler: Union[str, Sampler]) -> Sampler:
    if isinstance(name_or_sampler, Sampler):
        return name_or_sampler
    return _REGISTRY.get(name_or_sampler)


def available() -> Tuple[str, ...]:
    return _REGISTRY.available()
