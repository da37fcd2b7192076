"""Pluggable execution backends (see ``repro_torch.backend.base``).

Importing this package registers both shipped backends; ``resolve`` turns
the tagged ``backend`` config section into a live :class:`Backend`.
:class:`Mesh` (``make_mesh``, ``Backend.mesh()``) lays a backend's ranks out
on named axes with the collectives over them.
"""
from repro_torch.backend.base import (
    AllReduceSpec,
    Backend,
    BackendEntry,
    LocalBackendConfig,
    MultiProcessBackendConfig,
    available_backends,
    backend_name_of,
    data_parallel,
    entry_for_config,
    get_backend,
    register_backend,
    resolve,
    resolve_device,
)
from repro_torch.backend.local import LocalBackend
from repro_torch.backend.mesh import Mesh, make_mesh
from repro_torch.backend.multiprocess import MultiProcessBackend

__all__ = [
    "AllReduceSpec",
    "Backend",
    "BackendEntry",
    "LocalBackend",
    "LocalBackendConfig",
    "Mesh",
    "MultiProcessBackend",
    "MultiProcessBackendConfig",
    "available_backends",
    "backend_name_of",
    "entry_for_config",
    "get_backend",
    "make_mesh",
    "register_backend",
    "data_parallel",
    "resolve",
    "resolve_device",
]
