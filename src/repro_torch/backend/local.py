"""The single-process backend — the loop without a backend, bit-identical.

Every primitive is the protocol's default: ``shard_batch`` copies each host
array to the run's device as the loop did, ``replicate`` and every
collective are the identity, and there is no process group to bring up.
"""
from __future__ import annotations

from repro_torch.backend import base


class LocalBackend(base.Backend):
    name = "local"


def _build(cfg: base.LocalBackendConfig) -> LocalBackend:
    return LocalBackend(cfg)


LOCAL = base.register_backend(base.BackendEntry("local", base.LocalBackendConfig, _build))
