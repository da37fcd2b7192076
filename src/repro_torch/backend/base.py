"""Pluggable execution backends — how a ``Trainer`` touches processes and
devices. The twin of the JAX package's ``backend/base.py``.

A :class:`Backend` owns every process and device decision of the training
loop: the process group's bring-up, which device a rank runs on, host →
device batch staging, cross-process reductions, the data pipeline's host
shard, and the topology stamp that makes checkpoints elastically
restorable. The ``Trainer`` asks the backend and never calls
``torch.distributed`` itself (lint rule LN004 confines it to ``backend/``).

Two implementations ship:

  * :class:`~repro_torch.backend.local.LocalBackend` — one process, one
    device; every collective is the identity, so the loop is bit-identical
    to the loop without a backend;
  * :class:`~repro_torch.backend.multiprocess.MultiProcessBackend` — one
    process per rank joined by ``torch.distributed`` (NCCL when every rank
    has a card of its own, gloo on the CPU or when ranks share a card),
    per-rank ``DataSource`` shards, replicated train state.

``mesh()`` is the backend's ``("data",)`` mesh over every rank
(``backend/mesh.py``: named axes and the ``jax.lax`` collectives over
them, for the sharded selection engine and the pipeline executor).
Eager PyTorch has no global array for a compiler to reduce over, so the
port adds primitives the JAX protocol does not need: ``device()``,
``all_gather_rows`` (the global batch's rows, in rank order),
``reduce_tensors`` (one collective per dtype group) and ``reduce_grads``
(the step's, timed), plus ``broadcast_int`` (rank 0's choice, e.g. the
checkpoint step every rank restores).

The registry mirrors ``data/sources.py``: each backend pairs a frozen
config dataclass (the tagged, hash-neutral ``backend`` section of an
``ExperimentConfig``) with a builder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.registry import Registry


class AllReduceSpec(NamedTuple):
    """How cross-process reductions run on this backend: the axis they
    travel over, the number of shards and whether the int8 error-feedback
    compression (``distributed/compression.py``) wraps them."""
    axis: str
    num_shards: int
    compressed: bool


# ---------------------------------------------------------------------------
# configs (the tagged ``backend`` section)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalBackendConfig:
    """Single-process execution on one device (the default)."""


@dataclasses.dataclass(frozen=True)
class MultiProcessBackendConfig:
    """One process per rank, joined by ``torch.distributed``.

    ``num_processes``/``process_id`` of 0/-1 mean "read ``WORLD_SIZE`` /
    ``RANK``", the variables ``torchrun`` sets, so that one config serves
    every rank. ``coordinator`` is the TCP rendezvous address.
    """
    coordinator: str = "127.0.0.1:12321"
    num_processes: int = 0              # 0 = $WORLD_SIZE
    process_id: int = -1                # -1 = $RANK
    compress_reduce: bool = False       # int8 error-feedback on all_reduce
    prefetch: int = 0                   # BatchStager lookahead depth


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA device, or an error when there is none: an entry
    point never falls back to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch trains on the GPU; pass "
                "device='cpu' (or --device=cpu) to run on the CPU on purpose")
        return torch.device("cuda")
    return torch.device(device)


def state_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a train state (dicts, lists, tuples), each once, in
    a fixed order — the ``model`` entry is skipped: its parameters are the
    ``params`` list's."""
    out: List[torch.Tensor] = []
    seen = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                if k != "model":
                    walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def flatten_tree(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves of nested dicts/lists/tuples and a function rebuilding the
    tree from new leaves (the host-side ``all_reduce``'s tree map)."""
    leaves: List[Any] = []

    def build(x):
        if isinstance(x, dict):
            subs = {k: build(v) for k, v in x.items()}
            return lambda it: {k: f(it) for k, f in subs.items()}
        if isinstance(x, (list, tuple)):
            subs = [build(v) for v in x]
            kind = type(x)
            return lambda it: kind(f(it) for f in subs)
        leaves.append(x)
        return lambda it: next(it)

    rebuild = build(tree)
    return leaves, lambda new: rebuild(iter(new))


class Backend:
    """Execution-strategy protocol. Everything here is the single-process
    default, so that a backend only implements what it changes."""

    name: str = "abstract"

    def __init__(self, config: Any):
        self.config = config
        self._device: Optional[torch.device] = None
        self._mesh = None

    # -------------------------------- lifecycle -----------------------------
    def setup(self) -> None:
        """Bring up the process group (before the run builds anything)."""

    def teardown(self) -> None:
        """Release the process group (idempotent)."""

    # -------------------------------- topology ------------------------------
    @property
    def process_index(self) -> int:
        return 0

    @property
    def process_count(self) -> int:
        return 1

    def device_count(self) -> int:
        """Devices of the run: one a rank."""
        return self.process_count

    @property
    def is_primary(self) -> bool:
        """The one process that writes checkpoints, telemetry and console
        lines."""
        return self.process_index == 0

    def data_shard(self) -> Tuple[int, int]:
        """``(num_hosts, host_index)`` for the data pipeline: which slice of
        every global batch this process generates."""
        return self.process_count, self.process_index

    def topology(self) -> Dict[str, Any]:
        """The manifest stamp that makes checkpoints elastic: enough to
        detect a mismatched restore and to decide a reshard is safe."""
        return {"process_count": self.process_count,
                "device_count": self.device_count(),
                "shard_layout": "replicated"}

    def mesh(self):
        """The backend's mesh: one ``("data",)`` axis over every rank, as
        the JAX package's multiprocess backend lays it out (built once, after
        ``setup``: on several ranks it makes process groups)."""
        if self._mesh is None:
            from repro_torch.backend.mesh import Mesh
            self._mesh = Mesh((self.process_count,), ("data",), self)
        return self._mesh

    # -------------------------------- devices -------------------------------
    def device(self, explicit=None) -> torch.device:
        """This rank's device: ``explicit`` when given, else the backend's
        card (an error without one). Remembered for ``shard_batch``."""
        self._device = resolve_device(explicit)
        return self._device

    def shard_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's host batch → tensors on its device."""
        return {k: torch.from_numpy(v).to(self._device, non_blocking=True)
                for k, v in batch.items()}

    def replicate(self, state):
        """A freshly initialised train state → the same state on every rank
        (the identity for one process)."""
        return state

    def to_host(self, state) -> Dict[str, torch.Tensor]:
        """The checkpoint's host copy of the train state: a local copy, as
        the state is replicated on every rank."""
        from repro_torch.checkpoint import train_state_to_host
        return train_state_to_host(state)

    # ------------------------------ collectives -----------------------------
    def all_reduce_spec(self) -> AllReduceSpec:
        return AllReduceSpec(axis="data", num_shards=self.process_count, compressed=False)

    def all_reduce(self, tree):
        """Cross-process mean of host-side values (metrics, rank statistics);
        the identity for one process."""
        return tree

    def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated along dim 0 in rank order."""
        return tensor

    def reduce_tensors(self, tensors: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """The sum (``op="sum"``) or mean (``"mean"``) over ranks of each
        device tensor, one collective per dtype group."""
        return list(tensors)

    def reduce_grads(self, grads: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """``reduce_tensors`` of a step's loss and gradients (a backend may
        time it)."""
        return self.reduce_tensors(grads, op)

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        return value

    def check_consistent(self, tag: str) -> None:
        """Fail loudly when the processes disagree on ``tag`` (a config-hash
        divergence now is silent corruption later)."""

    # -------------------------------- staging -------------------------------
    @property
    def staging_depth(self) -> int:
        """BatchStager lookahead (0 = stage inline, bit-identical order)."""
        return 0


def data_parallel(backend: Optional[Backend]) -> Optional[Backend]:
    """``backend`` where it adds collectives to a step, else None: the local
    backend (one process) adds none, so its step is the step without one."""
    return None if backend is None or backend.name == "local" else backend


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendEntry:
    name: str
    config_cls: type
    build: Callable[[Any], Backend]


_BACKENDS: Registry = Registry("execution backend")


def register_backend(entry: BackendEntry, *, overwrite: bool = False) -> BackendEntry:
    for other in _BACKENDS.values():
        if other.name != entry.name and other.config_cls is entry.config_cls:
            raise ValueError(
                f"config class {entry.config_cls.__name__} already tags "
                f"backend '{other.name}' — one config class per backend")
    return _BACKENDS.register(entry.name, entry, overwrite=overwrite)


def get_backend(name: str) -> BackendEntry:
    return _BACKENDS.get(name)


def available_backends() -> Tuple[str, ...]:
    return _BACKENDS.available()


def entry_for_config(bcfg: Any) -> BackendEntry:
    for entry in _BACKENDS.values():
        if type(bcfg) is entry.config_cls:
            return entry
    raise KeyError(f"no registered backend owns config type "
                   f"{type(bcfg).__name__} (available: {available_backends()})")


def backend_name_of(bcfg: Any) -> str:
    return entry_for_config(bcfg).name


def resolve(bcfg: Optional[Any]) -> Backend:
    """Backend-config section → live ``Backend`` (``None`` = local)."""
    if bcfg is None:
        bcfg = LocalBackendConfig()
    if isinstance(bcfg, Backend):       # a pre-built backend passes through
        return bcfg
    return entry_for_config(bcfg).build(bcfg)
