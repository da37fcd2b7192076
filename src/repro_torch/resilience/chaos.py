"""Deterministic fault injection for the training stack — the port of the
JAX package's ``resilience/chaos.py``, with its plan format, its fault
kinds and its once-only firing.

A :class:`FaultPlan` is a list of fault dicts, supplied as inline JSON
(``train.fault_plan='[{"kind": "nan_batch", "step": 12}]'``), as a path to
a JSON file (optionally ``@``-prefixed), or through the ``REPRO_FAULT_PLAN``
environment variable. Every fault is keyed on host-visible state (the
trainer's step counter, a named crash point) and fires **exactly once** — so
a run that rolls back and replays the same step range is NOT re-poisoned,
and the whole schedule replays bit-exactly across runs with the same plan.

Fault kinds:

``nan_batch``  — ``{"kind": "nan_batch", "step": k}``: poison the host
    batch dispatched at step ``k``. Float leaves become NaN; integer leaves
    become out-of-range ids, which the model reads in JAX's fill mode
    (``core/numerics.py``: a NaN embedding row, a NaN log-probability), so
    even the int-only ``synthetic_lm`` workload gives a NaN loss/gradient.
``sigterm``    — ``{"kind": "sigterm", "step": k}``: deliver SIGTERM to this
    process right before step ``k`` is dispatched (preemption drill).
``crash``      — ``{"kind": "crash", "point": "checkpoint.mid_commit"}``:
    raise :class:`ChaosCrash` at a named :func:`crash_point` (the checkpoint
    writer declares ``pre_commit`` / ``mid_commit`` / ``post_commit``),
    simulating the process dying at exactly that filesystem state.
    ``"skip": N`` lets the first N hits of the point pass (crash the N+1-th
    save); ``"mode": "exit"`` hard-kills via ``os._exit(17)`` instead, for
    subprocess-based tests.
``stall``      — ``{"kind": "stall", "step": k, "seconds": s}``: step ``k``'s
    DeviceClock event reads as incomplete for ``s`` seconds after it was
    recorded (:class:`StallMarker`), exercising the watchdog
    (``train.device_timeout_s``). Without a DeviceClock (the CPU, or
    ``train.device_timing=false``) it never fires, as in the JAX package.
``bit_flip``   — ``{"kind": "bit_flip", "leaf": substr}``: offline fault —
    the chaos CLI / tests apply it with :func:`flip_checkpoint_leaf` between
    runs; the trainer itself ignores it.
"""
from __future__ import annotations

import json
import os
import signal
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np

ENV_VAR = "REPRO_FAULT_PLAN"
KINDS = ("nan_batch", "sigterm", "crash", "stall", "bit_flip")

# out-of-range token id used to poison integer batches: far beyond any
# vocab, so the embedding's fill mode yields NaN rows
BAD_TOKEN_ID = 2 ** 30


class ChaosCrash(RuntimeError):
    """Injected crash — simulates the process dying at a crash point."""


class FaultPlan:
    """An ordered list of faults, each of which fires at most once."""

    def __init__(self, faults: List[Dict[str, Any]]):
        for f in faults:
            kind = f.get("kind")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r} (expected one of {KINDS})")
        self.faults = list(faults)
        self.fired: set = set()
        self._hits: Dict[int, int] = {}   # crash-point pass-throughs seen

    # ------------------------------ parsing ------------------------------
    @classmethod
    def from_spec(cls, spec) -> "FaultPlan":
        """Build from inline JSON text, an already-parsed list/dict, or a
        path to a JSON file."""
        if isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, str):
            text = spec.strip()
            if text.startswith("[") or text.startswith("{"):
                data = json.loads(text)
            else:
                path = text[1:] if text.startswith("@") else text
                with open(path) as f:
                    data = json.load(f)
        else:
            data = spec
        if isinstance(data, dict):
            data = data.get("faults", [data])
        return cls(data)

    # ----------------------------- injection -----------------------------
    def _take(self, **match) -> Optional[Dict[str, Any]]:
        """Return the first unfired fault matching ``match``, marking it
        fired — the once-only discipline that makes replay deterministic."""
        for i, f in enumerate(self.faults):
            if i in self.fired:
                continue
            if all(f.get(k) == v for k, v in match.items()):
                self.fired.add(i)
                return f
        return None

    def corrupt_batch(self, step: int, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Poison every leaf of the host batch for a matching ``nan_batch``
        fault; returns the batch unchanged otherwise."""
        if self._take(kind="nan_batch", step=step) is None:
            return batch
        return {k: _poison(v) for k, v in batch.items()}

    def fire_signals(self, step: int) -> None:
        if self._take(kind="sigterm", step=step) is not None:
            signal.raise_signal(signal.SIGTERM)

    def crash_at(self, point: str) -> None:
        for i, f in enumerate(self.faults):
            if i in self.fired or f.get("kind") != "crash" or f.get("point") != point:
                continue
            hits = self._hits.get(i, 0)
            self._hits[i] = hits + 1
            if hits < int(f.get("skip", 0)):
                continue                    # let the first N saves commit
            self.fired.add(i)
            if f.get("mode") == "exit":
                os._exit(17)
            raise ChaosCrash(f"injected crash at '{point}'")

    def wrap_marker(self, step: int, marker: Any) -> Any:
        """``marker`` (step ``step``'s recorded CUDA event), wrapped in a
        :class:`StallMarker` for a matching ``stall`` fault."""
        f = self._take(kind="stall", step=step)
        if f is None:
            return marker
        return StallMarker(marker, float(f.get("seconds", 1.0)))


def _poison(arr):
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.floating):
        return np.full_like(a, np.nan)
    if np.issubdtype(a.dtype, np.integer):
        info = np.iinfo(a.dtype)
        return np.full_like(a, min(BAD_TOKEN_ID, int(info.max)))
    return a


class StallMarker:
    """Wraps a recorded ``torch.cuda.Event`` so that it reads as incomplete
    until ``seconds`` after the wrap — to a :class:`~repro_torch.launch.
    metrics.DeviceClock` polling ``query()``, a wedged device. ``event`` is
    the wrapped event, which the clock times."""

    def __init__(self, marker: Any, seconds: float):
        self.event = marker
        self.seconds = seconds
        self._ready_at = time.time() + seconds

    def query(self) -> bool:
        return time.time() >= self._ready_at and self.event.query()

    def synchronize(self) -> None:
        time.sleep(max(0.0, self._ready_at - time.time()))
        self.event.synchronize()


# ------------------------- module-global plumbing -------------------------
# The checkpoint writer (possibly on its writer thread) consults the active
# plan at its crash points; the Trainer activates the plan for the duration
# of fit(). Set-before-thread-start ordering makes this safe unread-locked.
_active: Optional[FaultPlan] = None


def activate(plan: FaultPlan) -> None:
    global _active
    _active = plan


def deactivate() -> None:
    global _active
    _active = None


@contextmanager
def active_plan(plan: FaultPlan):
    activate(plan)
    try:
        yield plan
    finally:
        deactivate()


def crash_point(name: str) -> None:
    """Declared at host-side commit boundaries (checkpoint writer); a no-op
    unless the active plan holds an unfired ``crash`` fault for ``name``."""
    if _active is not None:
        _active.crash_at(name)


def load_plan(config_spec: Optional[str] = None) -> Optional[FaultPlan]:
    """Resolve the fault plan from config or the environment (config wins);
    ``None`` when neither is set — the common, zero-overhead case."""
    spec = config_spec if config_spec else os.environ.get(ENV_VAR)
    if not spec:
        return None
    return FaultPlan.from_spec(spec)


# ------------------------------ offline faults ----------------------------
def flip_checkpoint_leaf(directory: str, step: int, leaf: str, bit: int = 0) -> str:
    """Flip one bit in the payload of the first checkpoint leaf whose key
    contains ``leaf``. The manifest checksum is left intact, so a verified
    restore detects the corruption. Returns the corrupted key."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for key, meta in sorted(manifest["leaves"].items()):
        if leaf in key:
            fpath = os.path.join(path, meta["file"])
            with open(fpath, "rb") as f:
                data = bytearray(f.read())
            # flip inside the array payload (the .npy header is ~128 bytes;
            # the last byte is always payload for non-empty arrays)
            idx = len(data) - 1 - (bit // 8)
            data[idx] ^= 1 << (bit % 8)
            with open(fpath, "wb") as f:
                f.write(bytes(data))
            return key
    raise KeyError(f"no checkpoint leaf matching '{leaf}' at step {step}")


__all__ = [
    "BAD_TOKEN_ID",
    "ChaosCrash",
    "ENV_VAR",
    "FaultPlan",
    "StallMarker",
    "activate",
    "active_plan",
    "crash_point",
    "deactivate",
    "flip_checkpoint_leaf",
    "load_plan",
]
