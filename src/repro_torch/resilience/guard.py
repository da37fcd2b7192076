"""Divergence guard: host-side consumer of the divergence sentinel's
verdict — the port of the JAX package's ``resilience/guard.py``.

``apply_sentinel`` (``launch/steps.py``) already contains the blast: an
unhealthy update is skipped outright. What remains for the host is the
slow-burn case — ``bad_streak`` growing past ``train.bad_step_patience``
means the run is wedged (every step NaN, or a persistent loss spike), and
the way forward is rolling back to the last checkpoint stamped healthy.

The guard reads the verdict without adding host syncs on the healthy path:
``healthy``/``bad_streak`` ride the step's lazy ``MetricsFuture``, and the
guard only inspects rows some other boundary (JSONL flush, console print,
checkpoint save) has already read. Rows that outlive a full
``check_every`` window with no consumer reading them are read here, under
a sanctioned ``sync_allowed`` site — bounded cadence, never per step.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict

from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.api.callbacks import Callback


class DivergenceGuardCallback(Callback):
    """Trips the trainer's rollback after ``patience`` consecutive bad steps.

    Priority 45: after the JSONL logger (30) — whose flush reads rows the
    guard then inspects for free — and before the checkpointer (90), so a
    tripped sentinel blocks the save of a poisoned state in the same step
    (``CheckpointCallback`` checks ``trainer.sentinel_tripped``).
    """
    priority = 45

    def __init__(self, patience: int = 10, check_every: int = 20):
        self.patience = max(1, patience)
        self.check_every = max(1, check_every)
        self.bad_steps = 0
        self.max_streak = 0
        self._pending: deque = deque()   # (step, MetricsFuture), oldest first

    # ------------------------------ hooks --------------------------------
    def on_step_end(self, trainer, step: int, metrics: Dict[str, Any]) -> None:
        if "bad_streak" not in metrics:   # sentinel disabled for this run
            return
        self._pending.append((step, metrics))
        # consume the already-read prefix — free, no device sync
        while self._pending and self._pending[0][1].materialized:
            if self._consume(trainer, *self._pending.popleft()):
                return
        # rows that aged past a full check window with no boundary reading
        # them: read them here, bounded
        while self._pending and step - self._pending[0][0] >= self.check_every:
            old_step, row = self._pending.popleft()
            with sync_allowed("divergence_guard"):
                row.materialize()
            if self._consume(trainer, old_step, row):
                return

    def on_train_end(self, trainer, report: Dict[str, Any]) -> None:
        with sync_allowed("divergence_guard"):
            while self._pending:
                step, row = self._pending.popleft()
                row.materialize()
                self._consume(trainer, step, row)
        res = report.setdefault("resilience", {})
        res.update({"bad_steps": self.bad_steps,
                    "max_bad_streak": self.max_streak,
                    "tripped": trainer.sentinel_tripped})

    # ----------------------------- internals -----------------------------
    def _consume(self, trainer, step: int, row) -> bool:
        """Inspect one read row; returns True when the guard trips (the
        remaining pending rows belong to the abandoned trajectory)."""
        vals = row.materialize()                           # cached — no sync
        streak = int(vals.get("bad_streak", 0))
        if vals.get("healthy", 1.0) < 0.5:
            self.bad_steps += 1
        self.max_streak = max(self.max_streak, streak)
        if streak >= self.patience and not trainer.sentinel_tripped:
            trainer.sentinel_tripped = True
            self._pending.clear()
            trainer.request_rollback(
                f"bad_streak {streak} >= patience {self.patience} at step {step}")
            return True
        return False


__all__ = ["DivergenceGuardCallback"]
