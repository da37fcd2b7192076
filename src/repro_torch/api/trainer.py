"""The ``Trainer``: a step-dispatch loop over a declarative
``ExperimentConfig``, with every side effect (checkpointing, eval,
telemetry, monitoring, early stop, divergence rollback) delegated to
``Callback`` plugins — the port of the JAX package's ``api/trainer.py``.

It runs on the CUDA device: ``Trainer(cfg)`` picks ``cuda`` and raises if
there is none. Only an explicit ``device="cpu"`` runs on the CPU (the tests
do). A step's metrics leave the step function as device scalars and flow
through ``on_step_end`` in a lazy :class:`MetricsFuture`; they are read in
bulk at the logger's flushes, at console and checkpoint boundaries and when
the report is assembled. Each step is timed on the host clock around work
that ends in a device synchronize (``last_step_time``); with
``train.device_timing`` a :class:`DeviceClock` of CUDA events gives the
device time besides.

Resume needs nothing but the checkpoint directory — the finalized config
rides in the manifest::

    report = Trainer.from_checkpoint("/ckpts/run1").fit()

Steps dispatch through ``launch.steps.make_run_step``, which runs
``graft.overlap`` as the sequential step (its docstring says why).

``train.fault_plan`` (or ``REPRO_FAULT_PLAN``) activates the chaos harness
(``resilience/chaos.py``) for the run: SIGTERM before a step, a poisoned
host batch, a crash at a checkpoint commit point, a stalled DeviceClock
event. ``train.audit`` runs the step loop under a strict
:class:`~repro_torch.analysis.SyncGuard` (a host sync outside a
``sync_allowed`` site raises) and a :class:`~repro_torch.analysis.recompile.
RecompileWatcher` (a drifting step signature raises), and reports both under
``report["audit"]``. The port syncs twice a step where the JAX loop does
not: the sentinel's read (``sentinel``) and the synchronize that ends the
step's timing (``step_sync``), both sanctioned (``ROADMAP.md`` C).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.api import callbacks as cb_lib
from repro_torch.api.config import ExperimentConfig
from repro_torch.checkpoint import load_train_state, train_state_spec
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.metrics import DeviceClock, MetricsFuture, materialize_metrics

# the port's host-side counters, which JAX keeps as int32 device scalars:
# their values change every step and are no part of its signature
_HOST_COUNTERS = ("step", "health")


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` → the CUDA device, or an error when there is none: an entry
    point never falls back to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch trains on the GPU; pass "
                "device='cpu' (or --device=cpu) to run on the CPU on purpose")
        return torch.device("cuda")
    return torch.device(device)


class HistoryBuffer:
    """Bounded per-step history: with ``cap > 0`` keeps the FIRST row plus
    a tail window of the last ``cap`` rows (dropping the middle, unread);
    ``cap == 0`` keeps everything."""

    def __init__(self, cap: int = 0):
        self.cap = cap
        self._first: Optional[Any] = None
        self._tail: collections.deque = collections.deque(
            maxlen=cap if cap > 0 else None)
        self.total = 0

    def append(self, row) -> None:
        if self.total == 0 and self.cap > 0:
            self._first = row
        else:
            self._tail.append(row)
        self.total += 1

    @property
    def last(self):
        if self._tail:
            return self._tail[-1]
        return self._first

    @property
    def dropped(self) -> int:
        return self.total - len(self._tail) - (1 if self._first is not None else 0)

    def rows(self) -> List[Dict[str, float]]:
        """The retained rows read to host floats, oldest first."""
        out = ([self._first] if self._first is not None else []) + list(self._tail)
        return [materialize_metrics(r) for r in out]


class Trainer:
    """Runs one experiment on ``device`` (default: the GPU). ``callbacks``
    are appended to the stock set derived from the config; pass
    ``use_default_callbacks=False`` to take full control of the list."""

    def __init__(self, config: ExperimentConfig,
                 callbacks: Optional[Iterable[cb_lib.Callback]] = None,
                 use_default_callbacks: bool = True,
                 device: Optional[str | torch.device] = None):
        self.config = config.finalized()
        self.device = resolve_device(device)
        cbs = list(cb_lib.default_callbacks(self.config) if use_default_callbacks else [])
        if callbacks:
            cbs.extend(callbacks)
        self.callbacks = sorted(cbs, key=lambda c: c.priority)

        # populated by fit(); callbacks read these
        self.mcfg = None
        self.tcfg: Optional[steps_lib.TrainConfig] = None
        self.data = None
        self.state: Optional[Dict[str, Any]] = None
        self.start_step: int = 0
        self.num_params = 0
        self.last_step_time: float = 0.0
        self.device_clock: Optional[DeviceClock] = None
        self.should_stop: bool = False
        self.stop_reason: Optional[str] = None
        self.checkpoint_manager = None
        # set by the DivergenceGuardCallback, consumed by the loop
        # (rollback) and the CheckpointCallback (save refusal)
        self.sentinel_tripped: bool = False
        self.rollbacks: List[Dict[str, Any]] = []
        self._rollback_reason: Optional[str] = None
        self._chaos = None

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, directory: str,
                        callbacks: Optional[Iterable[cb_lib.Callback]] = None,
                        use_default_callbacks: bool = True,
                        device: Optional[str | torch.device] = None) -> "Trainer":
        """The experiment of a checkpoint directory alone: the manifest's
        ``ExperimentConfig``, with ``stop_after`` (a one-shot simulated
        preemption, already consumed) and ``fault_plan`` cleared and
        ``checkpoint_dir`` pointed at ``directory``, so the run restores and
        keeps checkpointing in place. The ``backend`` section is cleared:
        the restart picks its own."""
        from repro_torch.checkpoint import load_experiment
        cfg = load_experiment(directory)
        cfg = dataclasses.replace(cfg, backend=None, train=dataclasses.replace(
            cfg.train, stop_after=None, fault_plan=None, checkpoint_dir=directory))
        return cls(cfg, callbacks=callbacks, use_default_callbacks=use_default_callbacks,
                   device=device)

    def data_state(self) -> Dict[str, int]:
        """The data-pipeline state a checkpoint records: the position of
        the last consumed batch."""
        return self.data.state_dict()

    def request_stop(self, reason: str = "requested") -> None:
        """Ask the loop to exit after this step's callbacks finish (the
        checkpointer runs after the stop-requesting callbacks, so the stop
        is checkpointed first)."""
        self.should_stop = True
        if self.stop_reason is None:
            self.stop_reason = reason

    def request_rollback(self, reason: str = "diverged") -> None:
        """Ask the loop to restore the last healthy checkpoint after this
        step's callbacks finish. Without a checkpoint manager the run stops
        instead."""
        if self._rollback_reason is None:
            self._rollback_reason = reason

    def _fire(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def _fire_abort(self) -> None:
        """Best-effort cleanup when fit() exits on an exception."""
        for cb in self.callbacks:
            try:
                cb.on_train_abort(self)
            except Exception as e:                      # noqa: BLE001
                print(f"[train] abort cleanup error in {type(cb).__name__}: {e}", flush=True)

    def _perform_rollback(self, at_step: int) -> Optional[int]:
        """Restore the newest checkpoint that verifies and is stamped
        healthy and rewind the data pipeline to it. Returns the step to
        resume from, or None (with a stop requested)."""
        reason = self._rollback_reason
        self._rollback_reason = None
        mgr = self.checkpoint_manager
        if mgr is None:
            print(f"[train] divergence ({reason}) with no checkpoint manager — stopping",
                  flush=True)
            self.request_stop("diverged")
            return None
        with sync_allowed("rollback"):
            mgr.wait()
            try:
                _, flat, manifest = mgr.restore_latest_good(train_state_spec(self.state))
            except FileNotFoundError:
                print(f"[train] divergence ({reason}) and no healthy checkpoint to roll "
                      "back to — stopping", flush=True)
                self.request_stop("diverged")
                return None
            load_train_state(self.state, flat)
            self.data.load_state_dict(manifest["extra"]["data"])
        resume = int(manifest["extra"]["train_step"])
        self.sentinel_tripped = False
        self.rollbacks.append({"at_step": at_step, "to_step": resume, "reason": reason})
        print(f"[train] ROLLBACK at step {at_step}: {reason} — resumed from checkpoint "
              f"step {resume}", flush=True)
        return resume

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            with sync_allowed("step_sync"):
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def fit(self) -> Dict[str, Any]:
        cfg = self.config
        tr = cfg.train
        self.mcfg, self.tcfg, self.data = cfg.build()
        gen = torch.Generator(device=self.device).manual_seed(tr.seed)
        self.state = steps_lib.init_train_state(self.mcfg, self.tcfg, gen, tr.batch,
                                                self.device)
        self.num_params = sum(p.numel() for p in self.state["params"])
        run_step = steps_lib.make_run_step(self.mcfg, self.tcfg)
        history = HistoryBuffer(cap=tr.history_cap)
        if tr.device_timing and self.device.type == "cuda":
            self.device_clock = DeviceClock(stall_timeout_s=tr.device_timeout_s or None)
        step_s = 0.0
        audit_guard = watcher = None
        if tr.audit:
            # fail-fast enforcement of the loop's contract: any host sync
            # outside a sync_allowed(...) site raises at the call site; any
            # step-signature drift raises too
            from repro_torch.analysis.recompile import RecompileWatcher
            from repro_torch.analysis.sync_guard import SyncGuard
            audit_guard = SyncGuard(strict=True, label="train.audit")
            watcher = RecompileWatcher(label="run_step")
        from repro_torch.resilience import chaos as chaos_lib
        self._chaos = chaos_lib.load_plan(tr.fault_plan)
        if self._chaos is not None:
            # module-global so the checkpoint writer (its own thread) sees
            # the crash points too
            chaos_lib.activate(self._chaos)
        completed = False
        try:
            self.start_step = 0
            # hooks may restore state + data position (checkpoint resume);
            # the iterator is created only after
            self._fire("on_train_start")
            it = iter(self.data)
            t_start = time.perf_counter()
            # the guard covers the step loop only — state init, restore
            # hooks and report assembly sync legitimately
            with audit_guard if audit_guard is not None else contextlib.nullcontext():
                step = self.start_step
                while step < tr.steps:
                    if self._chaos is not None:
                        self._chaos.fire_signals(step)
                        batch_np = self._chaos.corrupt_batch(step, next(it))
                    else:
                        batch_np = next(it)
                    batch = self._to_device(batch_np)
                    if watcher is not None:
                        drift = watcher.observe(
                            step=step, batch=batch,
                            state={k: v for k, v in self.state.items()
                                   if k not in _HOST_COUNTERS})
                        if drift:
                            raise RuntimeError("[train.audit] " +
                                               "; ".join(f.message for f in drift))
                    t0 = time.perf_counter()
                    self.state, dev_metrics = run_step(self.state, batch)
                    if self.device_clock is not None:
                        marker = torch.cuda.Event(enable_timing=True)
                        marker.record()
                        if self._chaos is not None:
                            marker = self._chaos.wrap_marker(step, marker)
                        self.device_clock.observe(step, marker)
                    self._sync()
                    self.last_step_time = time.perf_counter() - t0
                    step_s += self.last_step_time
                    dev_metrics["step_time_s"] = self.last_step_time
                    metrics = MetricsFuture(dev_metrics)
                    self._fire("on_step_end", step, metrics)
                    history.append(metrics)
                    if self._rollback_reason is not None:
                        resumed = self._perform_rollback(step)
                        if resumed is not None:
                            step = resumed
                            continue
                    if self.should_stop:
                        break
                    step += 1
            wall = time.perf_counter() - t_start
            last = history.last
            rows = history.rows()
            report: Dict[str, Any] = {
                "final_loss": last["loss"] if last is not None else None,
                "history": rows,
                "wall_s": wall,
                "config_hash": cfg.config_hash(),
                "host_loop": {"steps": history.total, "dispatched_ahead": 0,
                              "dispatch_s": step_s},
                "steps": history.total,
                "device": str(self.device),
                "num_params": self.num_params,
            }
            if self.device_clock is not None:
                self.device_clock.drain()
                report["host_loop"]["device_timed_steps"] = self.device_clock.timed_steps
                report["host_loop"]["device_time_s"] = self.device_clock.total_device_s
                if self.device_clock.stalled:
                    report["host_loop"]["device_stalled"] = True
            if audit_guard is not None:
                report["audit"] = {
                    "sync_events": len(audit_guard.events),
                    "unsanctioned": len(audit_guard.violations),
                    "sync_sites": {f"{site}:{kind}": n for (site, kind), n
                                   in sorted(audit_guard.site_counts().items())},
                    "recompiles": len(watcher.findings),
                }
            evals = [r for r in rows if "eval_loss" in r]
            if evals:                   # the last held-out numbers, for the CLI
                report["eval"] = {k: v for k, v in evals[-1].items() if k.startswith("eval_")}
            if history.dropped:
                report["history_dropped"] = history.dropped
            if self.stop_reason is not None:
                report["stopped"] = self.stop_reason
            if self.rollbacks:
                report["resilience"] = {"rollbacks": self.rollbacks}
            self._fire("on_train_end", report)
            completed = True
            return report
        finally:
            if not completed:
                # exiting on an exception: on_train_end never fires, but
                # signal handlers, open files and writer threads must still
                # be released (the chaos crash scenarios restart in-process)
                self._fire_abort()
            if self._chaos is not None:
                chaos_lib.deactivate()
                self._chaos = None
            if self.device_clock is not None:
                self.device_clock.close()
