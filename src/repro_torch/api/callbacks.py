"""Lifecycle callbacks — everything the training loop does besides stepping:
the port of the JAX package's ``api/callbacks.py``, with its priorities and
ordering contract.

Checkpointing, held-out eval, JSONL telemetry, straggler monitoring,
console logging and preemption/early stop are ``Callback`` plugins
dispatched at the hooks:

  * ``on_train_start(trainer)``             — after state init, BEFORE the
    data iterator is created (so a restore can rewind the pipeline)
  * ``on_step_end(trainer, step, metrics)`` — once per step, in ascending
    ``priority`` order; callbacks may mutate ``metrics`` in place (eval
    merges its numbers here) and call ``trainer.request_stop(reason)``
  * ``on_checkpoint(trainer, step, path)``  — after a checkpoint commits
  * ``on_train_end(trainer, report)``       — once, may enrich the report
  * ``on_train_abort(trainer)``             — instead of ``on_train_end``
    when ``fit()`` exits on an exception

Ordering contract (the ``priority`` numbers below): preemption decides stop
BEFORE eval/telemetry run, eval merges metrics BEFORE the JSONL logger
queues them, and the checkpointer runs LAST so a stop request is always
checkpointed before the loop exits.

``metrics`` is a lazy ``MetricsFuture`` over device scalars: reading a
value syncs the host with the device, so a callback on the per-step path
touches values only at its own boundaries (print steps, checkpoint saves,
flushes); key-level checks are free.

Under a multiprocess backend only the primary (rank 0) writes checkpoints,
the JSONL stream and console lines; every rank restores the step the
primary picks (``CheckpointManager.restore_agreed``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.checkpoint import (CheckpointManager, EmergencySaver, load_train_state,
                                    train_state_spec)
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.launch.evaluate import make_eval_fn_for
from repro_torch.launch.metrics import (MetricsLogger, format_step_line,
                                        materialize_metrics, sanitize_row,
                                        train_step_flops)

class Callback:
    """Base lifecycle plugin. Lower ``priority`` runs earlier in every hook.

    The default (50) sits between the stock telemetry plugins (10-40) and
    the checkpointer (90), so a user callback that calls
    ``trainer.request_stop()`` still gets its stop checkpointed in the same
    step — keep custom priorities below 90 to preserve that guarantee."""
    priority: int = 50

    def on_train_start(self, trainer) -> None:
        pass

    def on_step_end(self, trainer, step: int, metrics: Dict[str, Any]) -> None:
        pass

    def on_checkpoint(self, trainer, step: int, path: str) -> None:
        pass

    def on_train_end(self, trainer, report: Dict[str, Any]) -> None:
        pass

    def on_train_abort(self, trainer) -> None:
        """Fired (instead of ``on_train_end``) when ``fit()`` exits on an
        exception — release external resources here (signal handlers, open
        files, writer threads). Exceptions raised here are logged, not
        propagated."""


class PreemptionCallback(Callback):
    """SIGTERM/SIGINT emergency stop + ``stop_after`` simulated preemption.
    Runs first so the checkpointer (last) sees the stop request in the same
    step."""
    priority = 10

    def __init__(self, stop_after: Optional[int] = None):
        self.stop_after = stop_after
        self.saver: Optional[EmergencySaver] = None

    def on_train_start(self, trainer) -> None:
        self.saver = EmergencySaver()

    def on_step_end(self, trainer, step, metrics) -> None:
        if self.saver is not None and self.saver.should_stop:
            trainer.request_stop("preempted")
        elif self.stop_after is not None and step + 1 >= self.stop_after:
            trainer.request_stop("stop_after")

    def on_train_end(self, trainer, report) -> None:
        if self.saver is not None:
            self.saver.restore_handlers()

    def on_train_abort(self, trainer) -> None:
        if self.saver is not None:
            self.saver.restore_handlers()


class EvalCallback(Callback):
    """Held-out eval every N steps, off the critical path by default.

    At an eval boundary the eval forwards are dispatched on the current
    stream against the live parameters — the stream orders their reads
    before the next step's in-place update — and the device scalars merge
    into the step's ``MetricsFuture`` at once; the previous boundary's
    handle is collected then (and the last one at ``on_train_end``).
    ``train.sync_eval`` stays in the config so that the JAX package's
    configs load; its blocking mode runs the same device computation, and
    the port has only this one."""
    priority = 20

    def __init__(self, every: int, num_batches: int = 4):
        self.every = every
        self.num_batches = num_batches
        self.eval_fn = None
        self._in_flight = None

    def on_train_start(self, trainer) -> None:
        self.eval_fn = make_eval_fn_for(trainer.config, trainer.mcfg,
                                        num_batches=self.num_batches, device=trainer.device,
                                        backend=trainer.backend)

    def on_step_end(self, trainer, step, metrics) -> None:
        if not (self.every and (step + 1) % self.every == 0):
            return
        handle = self.eval_fn.dispatch(trainer.state["model"])
        metrics.update(handle)          # row tagged with the dispatch step
        self._collect()
        self._in_flight = handle

    def _collect(self) -> None:
        if self._in_flight is not None:
            self.eval_fn.collect(self._in_flight)
            self._in_flight = None

    def on_train_end(self, trainer, report) -> None:
        self._collect()                 # nothing in flight past the loop


class MetricsCallback(Callback):
    """JSONL telemetry stream + throughput/MFU tracking. Runs after eval so
    held-out numbers reach the stream (one row per step). Rows are queued
    with their device values and the logger reads and writes them only
    every ``flush_every`` steps and on close. Only the primary writes the
    stream; MFU counts every rank's device."""
    priority = 30

    def __init__(self, path: Optional[str] = None, flush_every: int = 20):
        self.path = path
        self.flush_every = flush_every
        self.logger: Optional[MetricsLogger] = None
        self._primed = False

    def on_train_start(self, trainer) -> None:
        tr = trainer.config.train
        self.logger = MetricsLogger(
            self.path if trainer.backend.is_primary else None,
            num_chips=trainer.backend.device_count(),
            flops_per_step=train_step_flops(
                trainer.num_params, tr.batch * tr.seq,
                remat=trainer.mcfg.remat != "none", mcfg=trainer.mcfg, seq=tr.seq),
            flush_every=self.flush_every, device_clock=trainer.device_clock)

    def on_step_end(self, trainer, step, metrics) -> None:
        tr = trainer.config.train
        tokens = tr.batch * tr.seq
        if not self._primed:
            # a resumed run starts mid-stream: seed the token counter so
            # tokens_seen does not restart from zero
            if trainer.start_step:
                self.logger.tokens_seen = trainer.start_step * tokens
            self._primed = True
        self.logger.log(step, metrics, tokens=tokens, step_time=trainer.last_step_time)

    def on_train_end(self, trainer, report) -> None:
        if self.logger is not None:
            self.logger.close()
            report.setdefault("host_loop", {})["metrics_drain_s"] = self.logger.drain_s

    def on_train_abort(self, trainer) -> None:
        if self.logger is not None:
            self.logger.close()     # flush the buffered tail of the stream


class StragglerCallback(Callback):
    """Per-step time distribution; the summary lands in the report. With the
    trainer's :class:`DeviceClock` the monitor is fed device step times
    (CUDA event deltas, collected as they complete); without it the host
    step clock."""
    priority = 40

    def __init__(self):
        self.monitor = StragglerMonitor()
        self._source = "dispatch"

    def on_train_start(self, trainer) -> None:
        # a fleet's summaries name the worst rank by this
        self.monitor.process_index = trainer.backend.process_index

    def on_step_end(self, trainer, step, metrics) -> None:
        if trainer.device_clock is not None:
            self._source = "device"
            for _, dt in trainer.device_clock.poll():
                self.monitor.record(dt)
        else:
            self.monitor.record(trainer.last_step_time)

    def on_train_end(self, trainer, report) -> None:
        if trainer.device_clock is not None:
            trainer.device_clock.drain()
            for _, dt in trainer.device_clock.poll():
                self.monitor.record(dt)
        summary = self.monitor.summary()
        summary["source"] = self._source
        report["straggler"] = summary


class LegacyFunctionCallback(Callback):
    """Adapter for a plain ``fn(step, state, metrics)`` hook, once per step."""
    priority = 55

    def __init__(self, fn: Callable[[int, Any, Dict[str, Any]], None]):
        self.fn = fn

    def on_step_end(self, trainer, step, metrics) -> None:
        self.fn(step, trainer.state, metrics)


class ConsoleCallback(Callback):
    """Progress lines every ``log_every`` steps (post-eval metrics). Only
    the rows actually printed are read to the host."""
    priority = 60

    def __init__(self, every: int = 10):
        self.every = every

    def on_step_end(self, trainer, step, metrics) -> None:
        if self.every and step % self.every == 0 and trainer.backend.is_primary:
            with sync_allowed("console"):
                print(format_step_line(step, metrics, trainer.last_step_time,
                                       use_graft=trainer.tcfg.use_graft), flush=True)


class CheckpointCallback(Callback):
    """Fault-tolerant checkpointing: auto-restore on start, periodic +
    final + stop-triggered saves, the finalized ``ExperimentConfig`` in the
    manifest so a resume needs nothing but the directory.

    Runs LAST in ``on_step_end`` so any stop requested earlier in the same
    step (preemption, ``stop_after``) is checkpointed before the loop exits.
    The state's device→host copy finishes inside ``on_step_end`` — the next
    step updates the parameters in place — and only the file writing runs
    on the writer thread. Under a multiprocess backend the primary alone
    recovers half-finished commits, walks, quarantines and writes; the
    other ranks restore the step it picks and skip the save.
    """
    priority = 90

    def __init__(self, directory: str, every: int = 50, keep_last_n: int = 2,
                 async_save: bool = True, restore: bool = True):
        self.directory = directory
        self.every = every
        self.restore = restore
        # recovery renames directories: the primary does it in on_train_start
        self.manager = CheckpointManager(directory, keep_last_n=keep_last_n,
                                         async_save=async_save, recover=False)

    def on_train_start(self, trainer) -> None:
        trainer.checkpoint_manager = self.manager
        if trainer.backend.is_primary:
            self.manager.recover()
        if not self.restore:
            return
        try:
            # newest checkpoint that verifies (checksums, leaves) AND is
            # stamped healthy; a corrupt one is quarantined to corrupt.<step>
            _, flat, manifest = self.manager.restore_agreed(
                train_state_spec(trainer.state), trainer.backend)
        except FileNotFoundError:
            return                            # fresh run — nothing on disk
        load_train_state(trainer.state, flat)
        trainer.data.load_state_dict(manifest["extra"]["data"])
        trainer.start_step = int(manifest["extra"]["train_step"])
        saved_hash = manifest["extra"].get("config_hash")
        ours = trainer.config.config_hash()
        if saved_hash is not None and saved_hash != ours:
            print(f"[train] WARNING: resuming config {ours} from a "
                  f"checkpoint written by config {saved_hash}")
        print(f"[train] resumed from step {trainer.start_step}")

    def on_step_end(self, trainer, step, metrics) -> None:
        total = trainer.config.train.steps
        due = (step + 1) % self.every == 0
        if not (due or trainer.should_stop or step + 1 == total):
            return
        if trainer.sentinel_tripped:
            # the divergence guard tripped earlier in this hook pass: the
            # live state is poisoned — never save it
            if trainer.backend.is_primary:
                print(f"[ckpt] sentinel tripped — refusing to save step {step + 1}",
                      flush=True)
            return
        if not trainer.backend.is_primary:
            # the state is replicated and its host copy is local: the other
            # ranks neither copy nor write
            return
        with sync_allowed("checkpoint"):
            # a checkpoint boundary is a drain point: the manifest needs
            # JSON floats, and the state's copy to the host must finish here
            vals = materialize_metrics(metrics)
            healthy = (vals.get("healthy", 1.0) >= 0.5 and math.isfinite(vals.get("loss", 0.0)))
            path = self.manager.save(
                step + 1, trainer.backend.to_host(trainer.state),
                topology=trainer.backend.topology(),
                extra={"train_step": step + 1,
                       "data": trainer.data_state(),
                       "metrics": sanitize_row(vals),
                       "health": {"healthy": bool(healthy),
                                  "bad_streak": int(vals.get("bad_streak", 0.0))},
                       "experiment": trainer.config.to_dict(),
                       "config_hash": trainer.config.config_hash()})
        listeners = [cb for cb in trainer.callbacks
                     if type(cb).on_checkpoint is not Callback.on_checkpoint]
        if listeners:
            # "after the checkpoint commits": join the writer first
            self.manager.wait()
            for cb in listeners:
                cb.on_checkpoint(trainer, step, path)
        if trainer.should_stop:
            print("[train] emergency checkpoint written — exiting")

    def on_train_end(self, trainer, report) -> None:
        self.manager.wait()

    def on_train_abort(self, trainer) -> None:
        try:
            self.manager.wait()
        except Exception:       # noqa: BLE001 — a writer that died
            pass                # mid-save left its tmp dir; recover() drops it


class HookRecorder(Callback):
    """Test/debug helper: records (hook, step) tuples in call order."""
    priority = 95

    def __init__(self):
        self.events = []

    def on_train_start(self, trainer) -> None:
        self.events.append(("on_train_start", None))

    def on_step_end(self, trainer, step, metrics) -> None:
        self.events.append(("on_step_end", step))

    def on_checkpoint(self, trainer, step, path) -> None:
        self.events.append(("on_checkpoint", step))

    def on_train_end(self, trainer, report) -> None:
        self.events.append(("on_train_end", None))


def default_callbacks(cfg) -> list:
    """The stock plugin set for an ``ExperimentConfig``, as the JAX
    package's."""
    tr = cfg.train
    cbs: list = [PreemptionCallback(tr.stop_after)]
    if tr.eval_every:
        cbs.append(EvalCallback(tr.eval_every))
    cbs.append(MetricsCallback(tr.metrics_path, flush_every=tr.metrics_flush_every))
    cbs.append(StragglerCallback())
    if tr.sentinel:
        # lazy: repro_torch.resilience.guard imports this module
        from repro_torch.resilience.guard import DivergenceGuardCallback
        cbs.append(DivergenceGuardCallback(
            patience=tr.bad_step_patience, check_every=max(1, tr.metrics_flush_every)))
    if tr.log_every:
        cbs.append(ConsoleCallback(tr.log_every))
    if tr.checkpoint_dir:
        cbs.append(CheckpointCallback(tr.checkpoint_dir, every=tr.checkpoint_every))
    return cbs
