"""Training telemetry: JSONL metrics stream + throughput/MFU tracking, the
port of the JAX package's ``launch/metrics.py`` with its row keys and flush
cadence.

No device sync on the step path: the trainer hands each step's metrics over
as a :class:`MetricsFuture` (a mapping over device scalars still in the
stream's queue); the logger stamps the host-side fields (wall time,
tokens_seen, step timing) at ``log`` time and reads the device values only
at the flush boundary, every ``flush_every`` rows and on ``close``. A hard
kill between flushes drops at most the last ``flush_every − 1`` rows; a
clean stop drains the buffer through ``close``.

``step_time_s`` is the duration the caller measured around the step
itself (``step_time=``); the host-side gap between ``log`` calls on top of
it is ``host_overhead_s``. With a :class:`DeviceClock` attached, ``mfu`` and
``tokens_per_s`` are re-sourced from device time at the flush.

``mfu`` is measured against ``PEAK_FLOPS_PER_CHIP``, the dense bf16 peak of
one NVIDIA H100 SXM (989 TFLOP/s, NVIDIA's data sheet, at its 700 W limit).
"""
from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Any, Deque, Dict, Iterator, List, Mapping, MutableMapping, \
    Optional, Tuple

import torch

from repro_torch.analysis.sync_guard import sync_allowed

# dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA data sheet)
PEAK_FLOPS_PER_CHIP = 989e12


def _attn_kv_horizon(S: int, window: Optional[int]) -> float:
    """Mean per-query causal KV horizon length over a length-S sequence."""
    if window is not None and window < S:
        w = window
        # the first w queries see q+1 keys, the rest see exactly w
        return (w * (w + 1) / 2.0 + (S - w) * w) / S
    return (S + 1) / 2.0


def attention_train_flops(mcfg, seq: int, tokens_per_step: int,
                          remat: bool = True) -> float:
    """Per-step matmul FLOPs of the attention score/value products — the
    O(S²·Dh·H) term that 6·N·tokens misses. Causal- and window-aware,
    honoring the per-layer local/global pattern."""
    if mcfg.family == "ssm" or not mcfg.num_heads:
        return 0.0
    local = mcfg.is_local_pattern()
    per_token = 0.0
    for i in range(mcfg.num_layers):
        window = mcfg.sliding_window if (mcfg.sliding_window and local[i]) \
            else None
        kv = _attn_kv_horizon(seq, window)
        per_token += 4.0 * kv * mcfg.num_heads * mcfg.head_dim  # QKᵀ + PV
    total = per_token * 3.0                  # forward + 2× backward
    if remat:
        total *= 4.0 / 3.0                   # forward recompute under remat
    return total * tokens_per_step


def train_step_flops(num_params: int, tokens_per_step: int,
                     remat: bool = True, mcfg=None,
                     seq: Optional[int] = None) -> float:
    """6·N·D (+2·N·D recompute under full remat), plus — when the model
    config and sequence length are given — the attention O(S²) term."""
    base = 6.0 * num_params * tokens_per_step
    total = base * (8.0 / 6.0) if remat else base
    if mcfg is not None and seq:
        total += attention_train_flops(mcfg, seq, tokens_per_step, remat=remat)
    return total


class DeviceClock:
    """Device step times from CUDA events, without syncing the step path.

    ``observe`` records one event on the current stream after each step.
    With the queue kept full by the host loop, the time between two
    consecutive events IS the device time of the later step; the first
    observed step has no predecessor and is never timed, so N observed
    steps yield N−1 timings. ``poll`` collects, without blocking, the steps
    whose events have completed (``Event.query``); ``device_time`` and
    ``drain`` wait for them.

    ``stall_timeout_s`` arms a watchdog: when a blocking consumer has waited
    on one event longer than the timeout, it logs the stuck step once,
    stops waiting and returns what it has, so a wedged device degrades the
    report to dispatch timing (``mfu_source: dispatch``) instead of hanging
    it. The stall clears once the event completes.
    """

    def __init__(self, stall_timeout_s: Optional[float] = None):
        self.stall_timeout_s = stall_timeout_s
        self.stalled = False
        self._stall_warned = False
        self._queue: Deque[Tuple[int, Any]] = collections.deque()
        self._prev: Optional[torch.cuda.Event] = None
        self._times: Dict[int, float] = {}          # step → device seconds
        self._fresh: List[Tuple[int, float]] = []   # not yet poll()ed
        self._waiting: Optional[Tuple[int, float]] = None  # (step, t_block)
        self._closed = False

    def observe(self, step: int, marker: Any = None) -> None:
        """Queue this step's completion event: ``marker``, an event already
        recorded after the step or a wrapper of one (``query()`` answers for
        it, ``event`` is the event to time: ``resilience.chaos.StallMarker``),
        or by default one recorded now on the current stream."""
        if self._closed:
            return
        if marker is None:
            marker = torch.cuda.Event(enable_timing=True)
            marker.record()
        self._queue.append((step, marker))

    def _collect(self) -> None:
        while self._queue and self._queue[0][1].query():
            step, ev = self._queue.popleft()
            ev = getattr(ev, "event", ev)
            if self._prev is not None:
                dt = self._prev.elapsed_time(ev) / 1e3
                self._times[step] = dt
                self._fresh.append((step, dt))
            self._prev = ev
            self._waiting = None
            self.stalled = False

    def _stalled_now(self) -> bool:
        """Has a blocking consumer waited on the oldest event past
        ``stall_timeout_s``? Warns once, naming the stuck step."""
        if self.stall_timeout_s is None or not self._queue:
            return False
        step = self._queue[0][0]
        if self._waiting is None or self._waiting[0] != step:
            self._waiting = (step, time.time())
        if time.time() - self._waiting[1] >= self.stall_timeout_s:
            self.stalled = True
            if not self._stall_warned:
                self._stall_warned = True
                print(f"[device-clock] WARNING: step {step} event incomplete after "
                      f"{self.stall_timeout_s:.1f}s — device stall suspected; timing "
                      "falls back to the dispatch clock (mfu_source: dispatch)", flush=True)
        return self.stalled

    def _wait(self, done, timeout: float) -> None:
        deadline = time.time() + timeout
        self._collect()
        while not done() and self._queue and not self._stalled_now() \
                and time.time() < deadline:
            time.sleep(0.0005)
            self._collect()

    def device_time(self, step: int, timeout: Optional[float] = None) -> Optional[float]:
        """Device seconds for ``step``; optionally wait for its event.
        Returns at once (with what exists) once the watchdog trips."""
        if timeout:
            self._wait(lambda: step in self._times, timeout)
        else:
            self._collect()
        return self._times.get(step)

    def poll(self) -> List[Tuple[int, float]]:
        """Drain newly completed (step, device_dt) pairs (straggler feed)."""
        self._collect()
        out, self._fresh = self._fresh, []
        return out

    def drain(self, timeout: float = 30.0) -> None:
        """Wait until every observed event has completed — or the watchdog
        declares the device stalled."""
        self._wait(lambda: not self._queue, timeout)

    @property
    def timed_steps(self) -> int:
        return len(self._times)

    @property
    def total_device_s(self) -> float:
        return sum(self._times.values())

    def close(self) -> None:
        self._closed = True


def _to_floats(values: Mapping[str, Any]) -> Dict[str, float]:
    """Every value as a Python float, with one device→host copy for all the
    tensors of one device (the step's one sync)."""
    out: Dict[str, float] = {}
    tensors = {k: v for k, v in values.items() if isinstance(v, torch.Tensor)}
    devices = {v.device for v in tensors.values()}
    if len(devices) == 1:
        flat = torch.stack([v.detach().reshape(()).to(torch.float64)  # lint: allow metrics_flush
                            for v in tensors.values()]).cpu().tolist()
        out.update(zip(tensors, flat))
    else:
        out.update((k, float(v)) for k, v in tensors.items())  # lint: allow metrics_flush drain
    for k, v in values.items():
        if k not in out:
            out[k] = float(v)  # lint: allow host values, no device read
    return {k: out[k] for k in values}


class MetricsFuture(MutableMapping):
    """One step's metrics as device scalars not yet read.

    Behaves like a dict (callbacks may mutate it in place, per the
    ``on_step_end`` contract), but reading the values — the host↔device
    sync — is deferred until someone reads one (``[]``/``items``) or calls
    :meth:`materialize`. Key-level operations (``in``, ``keys``, ``len``,
    assignment) never sync. ``update`` merges more values in (eval's device
    scalars, tagged to the step they were dispatched at).
    """

    __slots__ = ("_data", "_ready")

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        self._data: Dict[str, Any] = dict(data) if data else {}
        self._ready = False

    # -- key-level ops: never sync --------------------------------------
    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    @property
    def materialized(self) -> bool:
        return self._ready

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value
        if self._ready:              # keep the materialized invariant
            self._ready = False
            self.materialize()

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    # -- value-level ops: sync ------------------------------------------
    def __getitem__(self, key: str) -> float:
        return self.materialize()[key]

    def materialize(self) -> Dict[str, float]:
        """Pull every value to the host as a plain float (cached)."""
        if not self._ready:
            self._data = _to_floats(self._data)
            self._ready = True
        return self._data

    def update(self, other: Mapping[str, Any]) -> None:
        if isinstance(other, MetricsFuture):
            other = other._data
        self._data.update(other)
        if self._ready:                  # keep the materialized invariant
            self._ready = False
            self.materialize()


def sanitize_row(row: Mapping[str, Any]) -> Dict[str, Any]:
    """JSON-safe copy of a metrics row: non-finite floats become ``null``
    and their keys are listed under ``nonfinite_keys`` (bare ``NaN`` is not
    JSON; a sentinel-skipped step records its NaN loss honestly)."""
    out: Dict[str, Any] = {}
    bad = []
    for k, v in row.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
            bad.append(k)
        else:
            out[k] = v
    if bad:
        out["nonfinite_keys"] = sorted(bad)
    return out


def materialize_metrics(metrics: Mapping[str, Any]) -> Dict[str, float]:
    """Plain ``{k: float}`` from a MetricsFuture or an eager dict — the one
    sync point for consumers that need host values now (checkpoint
    manifests, console lines, reports)."""
    if isinstance(metrics, MetricsFuture):
        return metrics.materialize()
    return _to_floats(metrics)


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, num_chips: int = 1,
                 flops_per_step: Optional[float] = None,
                 flush_every: int = 20,
                 device_clock: Optional[DeviceClock] = None):
        self.path = path
        self.num_chips = num_chips
        self.flops_per_step = flops_per_step
        self.flush_every = max(1, flush_every)
        self.device_clock = device_clock
        self._f = open(path, "a") if path else None
        # pending rows: (host-side fields, metrics mapping, tokens) triples;
        # device values are read only when the row is drained
        self._pending: list = []
        self._last_t: Optional[float] = None
        self.tokens_seen = 0
        self.drain_s = 0.0               # cumulative time spent materializing

    def log(self, step: int, metrics: Mapping[str, Any], tokens: int = 0,
            step_time: Optional[float] = None) -> Dict[str, Any]:
        """Queue one row. Host-side fields (time, tokens_seen, timing) are
        stamped now; device values drain at the next flush boundary.
        ``step_time`` is the caller's measurement around the step; without
        it the time between ``log`` calls is used."""
        now = time.time()
        base: Dict[str, Any] = {"step": step, "time": now}
        if tokens:
            self.tokens_seen += tokens
            base["tokens_seen"] = self.tokens_seen
        gap = (now - self._last_t) if self._last_t is not None else None
        dt = step_time if step_time is not None else gap
        if dt is not None and dt > 0:
            base["step_time_s"] = dt
            if tokens:
                base["tokens_per_s"] = tokens / dt
            if self.flops_per_step:
                base["mfu"] = (self.flops_per_step /
                               (dt * self.num_chips * PEAK_FLOPS_PER_CHIP))
                base["mfu_source"] = "dispatch"
            if step_time is not None and gap is not None:
                base["host_overhead_s"] = max(0.0, gap - step_time)
        self._last_t = now
        if self._f:
            # without a file the row would only be read to be thrown away
            self._pending.append((base, metrics, tokens))
            if len(self._pending) >= self.flush_every:
                self.flush()
        return base

    def flush(self):
        """Drain the pending rows: read the device values (the logger's only
        host↔device sync) and write the JSONL block. With a
        :class:`DeviceClock` attached, ``mfu``/throughput are re-sourced
        from device time here."""
        if not self._pending:
            return
        t0 = time.time()
        lines = []
        with sync_allowed("metrics_flush"):
            for base, metrics, tokens in self._pending:
                row = dict(base)
                row.update(materialize_metrics(metrics))
                if self.device_clock is not None:
                    dev_dt = self.device_clock.device_time(row["step"], timeout=1.0)
                    if dev_dt is not None and dev_dt > 0:
                        row["device_step_time_s"] = dev_dt
                        if tokens:
                            row["tokens_per_s"] = tokens / dev_dt
                        if self.flops_per_step:
                            row["mfu"] = (self.flops_per_step /
                                          (dev_dt * self.num_chips * PEAK_FLOPS_PER_CHIP))
                            row["mfu_source"] = "device"
                lines.append(json.dumps(sanitize_row(row), allow_nan=False))
        self._pending.clear()
        self.drain_s += time.time() - t0
        if self._f:
            self._f.write("\n".join(lines) + "\n")
            self._f.flush()

    def close(self):
        self.flush()
        if self._f:
            self._f.close()
            self._f = None


def format_step_line(step: int, metrics: Mapping[str, Any], dt: float,
                     use_graft: bool = False) -> str:
    """One console progress line. Materializes ``metrics`` — only call for
    rows actually printed."""
    metrics = materialize_metrics(metrics)
    extra = (f" rank={metrics.get('rank', 0):.0f}"
             f" align={metrics.get('alignment', 0):.3f}" if use_graft else "")
    return (f"[train] step {step:5d} loss {metrics['loss']:.4f} "
            f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f}ms{extra}")


def read_metrics(path: str):
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
