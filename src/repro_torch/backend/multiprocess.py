"""Multi-process execution: one process per rank, joined by
``torch.distributed`` — the twin of the JAX package's
``backend/multiprocess.py``.

Which collectives follows from the topology, and is printed at setup:
NCCL when every rank on the host has a card of its own, gloo on the CPU or
when ranks share a card (NCCL refuses two ranks on one device). On gloo a
CUDA tensor is staged through host memory around each collective.

Data flows per rank: each rank builds its ``DataSource`` shard keyed on
its rank (the per-global-example seeding of ``data/`` makes the union
byte-identical to a one-process run). The train state is replicated:
``replicate`` broadcasts rank 0's freshly initialised state, and the step
keeps it equal by reducing the loss and gradients before every update
(``launch/steps.py``). ``all_reduce`` is the host-side mean of metrics,
optionally through the int8 error-feedback compressed reduce.

The process group's timeout is ``$REPRO_TORCH_DIST_TIMEOUT_S`` seconds
(default 1800, PyTorch's own).
"""
from __future__ import annotations

import datetime
import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.backend import base
from repro_torch.distributed import compression


# leaf alignment in reduce_grads' flat buffers, in elements
_ALIGN = 32


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw else default


class MultiProcessBackend(base.Backend):
    name = "multiprocess"

    def __init__(self, config: base.MultiProcessBackendConfig):
        super().__init__(config)
        self._initialized = False
        self.collectives: Optional[str] = None      # "nccl" | "gloo" after setup
        # error-feedback accumulators of the compressed all_reduce, one per
        # leaf position (reset when the reduced tree changes shape)
        self._ef_errors: Optional[List[torch.Tensor]] = None
        # host seconds of each reduce_grads call (gloo's include the staging)
        self.reduce_seconds: List[float] = []

    # -------------------------------- lifecycle -----------------------------
    def counts(self):
        """``(num_processes, process_id)`` from the config or the
        environment."""
        num = self.config.num_processes or _env_int("WORLD_SIZE", 0)
        pid = self.config.process_id
        if pid < 0:
            pid = _env_int("RANK", -1)
        if num <= 0 or not 0 <= pid < num:
            raise ValueError(
                "multiprocess backend needs num_processes>=1 and 0 <= process_id < "
                "num_processes — set backend.num_processes/backend.process_id or the "
                "WORLD_SIZE/RANK environment variables")
        return num, pid

    def device(self, explicit=None) -> torch.device:
        """An explicit device wins; else this rank's card: local rank modulo
        the cards the host has."""
        if explicit is not None or not torch.cuda.is_available():
            return super().device(explicit)
        num, pid = self.counts()
        local = _env_int("LOCAL_RANK", pid)
        self._device = torch.device("cuda", local % torch.cuda.device_count())
        return self._device

    def setup(self) -> None:
        if self._initialized:
            return
        num, pid = self.counts()
        dev = self._device if self._device is not None else self.device()
        ranks_here = _env_int("LOCAL_WORLD_SIZE", num)
        if dev.type == "cuda" and ranks_here <= torch.cuda.device_count():
            self.collectives, why = "nccl", f"a card for each of {ranks_here} ranks"
            torch.cuda.set_device(dev)
        elif dev.type == "cuda":
            self.collectives = "gloo"
            why = f"{ranks_here} ranks share {torch.cuda.device_count()} card(s)"
        else:
            self.collectives, why = "gloo", "CPU tensors"
        print(f"[backend] rank {pid} of {num}: {self.collectives} collectives on {dev} "
              f"({why})", flush=True)
        timeout = datetime.timedelta(seconds=_env_int("REPRO_TORCH_DIST_TIMEOUT_S", 1800))
        dist.init_process_group(self.collectives, init_method=f"tcp://{self.config.coordinator}",
                                world_size=num, rank=pid, timeout=timeout)
        self._initialized = True

    def teardown(self) -> None:
        if not self._initialized:
            return
        try:
            dist.destroy_process_group()
        finally:
            self._initialized = False
            self._mesh = None           # its groups went with the process group

    # -------------------------------- topology ------------------------------
    @property
    def process_index(self) -> int:
        return dist.get_rank() if self._initialized else self.counts()[1]

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if self._initialized else self.counts()[0]

    # ------------------------------ collectives -----------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the collectives run: host memory for gloo, the rank's
        card for NCCL."""
        if self.collectives == "gloo" and t.device.type != "cpu":
            with sync_allowed("collective"):
                return t.cpu()
        if self.collectives == "nccl" and t.device != self._device:
            return t.to(self._device)
        return t

    def replicate(self, state):
        """Broadcast rank 0's state into every rank's, one collective per
        dtype group."""
        tensors = base.state_tensors(state)
        groups: Dict[Any, List[torch.Tensor]] = {}
        for t in tensors:
            groups.setdefault((t.dtype, t.device), []).append(t)
        with torch.no_grad():
            for group in groups.values():
                flat = self._wire(torch.cat([t.reshape(-1) for t in group]))
                dist.broadcast(flat, src=0)
                flat = flat.to(group[0].device)
                offset = 0
                for t in group:
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                    offset += t.numel()
        return state

    def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        wired = self._wire(tensor.contiguous())
        parts = [torch.empty_like(wired) for _ in range(self.process_count)]
        dist.all_gather(parts, wired)
        return torch.cat(parts, dim=0).to(tensor.device, non_blocking=True)

    def reduce_grads(self, grads: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """``reduce_tensors``, its host seconds kept in ``reduce_seconds``."""
        t0 = time.perf_counter()
        out = self.reduce_tensors(grads, op)
        self.reduce_seconds.append(time.perf_counter() - t0)
        return out

    def reduce_tensors(self, grads: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """One ``all_reduce`` per dtype group, over a flat copy of the
        group; the results are views of it in ``grads``' order (on gloo the
        sum comes back into that copy: the device holds one)."""
        if op not in ("sum", "mean"):
            raise ValueError(f"reduce op must be 'sum' or 'mean', got '{op}'")
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            groups.setdefault(g.dtype, []).append(i)
        for idx in groups.values():
            # each leaf starts on a 64-byte boundary, as a fresh tensor does,
            # so that the optimizer kernels keep their aligned path; one cat
            # writes the buffer
            zeros = torch.zeros(_ALIGN, dtype=grads[idx[0]].dtype, device=grads[idx[0]].device)
            pieces, starts, total = [], [], 0
            for i in idx:
                n = grads[i].numel()
                pad = -n % _ALIGN
                pieces += [grads[i].reshape(-1)] + ([zeros[:pad]] if pad else [])
                starts.append(total)
                total += n + pad
            flat = torch.cat(pieces)
            wired = self._wire(flat)
            dist.all_reduce(wired, op=dist.ReduceOp.SUM)
            if op == "mean":
                wired.div_(self.process_count)
            # staged on the host: the sum comes back into flat, not into a
            # second copy beside it on the device
            if wired is not flat:
                flat.copy_(wired, non_blocking=True)
            for i, s in zip(idx, starts):
                out[i] = flat[s:s + grads[i].numel()].view(grads[i].shape)
        return out

    def broadcast_int(self, value: int) -> int:
        t = self._wire(torch.tensor([int(value)], dtype=torch.int64))
        dist.broadcast(t, src=0)
        with sync_allowed("collective"):
            return int(t.cpu()[0])

    def all_reduce_spec(self) -> base.AllReduceSpec:
        return base.AllReduceSpec(axis="data", num_shards=self.process_count,
                                  compressed=self.config.compress_reduce)

    def all_reduce(self, tree):
        """Cross-process mean of host-side scalars and arrays (metrics, rank
        statistics), as numpy float32. ``compress_reduce`` swaps the float32
        sum for the int8 error-feedback reduce (each call's rounding carried
        in per-leaf accumulators, so it cancels over calls)."""
        leaves, rebuild = base.flatten_tree(tree)
        xs = [self._wire(torch.tensor(np.asarray(v, dtype=np.float32))) for v in leaves]
        n = self.process_count
        if self.config.compress_reduce:
            if (self._ef_errors is None or len(self._ef_errors) != len(xs)
                    or any(e.shape != x.shape for e, x in zip(self._ef_errors, xs))):
                self._ef_errors = [torch.zeros_like(x) for x in xs]

            def pmax(t):
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                return t

            def psum(t):
                dist.all_reduce(t, op=dist.ReduceOp.SUM)
                return t

            means, self._ef_errors = compression.ef_compressed_psum_tree(
                xs, self._ef_errors, n, pmax, psum)
        else:
            means = []
            for x in xs:
                dist.all_reduce(x, op=dist.ReduceOp.SUM)
                means.append(x / n)
        with sync_allowed("collective"):
            host = [m.cpu().numpy().reshape(np.shape(v)) for m, v in zip(means, leaves)]
        return rebuild(host)

    def check_consistent(self, tag: str) -> None:
        """All processes must agree on ``tag`` (the config hash). The digest
        is sha256's, never Python's ``hash()``, which is salted per
        process."""
        word = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "big", signed=True)
        mine = self._wire(torch.tensor([word], dtype=torch.int64))
        every = [torch.empty_like(mine) for _ in range(self.process_count)]
        dist.all_gather(every, mine)
        with sync_allowed("collective"):
            words = torch.cat(every).cpu().tolist()
        if len(set(words)) != 1:
            raise RuntimeError(
                f"processes disagree on '{tag[:32]}…' — every rank must launch with an "
                "identical experiment config")

    # -------------------------------- staging -------------------------------
    @property
    def staging_depth(self) -> int:
        return self.config.prefetch


def _build(cfg: base.MultiProcessBackendConfig) -> MultiProcessBackend:
    return MultiProcessBackend(cfg)


MULTIPROCESS = base.register_backend(base.BackendEntry(
    "multiprocess", base.MultiProcessBackendConfig, _build))
