"""Batch staging ahead of the dispatch loop and the GPipe executor — the
port of the JAX package's ``distributed/pipeline.py``.

  * :class:`BatchStager` turns host batches into the backend's device
    batches (``Backend.shard_batch``) with optional lookahead, while keeping
    the data source's one-integer resumable state accounted to the batch
    actually CONSUMED: what a checkpoint must record, since a prefetched but
    unconsumed batch must replay after a resume.
  * :func:`pipeline_forward` runs M microbatches through S pipeline stages,
    one stage a rank along a mesh axis (``backend/mesh.py``), with the
    standard GPipe schedule of S + M − 1 ticks and its bubble
    (:func:`pipeline_bubble_fraction`). It is forward only, as JAX's is.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.backend.base import flatten_tree


class BatchStager:
    """Stages host batches onto the device ahead of the dispatch loop.

    ``depth=0`` pulls and stages inline on ``next()``: the order of
    operations is the loop's without a stager (bit-identical). ``depth>=1``
    keeps that many batches pulled and staged ahead on one worker thread,
    so the host-to-device copy of batch N+1 overlaps step N.

    ``consumed_state()`` is the source's ``state_dict`` as of the last batch
    handed to the caller; ``reset()`` drops the lookahead after the source
    was rewound (a restore or rollback ``load_state_dict``), so stale staged
    batches never reach the loop.
    """

    def __init__(self, source, stage: Callable[[Dict[str, np.ndarray]], Any], depth: int = 0):
        self.source = source
        self.stage = stage
        self.depth = depth
        self._it = iter(source)
        self._queue: collections.deque = collections.deque()
        self._consumed = source.state_dict()
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="batch-stager") if depth > 0 else None)

    def _submit(self) -> None:
        host = next(self._it)
        state_after = self.source.state_dict()
        self._queue.append((self._pool.submit(self.stage, host), state_after))

    def __iter__(self):
        return self

    def __next__(self):
        if self.depth == 0:
            host = next(self._it)
            self._consumed = self.source.state_dict()
            return self.stage(host)
        while len(self._queue) < self.depth + 1:
            self._submit()
        fut, state_after = self._queue.popleft()
        self._consumed = state_after
        return fut.result()

    def consumed_state(self) -> Dict[str, int]:
        return dict(self._consumed)

    def reset(self) -> None:
        """Drop the lookahead after the source was rewound externally."""
        for fut, _ in self._queue:
            fut.cancel()
        self._queue.clear()
        self._consumed = self.source.state_dict()

    def close(self) -> None:
        self.reset()
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def pipeline_forward(layer_fn: Callable, stage_params, x_micro: torch.Tensor, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run M microbatches through S pipeline stages, S the size of ``mesh``'s
    ``axis``; every rank of the axis calls it and runs one stage.

    ``layer_fn(params, x) -> x`` is one stage's computation. ``stage_params``
    is a tree (dicts, lists, tuples) whose leaves have a leading (S,) stage
    axis: the rank at index ``s`` along ``axis`` runs stage ``s`` on its
    slice. ``x_micro`` (M, mb, ...) is the same on every rank; stage 0
    consumes it. On each of the S + M − 1 ticks stage 0 takes microbatch t
    (zeros once they run out), every stage applies ``layer_fn``, the last
    stage keeps output t − (S − 1), and the buffer moves one stage along
    the ring (``Mesh.ppermute``; the last tick's move is dropped, as
    nothing reads it). Returns the (M, mb, ...) outputs of the last stage
    on every rank: broadcast from it, which equals JAX's psum over the
    stages whose outputs are zeroed, bit for bit.
    """
    S = mesh.size(axis)
    M = x_micro.shape[0]
    ticks = S + M - 1
    stage = mesh.axis_index(axis)
    leaves, rebuild = flatten_tree(stage_params)
    p_local = rebuild([leaf[stage] for leaf in leaves])
    ring = [(i, (i + 1) % S) for i in range(S)]
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(ticks):
        if stage == 0:
            buf = x_micro[t] if t < M else torch.zeros_like(buf)
        buf = layer_fn(p_local, buf)
        if stage == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = buf
        if t < ticks - 1:
            buf = mesh.ppermute(buf, axis, ring)
    return mesh.broadcast(outs, axis, S - 1)


def pipeline_bubble_fraction(num_stages: int, num_micro: int) -> float:
    """Idle fraction of the GPipe schedule: (S − 1)/(S + M − 1)."""
    return (num_stages - 1) / (num_stages + num_micro - 1)
