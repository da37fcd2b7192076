"""Batch staging ahead of the dispatch loop — the ``BatchStager`` of the
JAX package's ``distributed/pipeline.py``. (Its GPipe ``pipeline_forward``
is not ported yet: ``ROADMAP.md``, A10b.)

:class:`BatchStager` turns host batches into the backend's device batches
(``Backend.shard_batch``) with optional lookahead, while keeping the data
source's one-integer resumable state accounted to the batch actually
CONSUMED: what a checkpoint must record, since a prefetched but unconsumed
batch must replay after a resume.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Any, Callable, Dict

import numpy as np


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
