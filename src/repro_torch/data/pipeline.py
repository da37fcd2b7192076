"""Deterministic synthetic data pipelines (no external datasets offline).

A copy of the JAX package's pure-numpy LM pipeline: ``batch_at(step)`` is
byte-identical to ``repro.data.pipeline.SyntheticLM.batch_at``. Batches are
numpy; the train loop moves them to the device.

  * host-sharded: each data-parallel host generates only its slice of the
    global batch (seeded by (seed, step, global example index));
  * resumable: a batch is a function of its step alone;
  * learnable: sequences follow a hidden Markov chain over token clusters
    with Zipfian unigrams, so models reduce loss and selection methods
    differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np


class ArraySpec(NamedTuple):
    """Shape/dtype of one batch entry."""
    shape: Tuple[int, ...]
    dtype: np.dtype


class DataSourceBase:
    """Shared protocol of every data source: ``spec()`` declares the local
    batch layout, ``batch_at(step)``/``__call__(step)`` produce the
    host-local shard, and the resumable iterator's state is one integer
    (``state_dict``, checkpointed beside the train state)."""

    cfg: "object"
    _step: int = 0

    def spec(self) -> Dict[str, ArraySpec]:
        raise NotImplementedError

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        return self.batch_at(step)

    # ---- resumable iterator state (one integer) ----
    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self._step)
            self._step += 1
            yield b

    def microbatch_stack(self, step: int, num_micro: int) -> Dict[str, np.ndarray]:
        """``num_micro`` consecutive batches stacked on a new leading axis —
        the input layout of the multi-batch selection path
        (``repro_torch.selection.engine.select_multi_batch``): one call
        selects for every microbatch at once. A function of ``step`` alone:
        no iterator state moves."""
        stack = [self.batch_at(step + i) for i in range(num_micro)]
        return {k: np.stack([b[k] for b in stack]) for k in stack[0]}


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 128
    global_batch: int = 32
    seed: int = 0
    num_clusters: int = 16         # hidden-state count of the Markov source
    cluster_stickiness: float = 0.8
    # host sharding
    num_hosts: int = 1
    host_index: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not divide "
                             f"over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


class SyntheticLM(DataSourceBase):
    """Markov-over-clusters token source; ``batch_at(step)`` → local batch."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        C, V = cfg.num_clusters, cfg.vocab_size
        # sticky transition matrix between clusters
        trans = root.random((C, C)) + np.eye(C) * (
            cfg.cluster_stickiness * C / (1 - cfg.cluster_stickiness + 1e-9))
        self.trans = trans / trans.sum(1, keepdims=True)
        # per-cluster Zipfian token distributions over disjoint-ish supports
        zipf = 1.0 / np.arange(1, V + 1, dtype=np.float64)
        tokens = []
        for c in range(C):
            perm = np.random.default_rng(cfg.seed * 1000 + c).permutation(V)
            p = zipf[np.argsort(perm)]
            tokens.append(p / p.sum())
        self.cluster_tokens = np.stack(tokens)                 # (C, V)
        # precomputed CDFs: token sampling is a binary search
        self._tok_cdf = np.cumsum(self.cluster_tokens, axis=1)
        self._trans_cdf = np.cumsum(self.trans, axis=1)

    def spec(self) -> Dict[str, ArraySpec]:
        B, S = self.cfg.local_batch, self.cfg.seq_len
        return {"tokens": ArraySpec((B, S), np.dtype(np.int32)),
                "labels": ArraySpec((B, S), np.dtype(np.int32))}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for ``step`` (local shard only)."""
        cfg = self.cfg
        B, S = cfg.local_batch, cfg.seq_len
        start = step * cfg.global_batch + cfg.host_index * B
        tokens = np.empty((B, S + 1), dtype=np.int32)
        V = cfg.vocab_size
        for i in range(B):
            # per-GLOBAL-example stream ⇒ identical data for any host count
            g = np.random.default_rng((cfg.seed, 0x5EED, step, start + i))
            u_tok = g.random(S + 1)
            u_cl = g.random(S + 1)
            c = int(g.integers(cfg.num_clusters))
            for t in range(S + 1):
                tokens[i, t] = min(np.searchsorted(self._tok_cdf[c], u_tok[t]), V - 1)
                c = min(int(np.searchsorted(self._trans_cdf[c], u_cl[t])),
                        cfg.num_clusters - 1)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
