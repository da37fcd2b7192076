"""Held-out evaluation over a fixed synthetic eval stream — the port of the
JAX package's ``launch/evaluate.py``.

The eval stream is the same registered data source read at a step offset
the training loop never reaches (``EVAL_STEP_OFFSET``): drawn from the
training distribution, never overlapping the train stream. ``lm`` sources
report loss and perplexity. The classification eval waits for
``synthetic_classification`` (``ROADMAP.md``).

Every factory returns an :class:`EvalFn` with a dispatch/collect split:
``dispatch(model)`` enqueues the per-batch forwards and the mean on the
current CUDA stream and returns device scalars without syncing the host;
``collect(handle)`` reads them. Calling the object does both. Dispatching
on the training stream orders the eval's reads of the parameters before
the next step's in-place update, so no copy of the parameters is needed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.data import sources as data_sources
from repro_torch.launch.metrics import materialize_metrics
from repro_torch.models import model as model_lib

# step offset of the held-out slice of the stream: training reaches step
# indices 0..steps, eval reads from 7.7M up — disjoint per-example streams
EVAL_STEP_OFFSET = 7_777_777


class EvalFn:
    """Held-out eval with an explicit dispatch/collect split."""

    def __init__(self, dispatch_fn: Callable[[Any], Dict[str, torch.Tensor]]):
        self._dispatch = dispatch_fn

    def dispatch(self, model) -> Dict[str, torch.Tensor]:
        """Enqueue the full eval; returns device scalars, never blocks."""
        return self._dispatch(model)

    @staticmethod
    def collect(handle: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Read a dispatched handle to host floats (blocks)."""
        return materialize_metrics(handle)

    def __call__(self, model) -> Dict[str, float]:
        return self.collect(self.dispatch(model))


def make_eval_fn(mcfg: model_lib.ModelConfig, batch: int, seq: int,
                 seed: int = 0, num_batches: int = 4, device=None) -> EvalFn:
    """LM-source eval from explicit sizes (for ad-hoc scripts)."""
    data = SyntheticLM(DataConfig(vocab_size=mcfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    return _lm_eval(mcfg, [data.batch_at(EVAL_STEP_OFFSET + i)
                           for i in range(num_batches)], device)


def _lm_eval(mcfg: model_lib.ModelConfig, eval_batches, device) -> EvalFn:
    staged = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
              for b in eval_batches]                     # staged once

    @torch.no_grad()
    def dispatch(model) -> Dict[str, torch.Tensor]:
        mean = torch.mean(torch.stack([model_lib.loss_fn(mcfg, model, b)[0]
                                       for b in staged]))
        return {"eval_loss": mean, "eval_ppl": torch.exp(mean)}

    return EvalFn(dispatch)


def _classification_eval(mcfg, eval_batches, device) -> EvalFn:
    raise NotImplementedError(
        "the classification eval needs the synthetic_classification source, "
        "which is not ported to repro_torch yet (see ROADMAP.md)")


def make_eval_fn_for(experiment, mcfg: model_lib.ModelConfig,
                     num_batches: int = 4, device=None) -> EvalFn:
    """Eval fn for an ``ExperimentConfig``: ≤ 8 examples a batch, read
    from the held-out offset of the experiment's own data source — the one
    place that owns the eval-batch policy, as in the JAX package."""
    dcfg = experiment.finalized().data
    entry = data_sources.entry_for_config(dcfg)
    eval_cfg = dataclasses.replace(
        dcfg, global_batch=min(dcfg.global_batch, 8), num_hosts=1, host_index=0)
    data = entry.build(eval_cfg)
    eval_batches = [data.batch_at(EVAL_STEP_OFFSET + i) for i in range(num_batches)]
    if entry.task.kind == "classification":
        return _classification_eval(mcfg, eval_batches, device)
    return _lm_eval(mcfg, eval_batches, device)
