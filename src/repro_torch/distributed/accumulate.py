"""Microbatch gradient accumulation, the twin of the JAX package's
``repro/distributed/accumulate.py``.

The JAX package scans over the microbatches inside one jitted step, so that
live activation memory is one microbatch's; the port loops over them
eagerly with one backward each, which bounds it the same way. The sums run
in each parameter's dtype (bf16 leaves accumulate in bf16, float32 leaves
in float32), in microbatch order from zeros, as the JAX scan does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

Batch = Dict[str, torch.Tensor]


def split_microbatches(batch: Batch, num_micro: int) -> List[Batch]:
    """(B, ...) leaves → ``num_micro`` batches of B / num_micro rows, in
    order (the JAX package's ``reshape(num_micro, B // num_micro, ...)``)."""
    out: List[Batch] = [{} for _ in range(num_micro)]
    for name, x in batch.items():
        b = x.shape[0]
        if b % num_micro:
            raise ValueError(f"batch {b} not divisible by {num_micro} microbatches")
        for i, part in enumerate(x.reshape(num_micro, b // num_micro, *x.shape[1:])):
            out[i][name] = part
    return out


def accumulated_grads(loss_fn: Callable[[Batch], torch.Tensor],
                      params: Sequence[torch.Tensor], batch: Batch, num_micro: int
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Mean loss and mean grads of ``params`` over ``num_micro`` sequential
    microbatches: ``loss_fn(microbatch)`` is the scalar loss. Each mean is
    taken as ``(sum.f32 · (1/n)).to(param dtype)``."""
    loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
    grad_sum = [torch.zeros(p.shape, dtype=p.dtype, device=p.device) for p in params]
    for mb in split_microbatches(batch, num_micro):
        loss = loss_fn(mb)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        for acc, g in zip(grad_sum, grads):
            acc.add_(g.to(acc.dtype))
        loss_sum = loss_sum + loss.detach()
        del grads
    inv = 1.0 / num_micro
    grads = [(g.to(torch.float32) * inv).to(p.dtype) for g, p in zip(grad_sum, params)]
    return loss_sum * inv, grads
