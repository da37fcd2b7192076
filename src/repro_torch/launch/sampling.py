"""Token sampling for the serving path: temperature, top-k, top-p — the port
of the JAX package's ``launch/sampling.py``.

The draw is ``argmax(logits + Gumbel noise)``, which is how
``jax.random.categorical`` draws; the noise comes from an explicit
``torch.Generator``. ``filter_logits`` and ``gumbel_argmax`` are the two
halves, so that a caller can add noise of its own.
"""
from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """(B, V) logits → float32 logits divided by the temperature, with −inf
    below the k-th largest (``top_k``), then outside the smallest prefix of
    the sorted distribution whose mass reaches ``top_p``."""
    logits = logits.to(torch.float32) / max(temperature, 1e-6)
    V = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k is not None and top_k < V:
        kth = torch.sort(logits, dim=-1).values[:, V - top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # at most V - 1: where rounding keeps the whole mass below top_p, the
        # cut keeps everything (JAX's out-of-range gather gives NaN, which
        # masks nothing either)
        cutoff_idx = torch.clamp(torch.sum((cum < top_p).to(torch.int64), dim=-1), max=V - 1)
        cutoff_val = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff_val, neg_inf, logits)
    return logits


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise −log(−log U), U uniform in [tiny, 1), float32."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_argmax(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The categorical draw of (B, V) ``logits`` under ``noise`` → (B,) int32."""
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def sample_tokens(generator: torch.Generator, logits: torch.Tensor,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """logits: (B, V) → token ids (B,) int32. Temperature 0 is greedy; top_k
    and top_p compose (k first, then p). The noise is drawn from
    ``generator``, which must live on the logits' device."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    masked = filter_logits(logits, temperature, top_k, top_p)
    return gumbel_argmax(masked, gumbel(generator, masked.shape, masked.device))
