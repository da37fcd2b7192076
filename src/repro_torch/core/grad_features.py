"""Per-sample gradient embeddings for GRAFT's rank-selection stage.

Only the ``probe`` path is ported: ``logit_error_embeddings``, a per-sample
gradient surrogate from the softmax error signal with no extra backward.
The exact per-sample gradients (``per_sample_grads_full``/``_probe`` of the
JAX package, via ``torch.func``) wait for a later slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

import torch


def logit_error_embeddings(logits: torch.Tensor, labels: torch.Tensor,
                           hiddens: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cheap per-sample gradient embedding without any extra backward.

    ``e_k = ℓ_k · Σ_s w_{k,s} h_{k,s}``: the loss-scaled pooled hidden,
    pooled with weights proportional to the residual error norm
    ``‖p − y‖`` at each position. Shapes: logits (K,S,V) or (K,V); labels
    (K,S) or (K,); hiddens (K,S,E) or (K,E). Returns (K,E) float32.

    ``mask`` (K,S) restricts the error signal to labeled positions; ``None``
    means all positions count.
    """
    if logits.ndim == 2:
        logits, labels, hiddens = logits[:, None, :], labels[:, None], hiddens[:, None, :]
        mask = None if mask is None else mask[:, None]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    err = torch.exp(logp)                                   # p
    idx = labels.long()[..., None]
    err.scatter_add_(-1, idx, torch.full_like(idx, -1.0, dtype=err.dtype))  # p − y
    err_norm = torch.sqrt(torch.sum(err * err, dim=-1))     # (K,S)
    del err
    loss = -torch.gather(logp, -1, idx)[..., 0]             # (K,S)
    if mask is not None:
        m = mask.to(torch.float32)
        err_norm = err_norm * m
        scale = (torch.sum(loss * m, dim=-1, keepdim=True) /
                 torch.clamp(torch.sum(m, dim=-1, keepdim=True), min=1.0))
    else:
        scale = torch.mean(loss, dim=-1, keepdim=True)
    w = err_norm / (torch.sum(err_norm, dim=-1, keepdim=True) + 1e-9)
    pooled = torch.einsum("ks,kse->ke", w, hiddens.to(torch.float32))
    return pooled * scale
