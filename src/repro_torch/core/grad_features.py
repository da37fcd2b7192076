"""Per-sample gradient embeddings for GRAFT's rank-selection stage.

* ``per_sample_grads_full`` — exact per-sample gradients of the whole
  parameter pytree, one ``torch.autograd.grad`` per example, so that the
  model's attention and recurrence kernels (autograd Functions with no
  functorch rule) run. Alg. 1 literally; for small models and as the oracle
  in tests.
* ``per_sample_grads_probe`` — the same restricted to a small probe
  parameter set (classifier head / final norm) over frozen trunk hiddens.
* ``logit_error_embeddings`` — a per-sample gradient surrogate from the
  softmax error signal with no extra backward (the ``probe`` source).

A gradient pytree flattens in the JAX package's leaf order
(``jax.tree_util.tree_leaves``: dict keys sorted), with the port's
``blocks`` list of per-block dicts read as the JAX tree's blocks stacked on
a leading axis (``first_blocks`` stays a list, as in the JAX tree).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core.numerics import one_hot_valid, take_last


def _jax_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a params-shaped tree in ``jax.tree_util.tree_leaves``
    order: dict keys sorted; the list of per-block dicts under ``blocks``
    becomes one dict of leaves stacked on a new axis 0."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_leaves(
            _stack(tree[k]) if k == "blocks" and isinstance(tree[k], (list, tuple))
            else tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _jax_leaves(v)]
    raise TypeError(f"unexpected pytree node {type(tree).__name__}")


def _stack(items):
    """A list of same-keyed dicts as one dict of leaves stacked on axis 0."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def _flatten_pytree(tree) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in _jax_leaves(tree)])


def _tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return [_tree_map(fn, v) for v in tree]


def per_sample_grads_full(loss_fn: Callable, params, batch
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-sample gradient matrix G ∈ R^{d×K} + batch mean ḡ ∈ R^d.

    ``loss_fn(params, example) → scalar`` for ONE example; ``batch`` is a
    dict whose tensors have a leading K axis. Each example's gradient is
    one ``torch.autograd.grad`` through the model as configured, so a
    flash or RWKV model differentiates through its kernels. ``params`` is
    not touched: the gradients are taken w.r.t. detached copies."""
    live = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, live)
    K = next(iter(batch.values())).shape[0]
    rows = []
    with torch.enable_grad():
        for k in range(K):
            loss = loss_fn(live, {n: v[k] for n, v in batch.items()})
            grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
            rows.append(_flatten_pytree(_tree_map(
                lambda t: _or_zeros(next(grads), t), live)))
    G = torch.stack(rows)                                           # (K, d)
    return G.T, G.mean(dim=0)


def _or_zeros(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like) if g is None else g


def per_sample_grads_probe(head_loss_fn: Callable, probe_params: Any,
                           hiddens: torch.Tensor, labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample gradients w.r.t. the probe params only:
    ``head_loss_fn(probe_params, hidden, label) → scalar`` for ONE example.
    Returns (G d×K, ḡ d)."""
    grad_fn = torch.func.grad(head_loss_fn)
    G = torch.func.vmap(lambda h, y: _flatten_pytree(grad_fn(probe_params, h, y)))(
        hiddens, labels)
    return G.T, G.mean(dim=0)


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
    idx, valid = one_hot_valid(labels, err.shape[-1])
    err.scatter_add_(-1, idx[..., None],                    # p − y
                     torch.where(valid, -1.0, 0.0).to(err.dtype)[..., None])
    err_norm = torch.sqrt(torch.sum(err * err, dim=-1))     # (K,S)
    del err
    loss = -take_last(logp, labels)                         # (K,S)
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
