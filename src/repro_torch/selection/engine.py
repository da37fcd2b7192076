"""Selection execution engines: single-batch and multi-batch.

Both speak the Sampler-v2 protocol: every path threads the sampler's
*carry* (its cross-step state) and returns ``(SelectionState, carry')``;
stateless samplers carry ``{}`` untouched.

  * :func:`select_batch` — one (K, R_max) batch.
  * :func:`select_multi_batch` — a stack of B microbatches. GRAFT under
    ``use_pallas`` runs the whole stack as ONE launch of the batched kernel
    (``kernels/graft_select.py:graft_select_batched``); every other sampler
    runs a loop over the B lanes, the JAX ``vmap``. A stateful sampler's
    carry gets a leading B axis (B independent streams).

These are plain functions: PyTorch runs eagerly, so there is no compile
cache to key. ``carry=None`` means "initialize a fresh carry from the input
shapes". ``key``/``keys`` are passed through to the sampler per lane; no
sampler of the port draws random numbers, so none is derived when they are
left ``None``. The sharded engine (``make_sharded_selector``,
``select_sharded``) waits for the port's distributed backend (ROADMAP A11).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from repro_torch.selection import graft as graft_lib
from repro_torch.selection import registry
from repro_torch.selection.base import (Carry, CarrySpec, GraftConfig, Sampler,
                                        SelectionInputs)

SamplerLike = Union[str, Sampler]


def _resolve(cfg: GraftConfig, sampler: SamplerLike, scores) -> Sampler:
    smp = registry.get_sampler(sampler)
    if smp.needs_scores and scores is None:
        # the engine fills defaults only for samplers that do not need them
        raise ValueError(
            f"sampler '{smp.name}' requires SelectionInputs.scores — "
            f"pass scores=... (engine paths fill defaults only for "
            f"samplers that do not declare needs_scores)")
    return smp


def _fresh_carry(smp: Sampler, cfg: GraftConfig, V: torch.Tensor,
                 G: torch.Tensor) -> Carry:
    return smp.init_carry(cfg, CarrySpec(batch_size=int(V.shape[-2]),
                                         grad_dim=int(G.shape[-2])))


def _tree_map(fn: Callable[..., Any], tree, *rest):
    """Map ``fn`` over the tensor leaves of dicts, lists, tuples and
    NamedTuples (the carry pytrees of the samplers)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def _stack_trees(trees):
    """Stack a list of same-structured pytrees on a new leading axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


# ---------------------------------------------------------------------------
# single batch
# ---------------------------------------------------------------------------

def select_batch(cfg: GraftConfig, sampler: SamplerLike, V: torch.Tensor,
                 G: torch.Tensor, g_bar: torch.Tensor, *,
                 scores: Optional[torch.Tensor] = None, key: Any = None,
                 carry: Carry = None, step=0):
    """Run ``sampler`` on one (K, R_max) batch. Returns ``(SelectionState,
    carry')``; feed ``carry'`` back in to stream across calls."""
    smp = _resolve(cfg, sampler, scores)
    if scores is None:
        scores = torch.zeros(V.shape[0], dtype=torch.float32, device=V.device)
    if carry is None:
        carry = _fresh_carry(smp, cfg, V, G)
    return smp.select(cfg, SelectionInputs(V, G, g_bar, scores, key), carry, step)


# ---------------------------------------------------------------------------
# multi-batch
# ---------------------------------------------------------------------------

def select_multi_batch(cfg: GraftConfig, sampler: SamplerLike, V: torch.Tensor,
                       G: torch.Tensor, g_bar: torch.Tensor, *,
                       scores: Optional[torch.Tensor] = None, keys: Any = None,
                       carry: Carry = None, step=0):
    """Select for a STACK of microbatches.

    ``V``: (B, K, R_max); ``G``: (B, d, K); ``g_bar``: (B, d); optional
    ``scores``: (B, K) and ``keys``: per-lane keys (indexed ``keys[b]``).
    Returns ``(SelectionState, carry')`` whose leaves carry a leading B axis
    — the same as a Python loop of :func:`select_batch` calls. A stateful
    sampler's carry is B-stacked (``carry=None`` broadcasts one fresh carry
    across the stack).
    """
    smp = _resolve(cfg, sampler, scores)
    B = V.shape[0]
    if scores is None:
        scores = torch.zeros(V.shape[:2], dtype=torch.float32, device=V.device)
    if carry is None:
        carry = _tree_map(lambda x: x.expand((B,) + tuple(x.shape)),
                          _fresh_carry(smp, cfg, V, G))
    if cfg.use_pallas and smp.fn is graft_lib.graft_sampler_fn:
        # the GRAFT fast path: the whole stack in ONE batched kernel launch
        return graft_lib.graft_select_batched(cfg, V, G, g_bar, step), carry
    states, carries = [], []
    for b in range(B):
        st, c = smp.select(
            cfg, SelectionInputs(V[b], G[b], g_bar[b], scores[b],
                                 None if keys is None else keys[b]),
            _tree_map(lambda x: x[b], carry), step)
        states.append(st)
        carries.append(c)
    return graft_lib.stack_states(states), _stack_trees(carries)


# ---------------------------------------------------------------------------
# sharded selection (not ported)
# ---------------------------------------------------------------------------

def make_sharded_selector(cfg: GraftConfig, mesh, *, sampler: SamplerLike = "graft",
                          batch_logical: str = "act_batch", rules=None):
    """Not ported: needs the distributed backend (ROADMAP A11)."""
    raise NotImplementedError(
        "make_sharded_selector (data-parallel selection over a mesh) is not "
        "ported to repro_torch yet: it waits for the distributed backend "
        "(see ROADMAP.md, A11)")


def select_sharded(cfg: GraftConfig, mesh, V: torch.Tensor, G: torch.Tensor, *,
                   sampler: SamplerLike = "graft", scores=None, carry: Carry = None,
                   step=0, batch_logical: str = "act_batch", rules=None):
    """Not ported: needs the distributed backend (ROADMAP A11)."""
    raise NotImplementedError(
        "select_sharded (data-parallel selection over a mesh) is not ported "
        "to repro_torch yet: it waits for the distributed backend (see "
        "ROADMAP.md, A11)")


__all__ = ["select_batch", "select_multi_batch", "make_sharded_selector",
           "select_sharded"]
