"""Selection execution engines: single-batch, multi-batch and sharded
data-parallel.

All speak the Sampler-v2 protocol: every path threads the sampler's
*carry* (its cross-step state) and returns ``(SelectionState, carry')``;
stateless samplers carry ``{}`` untouched.

  * :func:`select_batch` — one (K, R_max) batch.
  * :func:`select_multi_batch` — a stack of B microbatches. GRAFT under
    ``use_pallas`` runs the whole stack as ONE launch of the batched kernel
    (``kernels/graft_select.py:graft_select_batched``); every other sampler
    runs a loop over the B lanes, the JAX ``vmap``. A stateful sampler's
    carry gets a leading B axis (B independent streams).
  * :func:`make_sharded_selector` / :func:`select_sharded` — selection over
    the data-parallel axes of a port ``Mesh`` (``backend/mesh.py``): the
    batch is split along K over the mesh axes ``act_batch`` maps to
    (``distributed/sharding.py``), each rank passes its own rows and runs
    the sampler on them. For GRAFT the prefix projection errors are
    averaged across shards, so every shard applies the same R*; the other
    samplers run against the averaged global ḡ, and a stateful carry is
    kept replicated by averaging. Every rank gets the global state.

``select_batch`` and ``select_multi_batch`` are plain functions: PyTorch
runs eagerly, so there is no compile cache to key. The sharded selector is
cached per (cfg, sampler, mesh, batch_logical, rules), as JAX caches its
jitted one. ``carry=None`` means "initialize a fresh carry from the input
shapes". ``key``/``keys`` (``torch.Generator``s) are passed to the sampler
per lane; when a stochastic sampler gets none, one is derived from ``step``
(``base.default_select_generator``, one per lane for a stack, one per
shard for the sharded engine).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.backend.mesh import Mesh
from repro_torch.core import projection as proj_lib
from repro_torch.core.numerics import device_scalar
from repro_torch.distributed import sharding as sh
from repro_torch.selection import graft as graft_lib
from repro_torch.selection import registry
from repro_torch.selection.base import (Carry, CarrySpec, GraftConfig, Sampler,
                                        SelectionInputs, SelectionState,
                                        default_select_generator, lane_generators,
                                        shard_generator)

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
                                         grad_dim=int(G.shape[-2]), device=V.device))


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
                 scores: Optional[torch.Tensor] = None,
                 key: Optional[torch.Generator] = None, carry: Carry = None, step=0):
    """Run ``sampler`` on one (K, R_max) batch. Returns ``(SelectionState,
    carry')``; feed ``carry'`` back in to stream across calls."""
    smp = _resolve(cfg, sampler, scores)
    if scores is None:
        scores = torch.zeros(V.shape[0], dtype=torch.float32, device=V.device)
    if key is None and smp.needs_key:
        key = default_select_generator(step)
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
    ``scores``: (B, K) and ``keys``: per-lane generators (``keys[b]``).
    Returns ``(SelectionState, carry')`` whose leaves carry a leading B axis
    — the same as a Python loop of :func:`select_batch` calls. A stateful
    sampler's carry is B-stacked (``carry=None`` broadcasts one fresh carry
    across the stack).
    """
    smp = _resolve(cfg, sampler, scores)
    B = V.shape[0]
    if scores is None:
        scores = torch.zeros(V.shape[:2], dtype=torch.float32, device=V.device)
    if keys is None and smp.needs_key:
        keys = lane_generators(step, B)
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
# sharded (data-parallel) selection
# ---------------------------------------------------------------------------

def _as_mesh(mesh_or_backend) -> Mesh:
    """Accept a backend anywhere a mesh is expected: its ``mesh()``."""
    if isinstance(mesh_or_backend, Mesh):
        return mesh_or_backend
    getter = getattr(mesh_or_backend, "mesh", None)
    return getter() if callable(getter) else mesh_or_backend


def _batch_axes(mesh: Mesh, batch_logical: str, rules) -> Tuple[str, ...]:
    """Mesh axis names the logical rule table maps ``batch_logical`` to."""
    entry = sh.logical_to_spec((batch_logical,), mesh, rules)[0]
    if entry is None:
        raise ValueError(
            f"logical axis '{batch_logical}' maps to no axis of mesh "
            f"{mesh.axis_names}; nothing to shard selection over")
    return (entry,) if isinstance(entry, str) else tuple(entry)


def make_sharded_selector(cfg: GraftConfig, mesh, *, sampler: SamplerLike = "graft",
                          batch_logical: str = "act_batch", rules=None):
    """Build (or fetch the cached) data-parallel selector over ``mesh`` (a
    port ``Mesh`` or a backend).

    Returns ``fn(V, G, step=0, *, scores=None, carry=None) -> (SelectionState,
    carry')``, which every rank of the mesh calls with ITS OWN rows: V
    (K_local, R_max), G (d, K_local) and scores (K_local,), its shard of the
    batch along the mesh axes ``batch_logical`` maps to (n_shards of them).
    Per shard the sampler runs on the local rows against the pmean'd global
    ḡ; for GRAFT the prefix projection errors are pmean'd as well, so the
    rank decision R* is equal on every shard. Every rank gets the GLOBAL
    state, all-gathered along the batch axes: pivots and weights of shape
    (n_shards·R_max,), pivots as global row indices (shard s's rows offset
    by s·K_local), weights summing to 1 over the active entries; ``rank`` is
    the per-shard R*. A stateful carry stays replicated: float leaves are
    pmean'd, integer leaves pmax'd. Ranks holding unequal K_local, or fewer
    rows than ``r_max``, raise ``ValueError`` on every rank.

    The selector is cached on (cfg, sampler, mesh, batch_logical, rules), as
    the JAX engine caches its jitted one.
    """
    smp = registry.get_sampler(sampler)
    rules_key = tuple(sorted(rules.items())) if rules else None
    return _sharded_selector_cached(cfg, smp, _as_mesh(mesh), batch_logical, rules_key)


@functools.lru_cache(maxsize=64)
def _sharded_selector_cached(cfg: GraftConfig, smp: Sampler, mesh: Mesh,
                             batch_logical: str, rules_key):
    rules = dict(rules_key) if rules_key else None
    axes = _batch_axes(mesh, batch_logical, rules)
    n_shards = mesh.size(axes)
    shard = mesh.axis_index(axes)           # global shard index, first axis major
    r_max = cfg.r_max

    def sync_carry(carry):
        # keep the carry replicated: shard-local updates averaged (float
        # leaves) or maxed (integer leaves); a stateless {} passes through
        return _tree_map(lambda leaf: mesh.pmean(leaf, axes) if leaf.is_floating_point()
                         else mesh.pmax(leaf, axes), carry)

    if smp.fn is graft_lib.graft_sampler_fn:
        # GRAFT: the globally synchronized rank decision
        def shard_fn(V_s, G_s, scores_s, carry, step):
            K_local = V_s.shape[0]
            g_bar = mesh.pmean(torch.mean(G_s, dim=1), axes)          # global ḡ
            # the local refresh: ONE graft_select launch under use_pallas,
            # then the error statistics pmean'd, so R* is equal on every shard
            pivots, local_errors, G_sel = graft_lib.pivot_and_sweep(cfg, V_s, G_s, g_bar)
            errors = mesh.pmean(local_errors, axes)
            rank, err = proj_lib.select_rank(errors, cfg.rset, cfg.eps)
            active = (torch.arange(r_max, device=errors.device) < rank).to(torch.float32)
            weights = active / torch.clamp(n_shards * active.sum(), min=1.0)
            g_sub = mesh.psum(G_sel.to(torch.float32) @ weights, axes)   # global subset ḡ
            align = proj_lib.cosine_alignment(g_sub, g_bar)
            state = SelectionState(
                pivots=(pivots + shard * K_local).to(torch.int32), weights=weights,
                rank=rank, last_error=err, alignment=align,
                step=device_scalar(step, torch.int32, V_s.device))
            return state, carry
    else:
        def shard_fn(V_s, G_s, scores_s, carry, step):
            K_local = V_s.shape[0]
            g_bar = mesh.pmean(torch.mean(G_s, dim=1), axes)          # global ḡ
            # a generator of its own for each shard, so that stochastic
            # samplers draw independent rows
            key = shard_generator(step, shard) if smp.needs_key else None
            state, carry = smp.select(
                cfg, SelectionInputs(V_s, G_s, g_bar, scores_s, key), carry, step)
            state = SelectionState(
                pivots=(state.pivots + shard * K_local).to(torch.int32),
                weights=state.weights / n_shards,      # global sum 1 over n_shards
                rank=mesh.pmax(state.rank, axes),
                last_error=mesh.pmean(state.last_error, axes),
                alignment=mesh.pmean(state.alignment, axes),
                step=device_scalar(step, torch.int32, V_s.device))
            return state, sync_carry(carry)

    def selector(V, G, step=0, *, scores=None, carry=None):
        if smp.needs_scores and scores is None:
            raise ValueError(
                f"sampler '{smp.name}' requires SelectionInputs.scores — "
                f"pass scores=... (engine paths fill defaults only for "
                f"samplers that do not declare needs_scores)")
        K_local = int(V.shape[0])
        # the first collective of every call: the shards must be equal (the
        # JAX engine's "not divisible" check), or every rank refuses
        sizes = mesh.gather_ints(K_local, axes)
        if len(set(sizes)) != 1:
            raise ValueError(f"ranks along {axes} hold unequal shards of the batch "
                             f"({sizes} rows); the batch must split evenly over "
                             f"{n_shards} shards")
        if K_local < r_max:
            raise ValueError(f"per-shard batch {K_local} < r_max {r_max}")
        if scores is None:
            scores = torch.zeros(K_local, dtype=torch.float32, device=V.device)
        if carry is None:
            carry = smp.init_carry(cfg, CarrySpec(batch_size=K_local * n_shards,
                                                  grad_dim=int(G.shape[-2]), device=V.device))
        state, carry = shard_fn(V, G, scores, carry, step)
        state = state._replace(pivots=mesh.all_gather(state.pivots, axes),
                               weights=mesh.all_gather(state.weights, axes))
        return state, carry

    return selector


def select_sharded(cfg: GraftConfig, mesh, V: torch.Tensor, G: torch.Tensor, *,
                   sampler: SamplerLike = "graft", scores: Optional[torch.Tensor] = None,
                   carry: Carry = None, step=0, batch_logical: str = "act_batch",
                   rules=None):
    """One call of :func:`make_sharded_selector`'s selector: this rank's
    rows ``V`` (K_local, R_max), ``G`` (d, K_local) → the global
    ``(SelectionState, carry')``."""
    return make_sharded_selector(cfg, mesh, sampler=sampler, batch_logical=batch_logical,
                                 rules=rules)(V, G, step, scores=scores, carry=carry)


__all__ = ["select_batch", "select_multi_batch", "make_sharded_selector",
           "select_sharded"]
