"""A named device mesh over the execution backend's ranks, with the
collectives that ``jax.lax`` gives a ``shard_map`` body — the port's
counterpart of ``jax.make_mesh`` and of ``Backend.mesh()``.

Eager PyTorch has no ``shard_map``: each rank runs its own shard's code and
makes the collectives itself. A :class:`Mesh` lays the backend's ranks out
on named axes, first axis major (rank ``r`` sits at the coordinates of
``np.unravel_index(r, shape)``), and reduces, gathers and permutes over any
tuple of those axes:

  * ``psum``, ``pmean``, ``pmax`` — all-reduces (``pmean`` is ``psum`` over
    the group size, as ``jax.lax.pmean`` is);
  * ``all_gather`` — every member's tensor concatenated along a dim (0 by
    default) in rank order along the axes, first axis major (0-d tensors
    are stacked);
  * ``psum_scatter`` — ``jax.lax.psum_scatter`` (tiled): the sum over the
    axes, cut along a dim, each member keeping its block (one
    ``reduce_scatter_tensor``);
  * ``broadcast`` — one member's tensor on every member;
  * ``ppermute`` — ``jax.lax.ppermute``'s ``(source, destination)`` pairs
    of indices along the axes; a member with no source gets zeros. Each
    rank posts one ``isend`` and one ``irecv`` together
    (``batch_isend_irecv``): a ring of blocking sends deadlocks on gloo.

``axis_index(axes)`` is this rank's index along ``axes``, first axis major,
as ``repro/selection/engine.py`` computes a shard's index from
``jax.lax.axis_index``.

The process groups of every tuple of axes are built when the mesh is made,
on every rank and in the same order (``torch.distributed.new_group`` is
itself a collective), never per call. Where the axes span one rank the
collectives are the identity and make no call: on the ``local`` backend
(every axis of size 1) a mesh adds no copy and no op. On gloo a CUDA tensor
is staged through host memory, as ``MultiProcessBackend`` stages its
reductions, and the collectives that only move data (``all_gather``,
``broadcast``, ``ppermute``) carry its bytes as uint8, which gloo moves for
every dtype, bit for bit (it refuses int16, for one).
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.sync_guard import sync_allowed

Axes = Union[str, Sequence[str]]


class Mesh:
    """Named axes over ``backend``'s ranks. Build it with :func:`make_mesh`
    (or ``Backend.mesh()``) on every rank alike."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], backend):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} must pair up, "
                             "each name once")
        world = backend.process_count
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} has {int(np.prod(shape))} "
                             f"positions for {world} rank(s)")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.backend = backend
        self.rank = backend.process_index
        self.ranks = np.arange(world).reshape(shape)       # rank at each coordinate
        self.coords: Dict[str, int] = dict(zip(
            axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        # (axes in mesh order) → (this rank's group, its members in rank order)
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        # host seconds of each ppermute that moved data (gloo's include the
        # staging through host memory)
        self.p2p_seconds: List[float] = []
        if world > 1:
            self._build_groups()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"

    # ------------------------------------------------------------- topology
    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not axes of the mesh {self.axis_names}")
        return axes

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes``."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)], dtype=np.int64))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, the first axis major."""
        index = 0
        for a in self._axes(axes):
            index = index * self.shape[a] + self.coords[a]
        return index

    def _build_groups(self) -> None:
        """One process group per position of the other axes, for every
        non-empty tuple of axes that spans more than one rank — on every
        rank, in the same order."""
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if self.size(axes) == 1:
                    continue
                # move the group's axes last, then each row is one group
                # whose members run first axis major along ``axes``
                order = [names.index(a) for a in names if a not in axes] + \
                        [names.index(a) for a in axes]
                rows = self.ranks.transpose(order).reshape(-1, self.size(axes))
                members = [[int(r) for r in row] for row in rows]
                group, _ = dist.new_subgroups_by_enumeration(members)
                mine = next(m for m in members if self.rank in m)
                self._groups[axes] = (group, mine)

    def _group(self, axes: Tuple[str, ...]):
        """This rank's group over ``axes`` and its members in rank order."""
        return self._groups[tuple(a for a in self.axis_names if a in axes)]

    # ----------------------------------------------------------------- wire
    def _wire(self, x: torch.Tensor, raw: bool = False) -> torch.Tensor:
        """A fresh contiguous buffer holding ``x`` where the collectives run
        (host memory for gloo); with ``raw``, its bytes on gloo."""
        buf = self.backend._wire(x.contiguous())
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
        if raw and self.backend.collectives == "gloo":
            buf = buf.reshape(-1).view(torch.uint8)
        return buf

    @staticmethod
    def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``buf`` as ``like``'s dtype and shape, on its device."""
        if buf.dtype != like.dtype:
            buf = buf.view(like.dtype).reshape(like.shape)
        return buf.to(like.device, non_blocking=True)

    # ---------------------------------------------------------- collectives
    def _all_reduce(self, x: torch.Tensor, axes: Axes, op) -> Optional[torch.Tensor]:
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return None
        group, _ = self._group(axes)
        buf = self._wire(x)
        dist.all_reduce(buf, op=op, group=group)
        return self._back(buf, x)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        out = self._all_reduce(x, axes, dist.ReduceOp.SUM)
        return x if out is None else out

    def pmean(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        out = self._all_reduce(x, axes, dist.ReduceOp.SUM)
        return x if out is None else out / self.size(axes)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        out = self._all_reduce(x, axes, dist.ReduceOp.MAX)
        return x if out is None else out

    def _in_axes_order(self, items: List, axes: Tuple[str, ...]) -> List:
        """``items``, one a group member in mesh order, reordered to the
        order of ``axes`` as given (first axis major)."""
        canon = tuple(a for a in self.axis_names if a in axes)
        if canon == axes:
            return items
        sizes = [self.shape[a] for a in canon]
        return [items[i] for i in np.arange(len(items)).reshape(sizes)
                .transpose([canon.index(a) for a in axes]).reshape(-1)]

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """Every member's ``x`` concatenated along ``dim`` (stacked along dim
        0 when 0-d), in rank order along ``axes``, the first axis major
        (``jax.lax.all_gather(..., axis=dim, tiled=True)``). On gloo the
        pieces meet in host memory, each in its own layout, are joined
        along ``dim`` there (whole runs of memory, never element by
        element) and the result moves to ``x``'s device once."""
        axes = self._axes(axes)
        part = x.reshape(1) if x.dim() == 0 else x
        if self.size(axes) == 1:
            return part
        group, members = self._group(axes)
        buf = self._wire(part, raw=True)
        parts = [torch.empty_like(buf) for _ in members]
        dist.all_gather(parts, buf, group=group)
        parts = [p.view(part.dtype).reshape(part.shape) for p in self._in_axes_order(parts, axes)]
        return torch.cat(parts, dim=dim).to(part.device, non_blocking=True)

    def psum_scatter(self, x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """This member's block of the sum over ``axes`` of every member's
        ``x``: ``x``'s ``dim`` cut into as many blocks as members, block i
        to the member at index i along ``axes`` (``jax.lax.psum_scatter(...,
        scatter_dimension=dim, tiled=True)``): one collective,
        ``reduce_scatter_tensor`` over the blocks laid end to end, each in
        its own layout (on gloo cut from the host copy in whole runs of
        memory)."""
        axes = self._axes(axes)
        n = self.size(axes)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} members of {axes}")
        group, _ = self._group(axes)
        blocks = self.backend._wire(x.contiguous()).chunk(n, dim=dim)
        # block i goes to the member at index i along ``axes``; the group
        # hands block p to its p-th member in mesh order, the member at
        # position at[i] holds index i
        at = self._in_axes_order(list(range(n)), axes)
        order = [0] * n
        for i, p in enumerate(at):
            order[p] = i
        flat = torch.cat([blocks[i] for i in order])                 # a fresh copy
        out = torch.empty(blocks[0].shape, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=group)
        return out.to(x.device, non_blocking=True)

    def broadcast(self, x: torch.Tensor, axes: Axes, index: int) -> torch.Tensor:
        """The ``x`` of the member at ``index`` along ``axes`` on every
        member, bit for bit."""
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return x
        group, members = self._group(axes)
        src = members[self._member_position(axes, index)]
        buf = self._wire(x, raw=True)
        dist.broadcast(buf, src=src, group=group)
        return self._back(buf, x)

    def ppermute(self, x: torch.Tensor, axes: Axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``x`` moved along ``axes`` by ``perm``'s ``(source, destination)``
        index pairs; zeros where this rank is no destination."""
        axes = self._axes(axes)
        n = self.size(axes)
        if n == 1:
            return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
        _, members = self._group(axes)
        me = self.axis_index(axes)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"ppermute pairs {list(perm)} send or receive twice at {me}")
        if dst == [me] and src == [me]:
            return x
        peer = {i: members[self._member_position(axes, i)] for i in dst + src}
        t0 = time.perf_counter()
        buf = self._wire(x, raw=True)
        out = torch.zeros_like(buf)
        ops = [dist.P2POp(dist.isend, buf, peer[i]) for i in dst] + \
              [dist.P2POp(dist.irecv, out, peer[i]) for i in src]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = self._back(out, x) if src else torch.zeros_like(x)
        self.p2p_seconds.append(time.perf_counter() - t0)
        return got

    def _member_position(self, axes: Tuple[str, ...], index: int) -> int:
        """The position in the group's (mesh-ordered) member list of the
        member at ``index`` along ``axes``."""
        canon = tuple(a for a in self.axis_names if a in axes)
        if canon == axes:
            return index
        coords = np.unravel_index(index, [self.shape[a] for a in axes])
        at = dict(zip(axes, coords))
        return int(np.ravel_multi_index([at[a] for a in canon],
                                        [self.shape[a] for a in canon]))

    # ------------------------------------------------------------ host side
    def gather_ints(self, value: int, axes: Axes) -> List[int]:
        """Every member's host integer, in rank order along ``axes``."""
        if self.size(axes) == 1:
            return [int(value)]
        every = self.all_gather(torch.tensor([int(value)], dtype=torch.int64), axes)
        with sync_allowed("collective"):
            return [int(v) for v in every.cpu().tolist()]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], backend) -> Mesh:
    """A mesh of ``shape`` named ``axis_names`` over ``backend``'s ranks
    (their count must be the product of ``shape``). Every rank calls it,
    in the same order as every other mesh it makes."""
    return Mesh(shape, axis_names, backend)


__all__ = ["Mesh", "make_mesh"]
