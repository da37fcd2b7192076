"""Logical-axis sharding rules and the eager partitioner — the twin of the
JAX package's ``distributed/sharding.py``, in plain PyTorch.

Code names the LOGICAL axes of its arrays (``act_batch``, ``heads``, ...);
a rule table maps each to mesh axes, and ``logical_to_spec`` resolves the
names against a mesh's axes. The port's sharded selection engine asks it
which mesh axes the batch runs over (``act_batch`` → ``("pod", "data")``,
filtered to the axes the mesh has). Any object with ``axis_names`` and a
``shape`` mapping works as the mesh: a port ``Mesh``, the dry run's
abstract meshes, or a JAX mesh's names and sizes.

A spec is a tuple with one entry per logical axis, as a ``PartitionSpec``
lists them: a mesh axis name, a tuple of two or more names, or ``None``
(replicated).

The partitioner half places parameters where XLA's would under
``jax.jit(..., in_shardings=param_shardings(...))``, in eager terms:

* ``param_shardings`` gives each leaf of a tree its :class:`LeafSharding`:
  the spec after ``logical_to_spec`` and ``drop_indivisible``, the global
  shape, and this rank's index range on every dimension (the rank's
  coordinates on a port ``Mesh``; coordinate 0 on every axis of a mesh
  without ranks, the device the dry run traces);
* ``shard_tensor`` cuts a full tensor to this rank's shard (a copy of its
  own, so that the full tensor can go);
* ``gather_tensor`` rebuilds the full tensor over the spec's axes
  (``Mesh.all_gather`` along each sharded dimension);
* :class:`ShardedParam` is a sharded leaf in a parameter tree, and
  ``materialize`` gathers it where it is read: forward ``gather_tensor``;
  backward the full-size gradient ``psum_scatter``-ed over the axes the
  leaf is sharded on, then ``psum``-ed over the axes it is replicated on,
  so that each rank holds the gradient of its own shard summed over every
  rank's rows (ZeRO-3, the ``fsdp`` preset's schedule).

``constrain`` (``with_sharding_constraint`` on activations) has no
counterpart: under ``fsdp`` no activation is constrained beyond the batch
split, which the train step makes itself (``launch/steps.py``); under the
``default`` preset the layers of every family place their activations
where JAX's ``constrain`` calls declare them, with the collectives
written out (:class:`SeqParallel`). A decode cache lies as JAX's
``cache_logical`` declares it (:class:`CacheLayout`: its rows over the
batch's axes, its positions over ``act_kv_seq``'s). A MoE layer's token
groups and experts lie as JAX's flat grouping declares them
(:class:`ExpertLayout`: the groups over ``act_batch``'s axes, the experts
over ``act_experts``', after ``drop_indivisible``). ``check_rules`` says
which layouts the port runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# the production meshes' axes: ("data", "model") on one pod, ("pod", "data",
# "model") on several; "pod" appears in a batch rule only where the mesh has it
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # --- activation axes ---
    "act_batch": ("pod", "data"),       # data parallel over pod + data
    "act_seq": None,
    "act_res_seq": "model",             # sequence parallelism on the residual stream
    "act_q_seq": "model",               # seq-sharded attention queries
    "act_kv_seq": None,
    "act_heads": "model",
    "act_kv_heads": None,
    "act_embed": None,
    "act_mlp": "model",
    "act_experts": "model",
    "act_mlp_inner": None,
    "act_moe_groups": ("model", "pod", "data"),
    "act_moe_dispatch": ("pod", "data"),
    "act_vocab": "model",
    # --- parameter axes ---
    "embed": "data",                    # FSDP over the d_model dim of weights
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "layers": None,
    "ssm_inner": "model",
    "unsharded": None,
}


class _State(threading.local):
    def __init__(self):
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)
        self.mesh = None
        self.enabled: bool = False
        self.rows: Optional[Tuple[str, ...]] = None


_STATE = _State()


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[Dict[str, MeshAxes]] = None):
    """Make ``mesh`` and the default rules with ``overrides`` the ones that
    ``logical_to_spec`` uses when it is given none (per thread)."""
    prev = (_STATE.rules, _STATE.mesh, _STATE.enabled)
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    _STATE.rules, _STATE.mesh, _STATE.enabled = rules, mesh, True
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh, _STATE.enabled = prev


def logical_to_spec(logical: Sequence[Optional[str]], mesh=None,
                    rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Map logical axis names to a spec valid for ``mesh``: each rule's
    target filtered to the mesh's axes, ``None`` where nothing is left."""
    mesh = mesh if mesh is not None else _STATE.mesh
    rules = rules or _STATE.rules
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    spec = []
    for name in logical:
        if name is None:
            spec.append(None)
            continue
        target = rules.get(name)
        if target is None:
            spec.append(None)
        elif isinstance(target, str):
            spec.append(target if target in mesh_axes else None)
        else:
            filtered = tuple(a for a in target if a in mesh_axes)
            # one axis is listed by its name, as a PartitionSpec lists it
            spec.append(filtered[0] if len(filtered) == 1 else (filtered or None))
    return tuple(spec)


def _axis_size(mesh, target: MeshAxes) -> int:
    if target is None:
        return 1
    if isinstance(target, str):
        return mesh.shape[target]
    size = 1
    for a in target:
        size *= mesh.shape[a]
    return size


def drop_indivisible(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """A spec sanitized against concrete dims: each entry cut to the longest
    prefix of its axes whose size divides the dim (``None`` when none
    does), and a mesh axis used by an earlier dim dropped (the first use
    wins)."""
    used: set = set()
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if a not in used)
        while axes and (dim % _axis_size(mesh, axes) != 0):
            axes = axes[:-1]
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def active() -> Optional[Tuple[Any, Dict[str, MeshAxes]]]:
    """``(mesh, rules)`` of the enclosing ``sharding_rules``, else None."""
    if not _STATE.enabled or _STATE.mesh is None:
        return None
    return _STATE.mesh, dict(_STATE.rules)


# activation axes that the fsdp preset leaves unsharded: tensor and sequence
# parallelism
_TP_ACTIVATIONS = ("act_seq", "act_res_seq", "act_q_seq", "act_heads", "act_kv_heads",
                   "act_embed", "act_mlp", "act_mlp_inner", "act_vocab")
# the decode cache's positions: a shape's rules (JAX's ``SHAPE_RULES`` of
# decode_32k and long_500k) split them over the mesh under either preset,
# and only the cache reads them (``cache_layout``)
_CACHE_ACTIVATIONS = ("act_kv_seq",)


def rules_mode(mesh, rules: Dict[str, MeshAxes]) -> str:
    """Which layout ``rules`` give the activations on ``mesh``: ``"fsdp"``
    (the batch alone is split), ``"default"`` (JAX's ``DEFAULT_RULES`` on
    this mesh: the residual's sequence, the attention queries, the MLP
    hidden and the vocabulary over ``"model"``) or ``"other"``. Either
    preset may split the cache's positions (``act_kv_seq``) any way."""
    def resolve(r):
        return {n: logical_to_spec((n,), mesh, r) for n in _TP_ACTIVATIONS + ("act_batch",)}
    got = resolve(rules)
    if all(got[n] == (None,) for n in _TP_ACTIVATIONS):
        return "fsdp"
    if got == resolve(DEFAULT_RULES):
        return "default"
    return "other"


def check_rules(mesh, rules: Dict[str, MeshAxes], family: str = "dense",
                frontend: Optional[str] = None, local_groups: bool = False) -> str:
    """Raise ``ValueError`` unless the port's sharded steps run ``rules`` on
    ``mesh`` for a model of ``family`` with ``frontend``; return the mode
    (``rules_mode``). They run the ``fsdp`` layout and the ``default``
    preset's for every family, with or without a frontend
    (``models/model.py`` ``sequence_layout`` lays out the frames, or the
    patches and tokens, that a model embeds). A MoE's chunk-major grouping
    (``local_groups``, ``moe_local_groups``) moves its groups between the
    ranks of "model", an all-to-all the port's ``Mesh`` does not have."""
    mode = rules_mode(mesh, rules)
    if family == "moe" and local_groups and mode in ("fsdp", "default"):
        raise ValueError(
            "moe_local_groups under a mesh: the chunk-major groups (act_moe_groups → "
            "act_moe_dispatch) move between the ranks by an all-to-all, which the port's Mesh "
            "does not have (ROADMAP.md A14c)")
    if mode in ("fsdp", "default"):
        return mode
    heads = [n for n in ("act_heads", "act_kv_heads")
             if logical_to_spec((n,), mesh, rules) != (None,)]
    if logical_to_spec(("act_q_seq",), mesh, rules) == (None,) and heads:
        raise ValueError(
            f"the rules shard the attention heads ({heads}) over the mesh, the 'head_tp' "
            "preset's head-parallel attention, which the port does not have (ROADMAP.md A13)")
    raise ValueError(
        "the rules shard the activations neither as the 'fsdp' preset nor as the 'default' "
        "one: the port's sharded step runs those two layouts only (ROADMAP.md A12, A13)")


# ---------------------------------------------------------------------------
# the default preset's activation layout: sequence and tensor parallelism
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """Forward ``all_gather`` along ``dim`` over ``axes``; backward the
    reduce-scatter of the gradient along it (every rank's rows summed)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x.contiguous(), axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum_scatter(g.contiguous(), ctx.axes, dim=ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """Forward the reduce-scatter along ``dim`` over ``axes`` (the partial
    sums of every rank added, each keeping its block); backward the
    all-gather of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.psum_scatter(x.contiguous(), axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axes, dim=ctx.dim), None, None, None


class _PSum(torch.autograd.Function):
    """Forward ``psum`` over ``axes``; backward ``psum`` of the gradient:
    the global objective is the sum of every rank's loss, and each rank's
    loss may read the sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), ctx.axes), None, None


def psum(x: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """The differentiable ``psum`` of ``x`` over ``axes`` (the identity over
    none)."""
    return _PSum.apply(x, mesh, axes) if axes and mesh.size(axes) > 1 else x


@dataclasses.dataclass(frozen=True, eq=False)
class SeqParallel:
    """The ``default`` preset's layout of one forward over sequences of
    ``length`` positions on ``mesh``: the residual stream's sequence splits
    over ``axes`` (``act_res_seq`` after ``drop_indivisible``; ``()`` when
    the length does not divide, and every rank then holds it whole), this
    rank holding positions ``[start, stop)``.

    The gradients follow one rule: the objective is the sum over every rank
    of its own loss. A collective's backward is its adjoint under that sum
    (gather ↔ reduce-scatter, psum ↔ psum), and an activation that every
    model rank computes alike (replicated compute: the gathered logits,
    the nll) counts on the rank at index 0 of the axes it is replicated
    over (the train step's ``ShardLayout.counts``)."""
    mesh: Any
    rules: Dict[str, MeshAxes]
    length: int
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.mesh.size(self.axes) if self.axes else 1

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axes) if self.axes else 0

    @property
    def local(self) -> int:
        return self.length // self.size

    @property
    def start(self) -> int:
        return self.index * self.local

    @property
    def stop(self) -> int:
        return self.start + self.local

    def split(self, logical: str, n: int) -> Tuple[str, ...]:
        """The mesh axes a dim of ``n`` named ``logical`` splits over."""
        return split_axes(logical, n, self.mesh, self.rules)

    def part(self, logical: str, n: int) -> Tuple[int, int]:
        """This rank's ``[start, stop)`` of a dim of ``n`` named ``logical``."""
        axes = self.split(logical, n)
        if not axes:
            return 0, n
        k, i = self.mesh.size(axes), self.mesh.axis_index(axes)
        return i * n // k, (i + 1) * n // k

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's positions of a whole sequence (a view)."""
        return x.narrow(dim, self.start, self.local) if self.axes else x

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from every rank's positions: all-gather,
        its backward a reduce-scatter."""
        return _Gather.apply(x, self.mesh, self.axes, dim) if self.size > 1 else x

    def scatter(self, x: torch.Tensor, axes: Tuple[str, ...], dim: int = 1) -> torch.Tensor:
        """This rank's positions of the sum over ``axes`` of every rank's
        whole-sequence partial sum ``x``: a reduce-scatter where the
        sequence splits over ``axes`` (its backward an all-gather), else the
        psum, then this rank's positions."""
        if axes == self.axes:
            return _Scatter.apply(x, self.mesh, axes, dim) if self.size > 1 else x
        return self.take(psum(x, self.mesh, axes), dim)


def sequence_parallel(length: int) -> Optional[SeqParallel]:
    """The ``SeqParallel`` of a forward over ``length`` positions under the
    active ``sharding_rules`` when they are the ``default`` preset's, else
    None (no rules, or the ``fsdp`` layout)."""
    act = active()
    if act is None:
        return None
    mesh, rules = act
    if rules_mode(mesh, rules) != "default":
        return None
    return SeqParallel(mesh, rules, int(length), split_axes("act_res_seq", length, mesh, rules))


@contextlib.contextmanager
def batch_rows(axes: Tuple[str, ...]):
    """Within: a forward's batch holds this rank's rows of the global batch,
    split over ``axes`` of the active mesh (the peers along the other axes
    hold the same rows). The train step says it around each forward under
    ``sharding_rules`` (``launch/steps.py``): the batch, or the subset,
    splits over its own axes, and a MoE layer groups the global batch's
    tokens (``models/model.py`` ``expert_layout``)."""
    prev = _STATE.rows
    _STATE.rows = tuple(axes)
    try:
        yield
    finally:
        _STATE.rows = prev


def row_axes() -> Optional[Tuple[str, ...]]:
    """The axes of the enclosing ``batch_rows``, else None."""
    return _STATE.rows


def moe_axes(groups: int, experts: int, mesh, rules: Optional[Dict[str, MeshAxes]] = None
             ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(the axes a MoE layer's G token groups split over, those its E
    experts split over): JAX's flat grouping constrains the expert buffers
    to ``("act_batch", "act_experts", None, None)`` (``repro/models/
    layers.py`` ``moe``), cut by ``drop_indivisible`` on (G, E), so the
    groups take their axes first and the experts what is left."""
    spec = drop_indivisible(logical_to_spec(("act_batch", "act_experts"), mesh, rules),
                            (groups, experts), mesh)
    return _entry_axes(spec[0]), _entry_axes(spec[1])


@dataclasses.dataclass(frozen=True, eq=False)
class ExpertLayout:
    """Where one MoE forward's work lies on ``mesh``: the global batch's
    ``tokens`` in ``groups`` of ``group_size`` (capacity ``capacity`` a
    group and expert), the groups over ``group_axes`` and the ``experts``
    over ``expert_axes`` (``moe_axes``); the forward's input holds this
    rank's rows, split over ``row_axes``, and under the ``default`` preset
    (``sp``) its positions of them.

    ``dispatch`` gives the rank the tokens of its groups: the rows whole
    (``sp.gather``), then its groups' part of them, or its rows gathered
    over the batch axes the groups do not split over. Every rank that holds
    a group routes it whole and runs its own experts on it. ``combine``
    sums the float32 partials of the ranks that share the rank's groups
    (a ``psum_scatter`` back onto its rows and positions where those ranks
    split them, a ``psum`` where they hold them alike). The peers along
    axes that split neither the groups nor the experts run the same
    experts on the same groups: only the one at index 0 adds its partial
    (``counted``), the others add zeros, so that the sum counts it once.
    The gradients follow the rule of :class:`SeqParallel`: each
    collective's backward is its adjoint, so the router's gradient and the
    gathered tokens', partial on each rank, sum over the ranks."""
    mesh: Any
    tokens: int
    group_size: int
    capacity: int
    experts: int
    row_axes: Tuple[str, ...]
    group_axes: Tuple[str, ...]
    expert_axes: Tuple[str, ...]
    sp: Optional[SeqParallel]

    @property
    def expert_range(self) -> Tuple[int, int]:
        """This rank's experts ``[start, stop)``."""
        if not self.expert_axes:
            return 0, self.experts
        k, i = self.mesh.size(self.expert_axes), self.mesh.axis_index(self.expert_axes)
        return i * self.experts // k, (i + 1) * self.experts // k

    @property
    def counted(self) -> bool:
        """Whether this rank's partial is the one the combine adds: index 0
        along the axes that split neither the groups nor the experts."""
        coords = _coords(self.mesh)
        return all(coords[a] == 0 for a in self.mesh.axis_names
                   if a not in self.group_axes and a not in self.expert_axes)

    def dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, positions, D) this rank's input → (G_r, gs, D) the tokens of
        its groups."""
        if self.sp is not None:
            x = self.sp.gather(x)
        D = x.shape[-1]
        t = x.reshape(-1, D)
        g, r = self.group_axes, self.row_axes
        if len(g) > len(r):                 # the rank's groups: a part of its rows
            n = t.shape[0] // self.mesh.size(g[len(r):])
            t = t.narrow(0, self.mesh.axis_index(g[len(r):]) * n, n)
        elif len(g) < len(r):               # its rows: a part of its groups
            t = _Gather.apply(t.contiguous(), self.mesh, r[len(g):], 0)
        return t.reshape(-1, self.group_size, D)

    def combine(self, out: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
        """The float32 partial ``out`` (G_r, gs, D) of this rank's experts →
        the sum over every rank's experts, float32, in the input's
        ``shape`` (this rank's rows and positions)."""
        mesh, g, r = self.mesh, self.group_axes, self.row_axes
        t = out.reshape(-1, out.shape[-1])
        if not self.counted:
            t = t * 0.0
        rest = tuple(a for a in mesh.axis_names if a not in g)
        if len(g) > len(r):
            t = _Gather.apply(t.contiguous(), mesh, g[len(r):], 0)
        elif len(g) < len(r):
            t = _Scatter.apply(t.contiguous(), mesh, r[len(g):], 0)
            rest = tuple(a for a in rest if a not in r)
        sp = self.sp
        if sp is not None and sp.size > 1:
            t = _Scatter.apply(t.reshape(shape[0], sp.length, shape[-1]), mesh, sp.axes, 1)
            rest = tuple(a for a in rest if a not in sp.axes)
        return psum(t.reshape(shape), mesh, rest)


@dataclasses.dataclass(frozen=True, eq=False)
class CacheLayout:
    """Where this rank's part of a decode cache for ``rows`` sequences of
    ``length`` positions lies on ``mesh``: the K/V leaves' logical axes
    (``("act_batch", "act_kv_seq", "act_kv_heads", None)``, JAX's
    ``cache_logical``) after ``drop_indivisible``, so that the rows take
    their axes first and the positions what is left. The rank holds rows
    ``[row_start, row_stop)`` (over ``batch_axes``) and positions ``[start,
    stop)`` (over ``seq_axes``); its peers along ``seq_axes`` hold the same
    rows, and their attention states meet in a split-KV combine
    (``models/layers.py``)."""
    mesh: Any
    rows: int
    length: int
    batch_axes: Tuple[str, ...]
    seq_axes: Tuple[str, ...]
    row_start: int
    row_stop: int
    start: int
    stop: int

    @property
    def split(self) -> bool:
        """Whether the positions are split over more than one rank."""
        return bool(self.seq_axes) and self.mesh.size(self.seq_axes) > 1

    def take_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch's tensor (a view)."""
        return x.narrow(0, self.row_start, self.row_stop - self.row_start)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows from every rank's: an all-gather over
        ``batch_axes``."""
        return self.mesh.all_gather(x, self.batch_axes) if self.batch_axes else x


def cache_layout(rows: int, length: int, mesh=None,
                 rules: Optional[Dict[str, MeshAxes]] = None) -> Optional[CacheLayout]:
    """The :class:`CacheLayout` of a cache for ``rows`` sequences of
    ``length`` positions on ``mesh`` under ``rules`` (default: the active
    ``sharding_rules``'; None where there are none)."""
    if mesh is None:
        act = active()
        if act is None:
            return None
        mesh, rules = act
    s = leaf_sharding((rows, length), ("act_batch", "act_kv_seq"), mesh, rules)
    (r0, r1), (t0, t1) = s.bounds
    return CacheLayout(mesh, int(rows), int(length), _entry_axes(s.spec[0]),
                       _entry_axes(s.spec[1]), r0, r1, t0, t1)


def _coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on every axis: a port ``Mesh``'s, else 0 (the
    device a dry run traces)."""
    coords = getattr(mesh, "coords", None)
    return dict(coords) if coords is not None else {a: 0 for a in mesh.axis_names}


def _entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_axes(logical: str, rows: int, mesh, rules: Optional[Dict[str, MeshAxes]] = None
               ) -> Tuple[str, ...]:
    """The mesh axes a dim of ``rows`` named ``logical`` splits over (``act_batch``:
    the batch's), cut by ``drop_indivisible``; ``()`` when none divides."""
    spec = logical_to_spec((logical,), mesh, rules)
    return _entry_axes(drop_indivisible(spec, (rows,), mesh)[0])


@dataclasses.dataclass(frozen=True, eq=False)
class LeafSharding:
    """Where one leaf lives on ``mesh``: its ``spec`` (after
    ``logical_to_spec`` and ``drop_indivisible``), its global ``shape`` and
    this rank's ``[start, stop)`` on every dim (``bounds``)."""
    spec: Spec
    shape: Tuple[int, ...]
    mesh: Any
    bounds: Tuple[Tuple[int, int], ...]

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.bounds)

    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is split over, in mesh order."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    @property
    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes along which every rank holds the same shard."""
        used = set(self.sharded_axes)
        return tuple(a for a in self.mesh.axis_names if a not in used)

    @property
    def is_sharded(self) -> bool:
        return self.local_shape != tuple(self.shape)

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split dim ``dim``."""
        return _entry_axes(self.spec[dim])

    def counted(self) -> bool:
        """Whether this rank's copy of the shard is the one a global sum over
        ranks counts: the one at index 0 along the replicated axes."""
        coords = _coords(self.mesh)
        return all(coords[a] == 0 for a in self.replicated_axes)


def leaf_sharding(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
                  rules: Optional[Dict[str, MeshAxes]] = None) -> LeafSharding:
    """One leaf's :class:`LeafSharding` on ``mesh`` under ``rules``."""
    shape = tuple(int(d) for d in shape)
    spec = drop_indivisible(logical_to_spec(logical, mesh, rules), shape, mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    coords = _coords(mesh)
    bounds = []
    for dim, entry in zip(shape, spec):
        index, n = 0, 1
        for a in _entry_axes(entry):                 # the first axis major
            index = index * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        bounds.append((index * dim // n, (index + 1) * dim // n))
    return LeafSharding(spec, shape, mesh, tuple(bounds))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def param_shardings(tree, logical_tree, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """A :class:`LeafSharding` for each leaf of ``tree`` (tensors or
    anything with a ``shape``; dicts and lists), ``logical_tree`` the
    matching tree of logical-axis tuples."""
    if _is_logical(logical_tree):
        return leaf_sharding(tree.shape, logical_tree, mesh, rules)
    if isinstance(logical_tree, dict):               # in ``tree``'s order
        return {k: param_shardings(v, logical_tree[k], mesh, rules) for k, v in tree.items()}
    return [param_shardings(t, lg, mesh, rules) for t, lg in zip(tree, logical_tree)]


def shard_tensor(full: torch.Tensor, sharding: LeafSharding) -> torch.Tensor:
    """This rank's shard of ``full``: a copy with a storage of its own (the
    tensor itself when the leaf is replicated)."""
    if tuple(full.shape) != sharding.shape:
        raise ValueError(f"tensor of shape {tuple(full.shape)} for a leaf of shape "
                         f"{sharding.shape}")
    if not sharding.is_sharded:
        return full
    return full[tuple(slice(a, b) for a, b in sharding.bounds)].clone()


def _kept(entry: MeshAxes, keep: Tuple[str, ...]) -> bool:
    """Whether a dim sharded over ``entry`` stays local under ``keep``."""
    axes = _entry_axes(entry)
    if axes and set(axes) & set(keep):
        if not set(axes) <= set(keep):
            raise ValueError(f"a dim sharded over {axes} cannot stay local over {keep} alone")
        return True
    return False


def gather_tensor(shard: torch.Tensor, sharding: LeafSharding,
                  keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The full tensor from every rank's shard: ``all_gather`` along each
    sharded dim over its entry's axes (the mesh's collectives). A dim
    sharded over the axes in ``keep`` stays this rank's block (a
    tensor-parallel weight's slice)."""
    x = shard
    for dim, entry in enumerate(sharding.spec):
        if _axis_size(sharding.mesh, entry) > 1 and not _kept(entry, keep):
            x = sharding.mesh.all_gather(x, _entry_axes(entry), dim=dim)
    return x


def reduce_scatter_tensor(full: torch.Tensor, sharding: LeafSharding,
                          keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's shard of the sum over every rank of ``full``:
    ``psum_scatter`` along each sharded dim (the last first) over its
    entry's axes, then ``psum`` of the shard over the replicated axes (a
    sum over all ranks either way; this order moves a shard, not the full
    tensor, over the replicated axes). A dim kept local (``keep``) is
    already this rank's block: the ranks along its axes hold other blocks
    and add nothing to it."""
    g = full
    mesh = sharding.mesh
    for dim in reversed(range(len(sharding.spec))):
        entry = sharding.spec[dim]
        if _axis_size(mesh, entry) > 1 and not _kept(entry, keep):
            g = mesh.psum_scatter(g, _entry_axes(entry), dim=dim)
    rest = tuple(a for a in sharding.replicated_axes if mesh.shape[a] > 1)
    return mesh.psum(g, rest) if rest else g


class _GatherLeaf(torch.autograd.Function):
    """Forward ``gather_tensor``; backward ``reduce_scatter_tensor`` of the
    gathered-size gradient. Saves nothing: under ``remat`` the gather runs
    again in the recompute."""

    @staticmethod
    def forward(ctx, shard, sharding, keep):
        ctx.sharding, ctx.keep = sharding, keep
        return gather_tensor(shard, sharding, keep)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_tensor(grad.contiguous(), ctx.sharding, ctx.keep), None, None


class ShardedParam:
    """A sharded leaf of a parameter tree: the rank's ``shard`` (the
    parameter the optimizer steps) and its ``sharding``."""

    __slots__ = ("shard", "sharding")

    def __init__(self, shard: torch.Tensor, sharding: LeafSharding):
        self.shard, self.sharding = shard, sharding

    @property
    def shape(self) -> Tuple[int, ...]:
        """The leaf's global shape (what ``params_logical`` reads)."""
        return self.sharding.shape


def materialize(x, keep: Tuple[str, ...] = ()):
    """The full tensor of a parameter leaf where it is read: a
    :class:`ShardedParam` gathered (``_GatherLeaf``: differentiable, its
    gradient reduce-scattered back onto the shard), any other leaf as it
    is. A dim sharded over the axes in ``keep`` stays this rank's block."""
    if isinstance(x, ShardedParam):
        return _GatherLeaf.apply(x.shard, x.sharding, tuple(keep))
    return x


def materialize_part(x, dim: int, part: Tuple[int, int], keep: Tuple[str, ...]):
    """Rows ``[part[0], part[1])`` along ``dim`` of a parameter leaf: its
    shard's block where the leaf is sharded on ``dim`` over ``keep``
    (gathered over its other axes), else that slice of the gathered leaf
    (whose gradient is zero elsewhere, summed over the ranks in the
    gather's backward)."""
    w = materialize(x, keep)
    a, b = part
    return w if w.shape[dim] == b - a else w.narrow(dim, a, b - a)


def materialize_rows(x, ids: torch.Tensor) -> torch.Tensor:
    """``embedding(ids, materialize(x))`` of a 2-D parameter leaf whose
    first dim is whole (the embedding table, ``(None, "embed")``), without
    a gradient, moving the rows' bytes and not the table's: the ids of
    every peer along the axes that split the second dim are gathered (the
    peers may hold other rows of the batch), looked up in this rank's
    columns, the columns gathered, and this rank's own rows kept."""
    if not isinstance(x, ShardedParam) or x.sharding.spec[0] is not None:
        return torch.nn.functional.embedding(ids, materialize(x))
    mesh, axes = x.sharding.mesh, _entry_axes(x.sharding.spec[1])
    if _axis_size(mesh, axes) == 1:
        return torch.nn.functional.embedding(ids, x.shard)
    rows = torch.nn.functional.embedding(mesh.all_gather(ids, axes), x.shard)
    rows = mesh.all_gather(rows, axes, dim=rows.dim() - 1)
    return rows.narrow(0, mesh.axis_index(axes) * ids.shape[0], ids.shape[0])


def materialize_tree(tree):
    """``materialize`` over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: materialize_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [materialize_tree(v) for v in tree]
    return materialize(tree)


__all__ = ["DEFAULT_RULES", "MeshAxes", "Spec", "sharding_rules", "logical_to_spec",
           "drop_indivisible", "active", "rules_mode", "check_rules", "psum",
           "SeqParallel", "sequence_parallel", "batch_rows", "row_axes", "moe_axes",
           "ExpertLayout", "CacheLayout", "cache_layout", "split_axes",
           "LeafSharding", "leaf_sharding", "param_shardings", "shard_tensor", "gather_tensor",
           "reduce_scatter_tensor", "ShardedParam", "materialize", "materialize_part",
           "materialize_rows", "materialize_tree"]
