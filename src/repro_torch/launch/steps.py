"""Train steps with GRAFT integrated, in eager PyTorch.

Three step families, as in the JAX package:
  * ``baseline_train_step`` — full-batch fwd+bwd+update (the paper's "Full")
  * ``graft_train_step``    — on a refresh step the selection forward
    (features + grad embeddings + Fast MaxVol + rank choice), then the
    weighted subset fwd+bwd+update
  * ``subset_train_step``   — the subset step without a refresh

The train state is a dict that the steps update IN PLACE and return:
``model`` (the parameters), ``params`` (the same parameters as a list, in
the optimizer's order), ``opt`` (the state the optimizer's ``init`` builds:
AdamW's moments, SGD's and Lion's momentum, Adafactor's factored second
moments per JAX leaf), ``step`` (a Python int),
``graft`` (``SelectionState``), ``sampler_carry`` and ``health`` (the
divergence sentinel's host-side EMA). Where the JAX step takes
``lax.cond`` on the device step counter, the port takes a host ``if`` on the
Python one; where the JAX step uses ``stop_gradient``, the port runs the
whole selection under ``torch.no_grad()``.

The divergence sentinel decides on the host. The JAX step computes the
update and then ``where``-selects the whole state back on an unhealthy
step, with no host sync; the port reads the loss and grad norm to the host
once per step (one device sync) BEFORE the update and skips the update of
an unhealthy step outright. A healthy step is bit-identical to a run
without the sentinel; an unhealthy one leaves params, moments, selection
and carry untouched and advances only ``step``.

Data parallel (``backend`` a multiprocess ``repro_torch.backend``): each
rank holds K/W rows of the global batch of K, and the step reproduces the
JAX step's global-batch semantics. The selection forward runs on the local
rows; its per-row outputs (pooled hiddens, grad embeddings, scores) are
gathered in rank order, and every rank runs the feature extractor and the
sampler on the global K — identical inputs, identical pivots. Rank r trains
on rows [r·R_max/W, (r+1)·R_max/W) of the R_max pivot rows of the gathered
batch, and the loss and gradients are reduced over the ranks before the
norm, the sentinel and the update: the sum for the subset steps, the mean
for the baseline step. With no backend (or the local one) no op is added.

Parameter sharding (ZeRO-3, JAX's ``fsdp`` preset): a state built under
``sharding_rules(mesh, RULE_PRESETS["fsdp"])`` on a port ``Mesh`` holds
this rank's shards of the parameters and moments (``state_for_model``,
``models/model.py`` ``shard_model``) and its ``ShardLayout``. Its step
gathers each weight where the forward reads it and reduce-scatters its
gradient onto the shard (``distributed/sharding.py``), so ``_finish``
reduces only the loss and the gradients of the replicated leaves; the norm
is global (kernel A split: each rank's sum of squares over the shards it
counts, a psum, the finish). The batch splits over the axes ``act_batch``
maps to under the rules (``("pod", "data", "model")`` filtered to the
mesh, the prefix whose size divides the rows), through the data-parallel
path's ``all_gather_rows`` and ``_local_subset``; a rank that holds the
same subset rows as a peer at index 0 of the axes the subset does not split
over trains on them, as JAX's replicated shards compute, and its loss
counts zero. ``train_state_logical`` is the twin of JAX's logical tree of
the train state.

JAX's ``default`` preset (every family): the same
state (``fsdp`` overrides activation rules only), the batch over ``("pod",
"data")`` and each row's sequence over ``"model"`` (``models/model.py``
``sequence_layout``: the tokens, the frames or the patches and tokens the
model embeds): the model peers of a batch shard hold the same rows and
each runs its positions of the residual stream, the attention queries,
its heads of the RWKV time mix or the SSM heads and its slices of the MLP (the RWKV
channel mix's too) and of the vocabulary, with the collectives of
``distributed/sharding.py`` ``SeqParallel``. The loss comes out whole on
every model peer, and only the peer at model index 0 counts it (the
``counts`` rule above, ``model`` not being a batch axis). The selection
forward gathers the final hiddens over the sequence, so its per-row
outputs are the one-process values on every model peer.

A MoE model under either preset groups the global batch's tokens as JAX
does: each forward here says which axes its rows split over
(``sharding.batch_rows``: the batch's, or the subset's), and its MoE
layers run their groups and experts where ``sharding.ExpertLayout`` puts
them. Adafactor's factored moments on a sharded state are the whole
leaf's (``optim/optimizers.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.backend.base import data_parallel
from repro_torch.core.numerics import device_scalar, take_last
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.accumulate import accumulated_grads
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import Optimizer, OptimizerConfig, make_optimizer
from repro_torch.selection import base as selection_base
from repro_torch.selection import registry as sampler_registry
from repro_torch.selection import sources as sources_lib
from repro_torch.selection.base import GraftConfig

_F = np.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    graft: Optional[GraftConfig] = None
    sampler: str = "graft"          # registry name; any repro_torch.selection sampler
    probe_positions: int = 256      # positions per sequence for grad embeddings
                                    # (0 = all)
    microbatches: int = 1           # >1: gradient accumulation (baseline step)
    sentinel: bool = True           # divergence sentinel + skip-update
    spike_z: float = 6.0            # loss-spike z-score (0 = finite-only)

    @property
    def use_graft(self) -> bool:
        return self.graft is not None


# steps of healthy-loss EMA history required before the spike z-score may
# veto a step
SENTINEL_WARMUP = 16


def init_health() -> Dict[str, Any]:
    """Divergence-sentinel carry, kept on the host in float32: loss EMA
    (mean/var), its sample count and the consecutive-bad-step streak."""
    return {"ema_mean": _F(0.0), "ema_var": _F(0.0), "count": 0, "bad_streak": 0}


def init_sampler_carry(mcfg, tcfg: TrainConfig, params, batch_size: int,
                       device=None):
    """The registry sampler's initial cross-step state on ``device``: ``{}``
    for the stateless strategies, the (L, d) sketch reservoir for
    ``streaming_graft``, with d the registered grad source's ``embed_dim``."""
    smp = sampler_registry.get_sampler(tcfg.sampler)
    grad_source = sources_lib.resolve_grad_source(tcfg.graft.grad_mode)
    spec = selection_base.CarrySpec(
        batch_size=batch_size, grad_dim=grad_source.embed_dim(mcfg, params),
        device=device or "cpu")
    return smp.init_carry(tcfg.graft, spec)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardLayout:
    """Where a sharded state's step runs: the ``mesh``, the axes the global
    batch splits over (``batch_axes``) and those the selected subset of
    ``R_max`` rows splits over (``subset_axes``), and each parameter's
    sharding in the optimizer's order. It stands in for the data-parallel
    backend where the step asks for rows: ``all_gather_rows`` over
    ``batch_axes``, ``process_index``/``process_count`` along
    ``subset_axes``."""
    mesh: Any
    batch_axes: Tuple[str, ...]
    subset_axes: Tuple[str, ...]
    shardings: Tuple[Any, ...]

    @property
    def process_index(self) -> int:
        return self.mesh.axis_index(self.subset_axes) if self.subset_axes else 0

    @property
    def process_count(self) -> int:
        return self.mesh.size(self.subset_axes) if self.subset_axes else 1

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather(x, self.batch_axes) if self.batch_axes else x

    def counts(self, axes: Tuple[str, ...]) -> bool:
        """Whether this rank's rows count: index 0 on every mesh axis but
        ``axes`` (the peers beyond them hold the same rows)."""
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names if a not in axes)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank of the mesh."""
        return self.mesh.psum(x, self.mesh.axis_names)


def _check_sharded(mcfg, tcfg: TrainConfig, mesh, rules) -> None:
    """Raise ``ValueError`` for what the sharded step does not run: rules
    other than the ``fsdp`` and ``default`` layouts (``sharding.check_rules``); a
    MoE's chunk-major groups,
    and its microbatches, whose global rows lie on other ranks (each an
    all-to-all); the ``full`` grad source."""
    sh.check_rules(mesh, rules, mcfg.family, mcfg.frontend, mcfg.moe_local_groups)
    if mcfg.family == "moe" and tcfg.microbatches > 1:
        raise ValueError(
            f"{tcfg.microbatches} microbatches of a sharded MoE batch: each microbatch's "
            "global rows, which its groups span, lie on other ranks, and gathering them is an "
            "all-to-all the port's Mesh does not have (ROADMAP.md A14c)")
    if tcfg.use_graft and tcfg.graft.grad_mode == "full":
        raise ValueError("grad_mode 'full' takes per-sample gradients of the whole parameter "
                         "tree, which a sharded state does not hold; use probe or logit_embed "
                         "(ROADMAP.md A18)")


def state_for_model(mcfg, tcfg: TrainConfig, model, batch_size: int) -> Dict[str, Any]:
    """A fresh train state around existing parameters (drawn by
    ``init_params`` or loaded through the JAX bridge). Under
    ``sharding_rules`` (the fsdp preset on a port ``Mesh``, or the dry run's
    recording mesh) the state is this rank's: ``model``'s parameters are
    cut to their shards in place (``shard_model``), the moments follow
    them, the rest is replicated, and ``layout`` says where its step runs.
    ``batch_size`` is the global batch."""
    active = sh.active()
    layout = None
    if active is not None:
        mesh, rules = active
        _check_sharded(mcfg, tcfg, mesh, rules)
        if not isinstance(model, model_lib.ShardedModel):
            model = model_lib.shard_model(model, mesh, rules)
        batch_axes = sh.split_axes("act_batch", batch_size, mesh, rules)
        subset = (sh.split_axes("act_batch", tcfg.graft.r_max, mesh, rules) if tcfg.use_graft
                  else batch_axes)
        layout = ShardLayout(mesh, batch_axes, tuple(a for a in subset if a in batch_axes),
                             tuple(model.param_shardings()))
    device = model.embed.device
    params = list(model.parameters())
    index = {id(p): i for i, p in enumerate(params)}
    # the JAX leaves, for Adafactor's factoring: a blocks/ leaf stacks its
    # blocks on a new axis 0 (a list), any other leaf — first_blocks/ ones
    # too — is one param (an int)
    plain = model.model if layout is not None else model
    groups = [[index[id(t)] for t in ts] if path.startswith("blocks/") else index[id(ts[0])]
              for path, ts in model_lib.stacked_leaves(plain)]
    state: Dict[str, Any] = {
        "model": model,
        "params": params,
        "opt": make_optimizer(tcfg.optimizer).init(params, groups),
        "step": 0,
    }
    if layout is not None:
        state["layout"] = layout
    if tcfg.use_graft:
        state["graft"] = selection_base.init_state(tcfg.graft, batch_size, device)
        state["sampler_carry"] = init_sampler_carry(mcfg, tcfg, model.tree(),
                                                    batch_size, device)
    if tcfg.sentinel:
        state["health"] = init_health()
    return state


def init_train_state(mcfg, tcfg: TrainConfig, generator: torch.Generator,
                     batch_size: int, device=None) -> Dict[str, Any]:
    """``init_params`` from ``generator``, then ``state_for_model`` (this
    rank's shards under ``sharding_rules``)."""
    return state_for_model(mcfg, tcfg,
                           model_lib.init_params(mcfg, generator, device),
                           batch_size)


# ---------------------------------------------------------------------------
# logical axes of the train state
# ---------------------------------------------------------------------------

def _replicated_logical(tree):
    """One ``None`` a dim for every leaf of ``tree`` (dicts, lists,
    NamedTuples); ``()`` for a host scalar."""
    if isinstance(tree, dict):
        return {k: _replicated_logical(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return type(tree)(**{k: _replicated_logical(v) for k, v in tree._asdict().items()})
    if isinstance(tree, (list, tuple)):
        return [_replicated_logical(v) for v in tree]
    return tuple(None for _ in getattr(tree, "shape", ()))


def _factored(lg, shape) -> Dict[str, Tuple]:
    if len(shape) >= 2:
        return {"vr": tuple(lg[:-1]), "vc": tuple(lg[:-2]) + (lg[-1],)}
    return {"v": tuple(lg)}


def _map_logical(fn, lg, params):
    if isinstance(lg, dict):
        return {k: _map_logical(fn, v, params[k]) for k, v in lg.items()}
    if isinstance(lg, list):
        return [_map_logical(fn, v, p) for v, p in zip(lg, params)]
    return fn(lg, tuple(params.shape))


def opt_state_logical(opt_name: str, p_logical, params):
    """Logical-axis tree for the optimizer state (mirrors the params';
    Adafactor's factored moments drop the reduced axis). ``params`` is the
    parameter tree (``Model.tree()``); Adafactor factors a ``blocks`` leaf
    over the blocks stacked on ``layers``, as JAX and the port's Adafactor
    do, so its ``blocks`` entry is one stacked leaf's, as in JAX."""
    if opt_name in ("sgd", "lion"):
        return {"m": p_logical}
    if opt_name == "adamw":
        return {"m": p_logical, "v": p_logical}
    if opt_name == "adafactor":
        out = {k: _map_logical(_factored, v, params[k])
               for k, v in p_logical.items() if k != "blocks"}
        n = len(params["blocks"])
        out["blocks"] = _map_logical(lambda lg, shape: _factored(("layers",) + lg, (n,) + shape),
                                     p_logical["blocks"][0], params["blocks"][0])
        return {"v": out}
    raise ValueError(opt_name)


def train_state_logical(mcfg, tcfg: TrainConfig, state):
    """JAX's ``train_state_logical`` over the port's train state:
    ``params`` by ``params_logical``, ``opt`` by ``opt_state_logical``,
    ``graft``, ``sampler_carry`` and ``health`` replicated."""
    params = state["model"].tree()
    p_logical = model_lib.params_logical(mcfg, params)
    out = {
        "params": p_logical,
        "opt": opt_state_logical(tcfg.optimizer.name, p_logical, params),
        "step": (),
    }
    for key in ("graft", "sampler_carry", "health"):
        if key in state:
            out[key] = _replicated_logical(state[key])
    return out


# ---------------------------------------------------------------------------
# GRAFT selection inputs at LM scale
# ---------------------------------------------------------------------------

@torch.no_grad()
def selection_rows(mcfg, tcfg: TrainConfig, params, batch
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-row part of the selection forward on ``batch``'s rows:
    (pooled hiddens (K, d_model) f32, grad embeddings (K, E) f32, scores
    (K,)). Each row's outputs depend on that row alone."""
    gcfg = tcfg.graft
    grad_source = sources_lib.resolve_grad_source(gcfg.grad_mode)
    # under the default preset the sequence is gathered first: the probe
    # positions and the pooling see the whole of it, as one process does
    h, mask = model_lib.whole_hiddens(mcfg, params, batch)
    S = h.shape[1]
    stride = max(1, S // tcfg.probe_positions) if tcfg.probe_positions else 1
    hp = h[:, ::stride, :]
    lp = model_lib._pad_labels(batch["labels"], S)[:, ::stride]
    mp = mask[:, ::stride].to(torch.float32)       # labeled probe positions
    logits = model_lib.logits_from_hiddens(mcfg, params, hp)
    emb = grad_source(sources_lib.GradSourceInputs(
        logits=logits, labels=lp, hiddens=hp, mcfg=mcfg, params=params,
        batch=batch, mask=mp))                     # (K, E) f32
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    del logits
    nll = -take_last(logp, lp)
    scores = torch.sum(nll * mp, dim=-1) / torch.clamp(torch.sum(mp, dim=-1), min=1.0)
    return model_lib.pooled_hiddens(h, mask), emb, scores


@torch.no_grad()
def selection_inputs(mcfg, tcfg: TrainConfig, params, batch, backend=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full-batch forward → (V (K,R_max), G (d,K), ḡ (d,), scores (K,)).

    The feature path (V) and gradient-embedding path (G) are resolved from
    the ``selection.sources`` registries by ``GraftConfig.feature_mode`` /
    ``grad_mode``: by default the relevance-ordered SVD of the mean-pooled
    final hiddens × the probe gradients from the softmax error signal at
    ``probe_positions`` strided positions. Scores are the per-example probe
    cross-entropy. Runs under ``no_grad`` (the JAX ``stop_gradient``). Any
    registered source's batch works: the labels are padded to the hidden
    sequence (a vlm batch labels its text positions only) and the loss mask
    keeps unlabeled positions out of the grad embeddings, scores and pooled
    features. With a ``backend`` the per-row outputs of the local rows are
    gathered over the ranks first, so V, G, ḡ and the scores are the global
    batch's on every rank.
    """
    gcfg = tcfg.graft
    extractor = sources_lib.resolve_features(gcfg.feature_mode)
    with _rows_of(backend, "batch_axes"):
        pooled, emb, scores = selection_rows(mcfg, tcfg, params, batch)
    if backend is not None:
        pooled, emb, scores = (backend.all_gather_rows(x) for x in (pooled, emb, scores))
    V = extractor(pooled, gcfg.r_max)
    G = emb.T                                      # (d=E, K)
    g_bar = torch.mean(emb, dim=0)
    return V, G, g_bar, scores


def make_selection_refresh(mcfg, tcfg: TrainConfig, backend=None):
    """``(params, batch, carry, step) → (SelectionState, carry')``: the
    selection forward alone — features + grad embeddings + the registry
    sampler's decision, under ``no_grad``; over the global batch with a
    ``backend``."""
    smp = sampler_registry.get_sampler(tcfg.sampler)
    gcfg = tcfg.graft

    @torch.no_grad()
    def refresh(params, batch, carry, step: int):
        V, G, g_bar, scores = selection_inputs(mcfg, tcfg, params, batch, backend)
        key = selection_base.default_select_generator(step) if smp.needs_key else None
        return smp.select(gcfg, selection_base.SelectionInputs(
            V, G, g_bar, scores, key), carry, step)

    return refresh


def _take_batch(batch, pivots: torch.Tensor, k_global: int):
    return {k: x.index_select(0, pivots)
            if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == k_global
            else x for k, x in batch.items()}


def _local_subset(batch, graft_state, backend):
    """This rank's rows of the selected subset and their weights: all of
    them without a backend; else the pivot rows of the gathered global
    batch, split evenly over the ranks in rank order."""
    if backend is None:
        return _take_batch(batch, graft_state.pivots, _batch_size(batch)), graft_state.weights
    full = {k: backend.all_gather_rows(x) if isinstance(x, torch.Tensor) and x.ndim >= 1
            else x for k, x in batch.items()}
    sub = _take_batch(full, graft_state.pivots, _batch_size(full))
    n = graft_state.pivots.shape[0] // backend.process_count
    rows = slice(backend.process_index * n, (backend.process_index + 1) * n)
    return ({k: x[rows] if isinstance(x, torch.Tensor) and x.ndim >= 1 else x
             for k, x in sub.items()}, graft_state.weights[rows])


def _state_carry(tcfg: TrainConfig, state):
    if "sampler_carry" in state:
        return state["sampler_carry"]
    smp = sampler_registry.get_sampler(tcfg.sampler)
    if smp.stateful:
        raise ValueError(
            f"sampler '{smp.name}' is stateful but the train state has no "
            f"'sampler_carry' — build the state with init_train_state")
    return selection_base.EMPTY_CARRY


def _batch_size(batch) -> int:
    return next(iter(batch.values())).shape[0]


def _rows_of(layout, axes: str):
    """``sharding.batch_rows`` over a sharded state's ``layout.<axes>``
    (its batch's or its subset's), for a forward of this rank's rows;
    nothing without one (a data-parallel backend's, or one process's)."""
    if not isinstance(layout, ShardLayout):
        return contextlib.nullcontext()
    return sh.batch_rows(getattr(layout, axes))


# ---------------------------------------------------------------------------
# the update, with the sentinel's veto between the gradient and the step
# ---------------------------------------------------------------------------

def apply_sentinel(tcfg: TrainConfig, state, metrics) -> Tuple[bool, Dict[str, Any]]:
    """The divergence sentinel's verdict on this step: ``(healthy,
    metrics + {healthy, bad_streak})``, with ``state["health"]`` advanced.

    Healthy means the loss and the global grad norm are finite and, once
    the loss EMA has ``SENTINEL_WARMUP`` healthy samples, the loss is within
    ``spike_z`` EMA standard deviations of the mean. The EMA advances on
    healthy steps only. Reading the two scalars is this step's one host
    sync; the arithmetic is float32, as on the device in the JAX package.
    """
    health = state["health"]
    # a sync every step that only the port makes (ROADMAP.md C), sanctioned
    # under its own name for train.audit
    with sync_allowed("sentinel"):
        loss_h, gnorm_h = torch.stack([metrics["loss"].to(torch.float32),  # lint: allow sentinel
                                       metrics["grad_norm"].to(torch.float32)]).tolist()
    loss = _F(loss_h)
    finite = bool(np.isfinite(loss) and np.isfinite(_F(gnorm_h)))
    mean, var = health["ema_mean"], health["ema_var"]
    healthy = finite
    if tcfg.spike_z:
        std = np.sqrt(np.maximum(var, _F(1e-6)))
        warm = health["count"] >= SENTINEL_WARMUP
        healthy = finite and not (warm and abs(loss - mean) > _F(tcfg.spike_z) * std)
    decay = _F(0.9)
    if healthy:
        dev = loss - mean
        health = {"ema_mean": decay * mean + (_F(1) - decay) * loss,
                  "ema_var": decay * var + (_F(1) - decay) * dev * dev,
                  "count": health["count"] + 1, "bad_streak": 0}
    else:
        health = dict(health, bad_streak=health["bad_streak"] + 1)
    state["health"] = health
    return healthy, dict(metrics, healthy=float(healthy),  # lint: allow a host bool
                         bad_streak=health["bad_streak"])


def _finish(tcfg: TrainConfig, state, loss: torch.Tensor, grads, metrics,
            updates: Dict[str, Any], sentinel: bool, opt: Optimizer, backend=None,
            reduce_op: str = "sum"):
    """Reduce the loss and grads over the ranks (with a ``backend``), grad
    norm and clip, let the sentinel veto, apply the optimizer in place,
    commit ``updates`` to the state and advance the step counter. A sharded
    state's sharded gradients arrive reduced (the gather's backward):
    only the loss and the replicated leaves' gradients are summed here,
    and the norm is the global one."""
    step = state["step"]
    layout = state.get("layout")
    if layout is not None:
        rep = [i for i, s in enumerate(layout.shardings) if not s.is_sharded]
        grads = list(grads)
        if backend is not None:
            reduced = backend.reduce_grads([loss.detach(), *[grads[i] for i in rep]], "sum")
            loss = reduced[0]
            for j, i in enumerate(rep):
                grads[i] = reduced[1 + j]
        grads, opt_metrics = opt.preprocess(grads, [s.counted() for s in layout.shardings],
                                            layout.psum)
    else:
        if backend is not None:
            reduced = backend.reduce_grads([loss.detach(), *grads], reduce_op)
            loss, grads = reduced[0], reduced[1:]
        grads, opt_metrics = opt.preprocess(grads)
    metrics = dict(opt_metrics, loss=loss.detach(), **metrics)
    healthy = True
    if sentinel and "health" in state:
        healthy, metrics = apply_sentinel(tcfg, state, metrics)
    if healthy:
        metrics["lr"] = opt.update(state["params"], grads, state["opt"], step,
                                   layout.shardings if layout is not None else None)
        state.update(updates)
    else:
        metrics["lr"] = opt.lr(step)
        if "graft" in state:
            state["graft"] = state["graft"]._replace(
                step=device_scalar(step + 1, torch.int32, state["graft"].step.device))
    state["step"] = step + 1
    return state, metrics


def param_grads(loss: torch.Tensor, params):
    """d loss / d params. A parameter the loss does not read (the token
    embedding under the ``audio_frames`` frontend) gets a zero gradient, as
    ``jax.grad`` gives it, so that the optimizer steps it the same way."""
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def baseline_train_step(mcfg, tcfg: TrainConfig, state, batch, *, opt: Optimizer,
                        sentinel: bool = False, backend=None):
    """Full-batch step; with ``microbatches`` > 1 the loss and grads are
    the means over that many sequential microbatches
    (``distributed/accumulate.py``). As in the JAX package, only this step
    reads ``microbatches``. Data parallel, each rank's mean is averaged
    over the ranks; sharded, each counted rank's mean over the batch
    shards is summed."""
    layout = state.get("layout")
    scale = None
    if layout is not None:
        n = layout.mesh.size(layout.batch_axes) if layout.batch_axes else 1
        scale = (1.0 / n) if layout.counts(layout.batch_axes) else 0.0

    def loss_of(mb):
        with _rows_of(layout, "batch_axes"):
            loss = model_lib.loss_fn(mcfg, state["model"], mb)[0]
        return loss if scale is None else loss * scale

    if tcfg.microbatches > 1:
        loss, grads = accumulated_grads(loss_of, state["params"], batch, tcfg.microbatches)
    else:
        loss = loss_of(batch)
        grads = param_grads(loss, state["params"])
    return _finish(tcfg, state, loss, grads, {}, {}, sentinel, opt, backend, "mean")


def _rows(state, backend):
    """Where a step's rows come from: a sharded state's layout, else the
    data-parallel backend (None: this process's batch is the batch)."""
    return state.get("layout", backend)


def subset_loss(mcfg, state, batch, graft_state, backend=None) -> torch.Tensor:
    """The weighted per-example loss of the selected subset (this rank's
    share of it with a ``backend`` or a sharded state; zero on a sharded
    rank whose share a peer counts)."""
    rows = _rows(state, backend)
    sub_batch, weights = _local_subset(batch, graft_state, rows)
    with _rows_of(rows, "subset_axes"):
        pel = model_lib.per_example_loss(mcfg, state["model"], sub_batch)
    loss = torch.sum(pel * weights)
    layout = state.get("layout")
    if layout is not None and not layout.counts(layout.subset_axes):
        loss = loss * 0.0
    return loss


def graft_train_step(mcfg, tcfg: TrainConfig, state, batch, *, opt: Optimizer,
                     sentinel: bool = False, backend=None):
    """Alg. 1 as one step, sampler-generic: the subset strategy is resolved
    from the registry by ``tcfg.sampler``."""
    gcfg = tcfg.graft
    step = state["step"]
    carry0 = _state_carry(tcfg, state)
    if gcfg.refresh_every == 1 or step % gcfg.refresh_every == 0:
        refresh = make_selection_refresh(mcfg, tcfg, _rows(state, backend))
        graft_state, carry = refresh(state["model"].tree(), batch, carry0, step)
    else:
        graft_state = state["graft"]._replace(
            step=device_scalar(step, torch.int32, state["graft"].step.device))
        carry = carry0
    loss = subset_loss(mcfg, state, batch, graft_state, backend)
    grads = param_grads(loss, state["params"])
    metrics = {"rank": graft_state.rank, "proj_error": graft_state.last_error,
               "alignment": graft_state.alignment}
    updates: Dict[str, Any] = {"graft": graft_state}
    if "sampler_carry" in state:
        updates["sampler_carry"] = carry
    return _finish(tcfg, state, loss, grads, metrics, updates, sentinel, opt, backend)


def subset_train_step(mcfg, tcfg: TrainConfig, state, batch, *, opt: Optimizer,
                      sentinel: bool = False, backend=None):
    """Alg. 1 'else' branch: train on the STORED subset, no selection."""
    graft_state = state["graft"]
    loss = subset_loss(mcfg, state, batch, graft_state, backend)
    grads = param_grads(loss, state["params"])
    step1 = device_scalar(state["step"] + 1, torch.int32, graft_state.step.device)
    return _finish(tcfg, state, loss, grads, {},
                   {"graft": graft_state._replace(step=step1)}, sentinel, opt, backend)


def selection_step(mcfg, tcfg: TrainConfig, state, batch, backend=None):
    """Selection only — isolates the refresh cost."""
    refresh = make_selection_refresh(mcfg, tcfg, _rows(state, backend))
    graft_state, carry = refresh(state["model"].tree(), batch,
                                 _state_carry(tcfg, state), state["step"])
    state["graft"] = graft_state
    if "sampler_carry" in state:
        state["sampler_carry"] = carry
    return state, {"rank": graft_state.rank, "proj_error": graft_state.last_error}


def make_train_step(mcfg, tcfg: TrainConfig, kind: Optional[str] = None, backend=None):
    """``(state, batch) → (state, metrics)`` for ``kind`` (default: graft
    when ``tcfg.graft`` is set, else baseline), with the sentinel wired in
    when ``tcfg.sentinel`` is on. The optimizer is built once here, for
    every step the function takes. ``backend``: data parallel over its
    ranks; the local backend (one process) adds no op. Under
    ``sharding_rules`` (the fsdp or default preset) the step takes the state
    ``state_for_model`` builds under the same rules, its parameters
    sharded over the mesh's ranks (``backend`` defaults to the mesh's)."""
    active = sh.active()
    if active is not None:
        _check_sharded(mcfg, tcfg, *active)
        if backend is None:
            backend = getattr(active[0], "backend", None)
    backend = data_parallel(backend)
    step = {None: graft_train_step if tcfg.use_graft else baseline_train_step,
            "graft": graft_train_step, "baseline": baseline_train_step,
            "subset": subset_train_step, "select": None}[kind]

    def check(state):
        if active is not None and "layout" not in state:
            raise ValueError("make_train_step under sharding_rules steps a sharded state: build "
                             "it with state_for_model or init_train_state under the same rules")

    def rules():
        """The rules the step was made under, active while it runs: the
        forward reads the ``default`` preset's layout from them."""
        return sh.sharding_rules(*active) if active is not None else contextlib.nullcontext()

    if step is None:
        def select(state, batch):
            check(state)
            with rules():
                return selection_step(mcfg, tcfg, state, batch, backend)
        return select
    sentinel = tcfg.sentinel
    opt = make_optimizer(tcfg.optimizer)

    def fn(state, batch):
        check(state)
        with rules():
            return step(mcfg, tcfg, state, batch, sentinel=sentinel, opt=opt, backend=backend)
    return fn


def make_run_step(mcfg, tcfg: TrainConfig, backend=None):
    """The training loop's ``(state, batch) → (state, metrics)``, the twin
    of the JAX package's ``make_run_step``. ``graft.overlap`` is accepted so
    that the JAX package's configs load, and selects the same sequential
    step: what the JAX overlap buys there (a host-side step index, no host
    sync between the refresh and the train dispatch) the eager port already
    has. ``state["step"]`` is a host int, the refresh dispatches without a
    sync, and steps between refreshes run no selection code. The subset step
    needs the refresh's pivots, so a side stream would only reorder the
    same work (``ROADMAP.md``, B7). ``backend`` as in ``make_train_step``."""
    return make_train_step(mcfg, tcfg, backend=backend)


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def prefill_step(mcfg, params, batch, max_seq: int, layout=None):
    """A prompt batch into a fresh cache of ``max_seq`` positions → (logits
    of the last position, cache). Under ``sharding_rules`` ``layout`` is
    the cache's (``sharding.cache_layout``) and the batch, the logits and
    the cache are its rows' (``models/decode.py``); rules the serve path
    does not run raise ``ValueError`` (``decode.check_serve_rules``:
    ``sharding.check_rules`` for the model's family, and no MoE)."""
    return decode_lib.prefill(mcfg, params, batch, max_seq, layout)


def decode_step(mcfg, params, cache, tokens):
    """One token a row of ``cache`` (its rows, under ``sharding_rules``)
    → (logits, cache)."""
    return decode_lib.decode_step(mcfg, params, cache, tokens)
