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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.sync_guard import sync_allowed
from repro_torch.core.numerics import take_last
from repro_torch.distributed.accumulate import accumulated_grads
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


def state_for_model(mcfg, tcfg: TrainConfig, model: model_lib.Model,
                    batch_size: int) -> Dict[str, Any]:
    """A fresh train state around existing parameters (drawn by
    ``init_params`` or loaded through the JAX bridge)."""
    device = model.embed.device
    params = list(model.parameters())
    index = {id(p): i for i, p in enumerate(params)}
    # the JAX leaves, for Adafactor's factoring: a blocks/ leaf stacks its
    # blocks on a new axis 0 (a list), any other leaf — first_blocks/ ones
    # too — is one param (an int)
    groups = [[index[id(t)] for t in ts] if path.startswith("blocks/") else index[id(ts[0])]
              for path, ts in model_lib.stacked_leaves(model)]
    state: Dict[str, Any] = {
        "model": model,
        "params": params,
        "opt": make_optimizer(tcfg.optimizer).init(params, groups),
        "step": 0,
    }
    if tcfg.use_graft:
        state["graft"] = selection_base.init_state(tcfg.graft, batch_size, device)
        state["sampler_carry"] = init_sampler_carry(mcfg, tcfg, model.tree(),
                                                    batch_size, device)
    if tcfg.sentinel:
        state["health"] = init_health()
    return state


def init_train_state(mcfg, tcfg: TrainConfig, generator: torch.Generator,
                     batch_size: int, device=None) -> Dict[str, Any]:
    return state_for_model(mcfg, tcfg,
                           model_lib.init_params(mcfg, generator, device),
                           batch_size)


# ---------------------------------------------------------------------------
# GRAFT selection inputs at LM scale
# ---------------------------------------------------------------------------

@torch.no_grad()
def selection_inputs(mcfg, tcfg: TrainConfig, params, batch
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
    features.
    """
    gcfg = tcfg.graft
    extractor = sources_lib.resolve_features(gcfg.feature_mode)
    grad_source = sources_lib.resolve_grad_source(gcfg.grad_mode)
    h, mask = model_lib.forward_hiddens(mcfg, params, batch)
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
    V = extractor(model_lib.pooled_hiddens(h, mask), gcfg.r_max)
    G = emb.T                                      # (d=E, K)
    g_bar = torch.mean(emb, dim=0)
    return V, G, g_bar, scores


def make_selection_refresh(mcfg, tcfg: TrainConfig):
    """``(params, batch, carry, step) → (SelectionState, carry')``: the
    selection forward alone — features + grad embeddings + the registry
    sampler's decision, under ``no_grad``."""
    smp = sampler_registry.get_sampler(tcfg.sampler)
    gcfg = tcfg.graft

    @torch.no_grad()
    def refresh(params, batch, carry, step: int):
        V, G, g_bar, scores = selection_inputs(mcfg, tcfg, params, batch)
        key = selection_base.default_select_generator(step) if smp.needs_key else None
        return smp.select(gcfg, selection_base.SelectionInputs(
            V, G, g_bar, scores, key), carry, step)

    return refresh


def _take_batch(batch, pivots: torch.Tensor, k_global: int):
    return {k: x.index_select(0, pivots)
            if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == k_global
            else x for k, x in batch.items()}


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
        loss_h, gnorm_h = torch.stack([metrics["loss"].to(torch.float32),
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
    return healthy, dict(metrics, healthy=float(healthy),
                         bad_streak=health["bad_streak"])


def _finish(tcfg: TrainConfig, state, loss: torch.Tensor, grads, metrics,
            updates: Dict[str, Any], sentinel: bool, opt: Optimizer):
    """Grad norm and clip, let the sentinel veto, apply the optimizer in
    place, commit ``updates`` to the state and advance the step counter."""
    step = state["step"]
    grads, opt_metrics = opt.preprocess(grads)
    metrics = dict(opt_metrics, loss=loss.detach(), **metrics)
    healthy = True
    if sentinel and "health" in state:
        healthy, metrics = apply_sentinel(tcfg, state, metrics)
    if healthy:
        metrics["lr"] = opt.update(state["params"], grads, state["opt"], step)
        state.update(updates)
    else:
        metrics["lr"] = opt.lr(step)
        if "graft" in state:
            state["graft"] = state["graft"]._replace(
                step=torch.tensor(step + 1, dtype=torch.int32,
                                  device=state["graft"].step.device))
    state["step"] = step + 1
    return state, metrics


def param_grads(loss: torch.Tensor, params):
    """d loss / d params. A parameter the loss does not read (the token
    embedding under the ``audio_frames`` frontend) gets a zero gradient, as
    ``jax.grad`` gives it, so that the optimizer steps it the same way."""
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def baseline_train_step(mcfg, tcfg: TrainConfig, state, batch, *, opt: Optimizer,
                        sentinel: bool = False):
    """Full-batch step; with ``microbatches`` > 1 the loss and grads are
    the means over that many sequential microbatches
    (``distributed/accumulate.py``). As in the JAX package, only this step
    reads ``microbatches``."""
    if tcfg.microbatches > 1:
        loss, grads = accumulated_grads(
            lambda mb: model_lib.loss_fn(mcfg, state["model"], mb)[0],
            state["params"], batch, tcfg.microbatches)
        return _finish(tcfg, state, loss, grads, {}, {}, sentinel, opt)
    loss, _ = model_lib.loss_fn(mcfg, state["model"], batch)
    grads = param_grads(loss, state["params"])
    return _finish(tcfg, state, loss, grads, {}, {}, sentinel, opt)


def subset_loss(mcfg, state, batch, graft_state) -> torch.Tensor:
    """The weighted per-example loss of the selected subset."""
    sub_batch = _take_batch(batch, graft_state.pivots, _batch_size(batch))
    pel = model_lib.per_example_loss(mcfg, state["model"], sub_batch)
    return torch.sum(pel * graft_state.weights)


def graft_train_step(mcfg, tcfg: TrainConfig, state, batch, *, opt: Optimizer,
                     sentinel: bool = False):
    """Alg. 1 as one step, sampler-generic: the subset strategy is resolved
    from the registry by ``tcfg.sampler``."""
    gcfg = tcfg.graft
    step = state["step"]
    carry0 = _state_carry(tcfg, state)
    if gcfg.refresh_every == 1 or step % gcfg.refresh_every == 0:
        refresh = make_selection_refresh(mcfg, tcfg)
        graft_state, carry = refresh(state["model"].tree(), batch, carry0, step)
    else:
        graft_state = state["graft"]._replace(
            step=torch.tensor(step, dtype=torch.int32,
                              device=state["graft"].step.device))
        carry = carry0
    loss = subset_loss(mcfg, state, batch, graft_state)
    grads = param_grads(loss, state["params"])
    metrics = {"rank": graft_state.rank, "proj_error": graft_state.last_error,
               "alignment": graft_state.alignment}
    updates: Dict[str, Any] = {"graft": graft_state}
    if "sampler_carry" in state:
        updates["sampler_carry"] = carry
    return _finish(tcfg, state, loss, grads, metrics, updates, sentinel, opt)


def subset_train_step(mcfg, tcfg: TrainConfig, state, batch, *, opt: Optimizer,
                      sentinel: bool = False):
    """Alg. 1 'else' branch: train on the STORED subset, no selection."""
    graft_state = state["graft"]
    loss = subset_loss(mcfg, state, batch, graft_state)
    grads = param_grads(loss, state["params"])
    step1 = torch.tensor(state["step"] + 1, dtype=torch.int32,
                         device=graft_state.step.device)
    return _finish(tcfg, state, loss, grads, {},
                   {"graft": graft_state._replace(step=step1)}, sentinel, opt)


def selection_step(mcfg, tcfg: TrainConfig, state, batch):
    """Selection only — isolates the refresh cost."""
    refresh = make_selection_refresh(mcfg, tcfg)
    graft_state, carry = refresh(state["model"].tree(), batch,
                                 _state_carry(tcfg, state), state["step"])
    state["graft"] = graft_state
    if "sampler_carry" in state:
        state["sampler_carry"] = carry
    return state, {"rank": graft_state.rank, "proj_error": graft_state.last_error}


def make_train_step(mcfg, tcfg: TrainConfig, kind: Optional[str] = None):
    """``(state, batch) → (state, metrics)`` for ``kind`` (default: graft
    when ``tcfg.graft`` is set, else baseline), with the sentinel wired in
    when ``tcfg.sentinel`` is on. The optimizer is built once here, for
    every step the function takes."""
    step = {None: graft_train_step if tcfg.use_graft else baseline_train_step,
            "graft": graft_train_step, "baseline": baseline_train_step,
            "subset": subset_train_step, "select": None}[kind]
    if step is None:
        return lambda state, batch: selection_step(mcfg, tcfg, state, batch)
    sentinel = tcfg.sentinel
    opt = make_optimizer(tcfg.optimizer)

    def fn(state, batch):
        return step(mcfg, tcfg, state, batch, sentinel=sentinel, opt=opt)
    return fn


def make_run_step(mcfg, tcfg: TrainConfig):
    """The training loop's ``(state, batch) → (state, metrics)``, the twin
    of the JAX package's ``make_run_step``. ``graft.overlap`` is accepted so
    that the JAX package's configs load, and selects the same sequential
    step: what the JAX overlap buys there (a host-side step index, no host
    sync between the refresh and the train dispatch) the eager port already
    has. ``state["step"]`` is a host int, the refresh dispatches without a
    sync, and steps between refreshes run no selection code. The subset step
    needs the refresh's pivots, so a side stream would only reorder the
    same work (``ROADMAP.md``, B7)."""
    return make_train_step(mcfg, tcfg)
