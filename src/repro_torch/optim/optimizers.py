"""Optimizers written out in PyTorch (no ``torch.optim``) with the JAX
package's arithmetic: AdamW, SGD + momentum, Lion and Adafactor with
factored second moments. Each update is computed in float32 and cast back
to each parameter's and state's dtype.

API: ``opt = make_optimizer(cfg); state = opt.init(params);
metrics = opt.apply(params, grads, state, step)``. ``params`` is a list of
parameters, updated IN PLACE (the JAX version returns new arrays); ``grads``
a matching list. ``apply`` is ``preprocess`` (grad norm and clip) followed
by ``update``; the train step calls the two halves itself so that the
divergence sentinel can veto the update in between. ``lr(step)`` is the
schedule.

On CUDA tensors the step is two hand-written kernels
(``kernels/fused_optim.py``): ``preprocess`` computes the global norm and
the clip factor in one launch and returns the gradients untouched, as
:class:`ClippedGrads` carrying that factor on the device; ``update`` applies
it inside one fused update launch per dtype group (AdamW, SGD, Lion).
Adafactor updates in plain PyTorch on either device (its row and column
means are reductions, not an elementwise pass); on the card it takes the
kernel's factor and clips with JAX's rounding. On CPU tensors the step is
the plain code: ``clip_by_global_norm``, then the per-leaf update.

Adafactor factors a leaf over its trailing two dims. A JAX leaf that the
port keeps as one tensor per block (the blocks are stacked on L in the JAX
tree) is factored across the stack, as in JAX: ``init(params, groups)``
takes the JAX leaves, each the index of one param or a list of the indices
of the params stacked on a new axis 0, and the state holds one entry per
group (``groups=None``: every param is a leaf of its own). The other
optimizers are elementwise and ignore ``groups``.

On a sharded state (``update(..., shardings)``, each param its rank's
shard and its ``sharding.LeafSharding``) Adafactor's factored moments are
those of the whole leaf: a row or column mean over a dim that a mesh axis
splits is the ``psum`` of the shards' sums over that axis divided by the
dim's global size, the update's RMS the ``psum`` over the axes that split
the leaf (each shard counted once), and ``vr``/``vc`` hold this rank's
rows and columns of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, fused_optim

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("adamw", "sgd", "lion", "adafactor")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # adamw | sgd | lion | adafactor
    learning_rate: float = 1e-3
    schedule: str = "cosine"        # constant | cosine | wsd | linear
    total_steps: int = 1000
    warmup_steps: int = 100
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"    # bfloat16 halves m/v memory at scale


class Optimizer(NamedTuple):
    """``update(params, grads, state, step, shardings=None)``: ``shardings``
    the params' ``LeafSharding``s where they are a sharded state's shards
    (read by Adafactor's means; the elementwise rules need none)."""
    init: Callable[..., Dict[str, Any]]
    apply: Callable[..., Dict[str, Any]]
    preprocess: Callable[..., Tuple[List[torch.Tensor], Dict[str, Any]]]
    update: Callable[..., float]
    lr: Callable[[int], float]


class ClippedGrads(list):
    """Gradients whose clip is still to apply: ``clip_scale`` is the device
    scalar ``min(1, clip_norm / (norm + 1e-9))`` that the update multiplies
    each gradient by (rounding the product to the gradient's dtype) before
    it uses it."""

    def __init__(self, grads: Sequence[torch.Tensor], clip_scale: torch.Tensor):
        super().__init__(grads)
        self.clip_scale = clip_scale


global_norm = fused_optim.global_norm_reference


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    return fused_optim.scale_grads(grads, fused_optim.clip_scale_reference(norm, max_norm)), norm


def _lr_fn(cfg: OptimizerConfig):
    from repro_torch.optim.schedules import SCHEDULES
    sched = SCHEDULES[cfg.schedule]
    if cfg.schedule == "constant":
        return sched(cfg.learning_rate)
    return sched(cfg.learning_rate, cfg.total_steps, cfg.warmup_steps)


def _on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    return bool(tensors) and build.on_card(tensors[0])


def _unclipped(grads) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    return list(grads), getattr(grads, "clip_scale", None)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name not in NAMES:
        raise ValueError(f"unknown optimizer '{cfg.name}' (have {NAMES})")
    lr_fn = _lr_fn(cfg)
    sdt = _STATE_DTYPES[cfg.state_dtype]
    f32 = np.float32

    def zeros(params):
        return [torch.zeros(p.shape, dtype=sdt, device=p.device) for p in params]

    def preprocess(grads, counted=None, reduce=None):
        """(grads, {"grad_norm"}): on the card the norm kernel's factor
        rides the untouched grads; on the CPU the clipped copies. With
        ``reduce`` (a state sharded over ranks) the norm is the global one:
        this rank's sum of squares covers the leaves ``counted`` flags, and
        ``reduce`` adds the ranks' sums (kernel A split)."""
        grads = list(grads)
        if reduce is not None:
            mine = [g for g, c in zip(grads, counted) if c]
            norm, scale = fused_optim.grad_norm(mine, cfg.clip_norm, reduce,
                                                device=grads[0].device)
            if cfg.clip_norm is None:
                return grads, {"grad_norm": norm}
            if _on_cuda(grads):
                return ClippedGrads(grads, scale), {"grad_norm": norm}
            return fused_optim.scale_grads(grads, scale), {"grad_norm": norm}
        if _on_cuda(grads):
            norm, scale = fused_optim.grad_norm(grads, cfg.clip_norm)
            return (ClippedGrads(grads, scale) if cfg.clip_norm is not None else grads,
                    {"grad_norm": norm})
        if cfg.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        else:
            gnorm = global_norm(grads)
        return grads, {"grad_norm": gnorm}

    def hyper(step: int) -> fused_optim.Hyper:
        t = f32(step) + f32(1.0)
        return fused_optim.Hyper(
            lr=lr_fn(step), beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, momentum=cfg.momentum,
            bc1=float(f32(1.0) - f32(cfg.beta1) ** t),
            bc2=float(f32(1.0) - f32(cfg.beta2) ** t))

    if cfg.name == "adafactor":
        init, update = _adafactor(cfg, lr_fn, sdt)
    else:
        def init(params, groups=None):
            state = {"m": zeros(params)}
            if cfg.name == "adamw":
                state["v"] = zeros(params)
            return state

        @torch.no_grad()
        def update(params, grads, state, step: int, shardings=None) -> float:
            grads, scale = _unclipped(grads)
            hp = hyper(step)
            fused_optim.optimizer_update(cfg.name, params, grads, state["m"],
                                         state.get("v"), hp, scale)
            return hp.lr

    def apply(params, grads, state, step: int):
        grads, metrics = preprocess(grads)
        metrics["lr"] = update(params, grads, state, step)
        return metrics

    return Optimizer(init, apply, preprocess, update, lr_fn)


def _adafactor(cfg: OptimizerConfig, lr_fn, sdt: torch.dtype):
    """Adafactor (``repro/optim/optimizers.py:166-216``): factored second
    moments ``vr``/``vc`` over a leaf's trailing two dims (``v`` for 1-D
    leaves), decay ``1 - t^-0.8``, update clipping at RMS 1. Plain PyTorch
    on every device; on a sharded state the means and the RMS span the
    whole leaf (``_Leaf``)."""
    f32 = torch.float32

    def init(params, groups=None):
        groups = list(range(len(params))) if groups is None else list(groups)
        v = []
        for grp in groups:
            idx = grp if isinstance(grp, list) else [grp]
            shape = tuple(params[idx[0]].shape)
            if isinstance(grp, list):
                shape = (len(idx),) + shape
            dev = params[idx[0]].device
            if len(shape) >= 2:
                v.append({"vr": torch.zeros(shape[:-1], dtype=sdt, device=dev),
                          "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=sdt, device=dev)})
            else:
                v.append({"v": torch.zeros(shape, dtype=sdt, device=dev)})
        return {"v": v, "groups": groups}

    @torch.no_grad()
    def update(params, grads, state, step: int, shardings=None) -> float:
        grads, scale = _unclipped(grads)
        lr = lr_fn(step)
        t = np.float32(step) + np.float32(1.0)
        beta2t = float(np.float32(1.0) - t ** np.float32(-0.8))
        for grp, s in zip(state["groups"], state["v"]):
            stacked = isinstance(grp, list)
            if stacked:
                p = torch.stack([params[i] for i in grp])
                g = torch.stack([grads[i] for i in grp])
            else:
                p, g = params[grp], grads[grp]
            if scale is not None:           # the clip, a leaf at a time
                g = fused_optim.scale_grads([g], scale)[0]
            first = grp[0] if stacked else grp
            leaf = _Leaf(shardings[first] if shardings is not None else None, p.ndim,
                         len(grp) if stacked else None)
            # the arithmetic of JAX's update, in place where a float32 copy
            # of a stacked leaf would otherwise stay alive (a layer stack of
            # experts is GBs): the same operations in the same order
            gf = g.to(f32, copy=True)
            del g
            g2 = gf * gf + 1e-30
            if p.ndim >= 2:
                vr = beta2t * s["vr"].to(f32) + (1 - beta2t) * leaf.mean(g2, -1)
                vc = beta2t * s["vc"].to(f32) + (1 - beta2t) * leaf.mean(g2, -2)
                del g2
                denom = (vr[..., None] * vc[..., None, :]) / (
                    leaf.mean(vr, -2, keepdim=True)[..., None] + 1e-30)
                upd = gf.div_(denom.sqrt_().add_(1e-30))
                del denom
                s["vr"].copy_(vr.to(sdt))
                s["vc"].copy_(vc.to(sdt))
            else:
                vv = beta2t * s["v"].to(f32) + (1 - beta2t) * g2
                upd = gf / (torch.sqrt(vv) + 1e-30)
                s["v"].copy_(vv.to(sdt))
            rms = torch.sqrt(leaf.mean_all(upd * upd) + 1e-30)
            upd.div_(torch.clamp(rms, min=1.0))
            pf = p.to(f32, copy=True)
            step_ = pf * cfg.weight_decay
            pf.sub_(step_.add_(upd).mul_(lr))
            del upd, step_
            p_new = pf.to(p.dtype)
            if stacked:
                for k, i in enumerate(grp):
                    params[i].copy_(p_new[k])
            else:
                p.copy_(p_new)
        return lr

    return init, update


class _Leaf:
    """The means Adafactor takes over one JAX leaf: ``sharding`` is its
    param's ``LeafSharding`` (None: the leaf is whole here), ``stack`` the
    number of blocks stacked on a new dim 0 (None: not stacked). A mean
    over a dim that mesh axes split sums the shards over those axes; the
    stack's dim is never split."""

    def __init__(self, sharding, ndim: int, stack: Optional[int]):
        self.sharding, self.ndim, self.stack = sharding, ndim, stack

    def _axes_and_size(self, dim: int) -> Tuple[Tuple[str, ...], int]:
        """The axes that split the leaf's dim ``dim`` (< 0) and its global
        size."""
        s = self.sharding
        shape = ((self.stack,) if self.stack is not None else ()) + tuple(s.shape)
        spec = ((None,) if self.stack is not None else ()) + tuple(s.spec)
        axes = tuple(a for a in ((spec[dim],) if isinstance(spec[dim], str)
                                 else (spec[dim] or ())) if s.mesh.shape[a] > 1)
        return axes, shape[dim]

    def mean(self, x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
        """The global mean over the leaf's dim ``dim`` (< 0; also that dim of
        a tensor factored from the leaf, such as ``vr``, whose trailing dim
        is the leaf's ``dim``) of this rank's ``x``."""
        xdim = dim if x.dim() == self.ndim else -1
        axes, n = self._axes_and_size(dim) if self.sharding is not None else ((), 0)
        if not axes:
            return torch.mean(x, dim=xdim, keepdim=keepdim)
        return self.sharding.mesh.psum(torch.sum(x, dim=xdim, keepdim=keepdim), axes) / n

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean over the whole leaf of this rank's ``x``."""
        axes = () if self.sharding is None else tuple(
            a for a in self.sharding.sharded_axes if self.sharding.mesh.shape[a] > 1)
        if not axes:
            return torch.mean(x)
        n = float(np.prod(self.sharding.shape, dtype=np.float64)) * (self.stack or 1)
        return self.sharding.mesh.psum(torch.sum(x), axes) / n
