"""AdamW with global-norm clipping, written out in PyTorch (no
``torch.optim``), with the JAX package's arithmetic: the update is computed
in float32 and cast back to each parameter's and moment's dtype.

API: ``opt = make_optimizer(cfg); state = opt.init(params);
metrics = opt.apply(params, grads, state, step)``. ``params`` is a list of
parameters, updated IN PLACE (the JAX version returns new arrays); ``grads``
a matching list. ``apply`` is ``preprocess`` (clip, grad norm) followed by
``update``; the train step calls the two halves itself so that the
divergence sentinel can veto the update in between. ``lr(step)`` is the
schedule. SGD, Lion and Adafactor are not ported (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    init: Callable[[Sequence[torch.Tensor]], Dict[str, List[torch.Tensor]]]
    apply: Callable[..., Dict[str, Any]]
    preprocess: Callable[[Sequence[torch.Tensor]],
                         Tuple[List[torch.Tensor], Dict[str, Any]]]
    update: Callable[..., float]
    lr: Callable[[int], float]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over every tensor of Σ x²), in float32, on the device."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads], norm


def _lr_fn(cfg: OptimizerConfig):
    from repro_torch.optim.schedules import SCHEDULES
    sched = SCHEDULES[cfg.schedule]
    if cfg.schedule == "constant":
        return sched(cfg.learning_rate)
    return sched(cfg.learning_rate, cfg.total_steps, cfg.warmup_steps)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name != "adamw":
        raise NotImplementedError(
            f"optimizer '{cfg.name}' is not ported to repro_torch yet; only "
            "adamw is (see ROADMAP.md)")
    lr_fn = _lr_fn(cfg)
    sdt = _STATE_DTYPES[cfg.state_dtype]
    f32 = np.float32

    def init(params):
        return {"m": [torch.zeros(p.shape, dtype=sdt, device=p.device) for p in params],
                "v": [torch.zeros(p.shape, dtype=sdt, device=p.device) for p in params]}

    def preprocess(grads):
        if cfg.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        else:
            gnorm = global_norm(grads)
        return list(grads), {"grad_norm": gnorm}

    @torch.no_grad()
    def update(params, grads, state, step: int) -> float:
        lr = lr_fn(step)
        t = f32(step) + f32(1.0)
        bc1 = float(f32(1.0) - f32(cfg.beta1) ** t)
        bc2 = float(f32(1.0) - f32(cfg.beta2) ** t)
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            gf = g.to(torch.float32)
            m_new = cfg.beta1 * m.to(torch.float32) + (1 - cfg.beta1) * gf
            v_new = cfg.beta2 * v.to(torch.float32) + (1 - cfg.beta2) * gf * gf
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            upd = upd + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
            m.copy_(m_new.to(sdt))
            v.copy_(v_new.to(sdt))
        return lr

    def apply(params, grads, state, step: int):
        grads, metrics = preprocess(grads)
        metrics["lr"] = update(params, grads, state, step)
        return metrics

    return Optimizer(init, apply, preprocess, update, lr_fn)
