"""Sampler protocol + shared state for selection.

Every subset sampler implements one v2 signature —

    ``select(cfg, inputs, carry, step) -> (SelectionState, Carry)``

The *carry* is the sampler's cross-step state, created once by
``init_carry(cfg, spec)`` and threaded through every ``select`` call.
Stateless samplers carry the empty dict ``{}`` and return it unchanged.
Only the ``graft`` sampler is ported; the others of the JAX package are
listed in ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GraftConfig:
    """Static selection hyper-parameters — identical fields, defaults and
    validation to the JAX package's ``GraftConfig``."""
    rset: Tuple[int, ...] = (8, 16, 32, 64)   # candidate ranks, ascending
    eps: float = 0.25                          # projection-error threshold
    refresh_every: int = 20                    # S in the paper (20–50)
    feature_mode: str = "svd"                 # svd | sketch_svd | pca_sketch
                                              #   | pooled_raw | ica
    grad_mode: str = "probe"                  # probe | logit_embed | full
    use_pallas: bool = False                   # hand-written kernel vs the
                                              # unfused torch chain (the
                                              # name is the JAX package's)
    overlap: bool = False                      # double-buffered refresh/train
                                              # overlap; excluded from
                                              # config_hash
    # -- streaming (not ported; inert unless streaming_graft is selected) --
    streaming: bool = False
    sketch_rows: int = 64
    sketch_decay: float = 0.99
    stream_mix: float = 0.5

    def __post_init__(self):
        if tuple(sorted(self.rset)) != tuple(self.rset):
            raise ValueError("rset must be ascending")
        if self.sketch_rows < 1:
            raise ValueError("sketch_rows must be >= 1")
        if not 0.0 <= self.sketch_decay <= 1.0:
            raise ValueError("sketch_decay must be in [0, 1]")
        if not 0.0 <= self.stream_mix <= 1.0:
            raise ValueError("stream_mix must be in [0, 1]")

    @property
    def r_max(self) -> int:
        return self.rset[-1]


SamplerConfig = GraftConfig


class SelectionState(NamedTuple):
    """Carried across training steps (tiny, on the training device)."""
    pivots: torch.Tensor       # (R_max,) int32 — current subset, pivot order
    weights: torch.Tensor      # (R_max,) f32 — sum 1 over active, 0 inactive
    rank: torch.Tensor         # () int32 — current R*
    last_error: torch.Tensor   # () f32 — projection error at R*
    alignment: torch.Tensor    # () f32 — cos(subset ḡ, batch ḡ) diagnostic
    step: torch.Tensor         # () int32


class SelectionInputs(NamedTuple):
    """Per-batch selection inputs. ``scores`` are per-sample scalars for
    score-ranked samplers; ``key`` drives stochastic samplers. The engines
    pass a caller's ``key``/``keys`` through per lane and derive none (no
    ported sampler draws random numbers), so it is ``None`` unless given."""
    V: torch.Tensor                        # (K, R_max) relevance-ordered features
    G: torch.Tensor                        # (d, K) per-sample grad embeddings
    g_bar: torch.Tensor                    # (d,) batch mean gradient
    scores: Optional[torch.Tensor] = None  # (K,) per-sample scores
    key: Optional[Any] = None


def init_state(cfg: GraftConfig, batch_size: int,
               device: torch.device | str = "cpu") -> SelectionState:
    r = cfg.r_max
    if r > batch_size:
        raise ValueError(f"r_max {r} > batch size {batch_size}")
    return SelectionState(
        pivots=torch.arange(r, dtype=torch.int32, device=device),
        weights=torch.full((r,), 1.0 / r, dtype=torch.float32, device=device),
        rank=torch.tensor(r, dtype=torch.int32, device=device),
        last_error=torch.tensor(1.0, dtype=torch.float32, device=device),
        alignment=torch.tensor(0.0, dtype=torch.float32, device=device),
        step=torch.tensor(0, dtype=torch.int32, device=device),
    )


class CarrySpec(NamedTuple):
    """Static shape info a sampler needs to size its carry before the first
    batch exists: ``batch_size`` is K, ``grad_dim`` is d."""
    batch_size: int
    grad_dim: int

    @classmethod
    def from_inputs(cls, inputs: SelectionInputs) -> "CarrySpec":
        return cls(batch_size=int(inputs.V.shape[0]),
                   grad_dim=int(inputs.G.shape[0]))


EMPTY_CARRY: dict = {}

Carry = Any


@dataclasses.dataclass(frozen=True)
class Sampler:
    """A registered selection strategy (v2 protocol).

    Stateless strategies provide ``fn(cfg, inputs, step) -> SelectionState``
    and carry ``{}``; stateful ones provide ``select_fn(cfg, inputs, carry,
    step) -> (SelectionState, carry')`` plus ``init_carry_fn(cfg, spec)``.
    ``needs_scores``/``needs_key`` are validated by :meth:`select`.
    """
    name: str
    fn: Optional[Callable[[GraftConfig, SelectionInputs, torch.Tensor],
                          SelectionState]] = None
    needs_scores: bool = False
    needs_key: bool = False
    select_fn: Optional[Callable[..., Tuple[SelectionState, Carry]]] = None
    init_carry_fn: Optional[Callable[[GraftConfig, CarrySpec], Carry]] = None

    def __post_init__(self):
        if (self.fn is None) == (self.select_fn is None):
            raise ValueError(
                f"sampler '{self.name}' must define exactly one of fn "
                f"(stateless) or select_fn (stateful)")

    @property
    def stateful(self) -> bool:
        return self.select_fn is not None

    def _require(self, field: str) -> None:
        raise ValueError(
            f"sampler '{self.name}' requires SelectionInputs.{field} — "
            f"pass {field}=...")

    def init_carry(self, cfg: GraftConfig, spec: CarrySpec) -> Carry:
        """The sampler's initial cross-step state; ``{}`` when stateless."""
        if self.init_carry_fn is not None:
            return self.init_carry_fn(cfg, spec)
        return EMPTY_CARRY

    def select(self, cfg: GraftConfig, inputs: SelectionInputs,
               carry: Carry = None, step=0) -> Tuple[SelectionState, Carry]:
        """Run one selection: ``(state, carry')``. ``carry=None`` initializes
        a fresh carry from the input shapes."""
        if self.needs_scores and inputs.scores is None:
            self._require("scores")
        if self.needs_key and inputs.key is None:
            self._require("key")
        if carry is None:
            carry = self.init_carry(cfg, CarrySpec.from_inputs(inputs))
        step_t = torch.as_tensor(step, dtype=torch.int32, device=inputs.V.device)
        if self.select_fn is not None:
            return self.select_fn(cfg, inputs, carry, step_t)
        return self.fn(cfg, inputs, step_t), carry

    def init_state(self, cfg: GraftConfig, batch_size: int,
                   device: torch.device | str = "cpu") -> SelectionState:
        return init_state(cfg, batch_size, device)
