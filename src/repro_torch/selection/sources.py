"""Feature-extractor / gradient-source registries for the selection inputs.

``launch/steps.py:selection_inputs`` resolves the feature path (the ``V``
matrix MaxVol pivots on) from ``GraftConfig.feature_mode`` and the
gradient-embedding path (the ``G`` matrix the rank sweep projects) from
``GraftConfig.grad_mode``. The port has feature source ``svd`` and grad
source ``probe``; the others of the JAX package raise
``NotImplementedError`` pointing to ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import features as features_lib
from repro_torch.core.grad_features import logit_error_embeddings
from repro_torch.registry import Registry


class GradSourceInputs(NamedTuple):
    """Everything a gradient source may read: probe-position slices of the
    logits/labels/hiddens (K, S', ·), the model config and params, the raw
    batch, and the (K, S') loss mask (``None`` = every position labeled)."""
    logits: torch.Tensor
    labels: torch.Tensor
    hiddens: torch.Tensor
    mcfg: Any = None
    params: Any = None
    batch: Any = None
    mask: Any = None


@dataclasses.dataclass(frozen=True)
class FeatureExtractor:
    """A registered feature path: ``fn(A, rank) → V`` with ``A`` the pooled
    per-example matrix (K, M) and ``V`` (K, rank) relevance-ordered."""
    name: str
    fn: Callable[[torch.Tensor, int], torch.Tensor]

    def __call__(self, A: torch.Tensor, rank: int) -> torch.Tensor:
        return self.fn(A, rank)


@dataclasses.dataclass(frozen=True)
class GradSource:
    """A registered gradient-embedding path: ``fn(inputs) → (K, E)``."""
    name: str
    fn: Callable[[GradSourceInputs], torch.Tensor]
    needs_params: bool = False
    needs_batch: bool = False
    embed_dim_of: Optional[Callable[[Any, Any], int]] = None

    def embed_dim(self, mcfg: Any, params: Any) -> int:
        if self.embed_dim_of is not None:
            return int(self.embed_dim_of(mcfg, params))
        return int(mcfg.d_model)

    def __call__(self, inputs: GradSourceInputs) -> torch.Tensor:
        if self.needs_params and inputs.params is None:
            raise ValueError(
                f"grad source '{self.name}' requires GradSourceInputs.params")
        if self.needs_batch and inputs.batch is None:
            raise ValueError(
                f"grad source '{self.name}' requires GradSourceInputs.batch")
        return self.fn(inputs)


_FEATURES: Registry = Registry(
    "feature extractor",
    not_ported=("sketch_svd", "pca_sketch", "pooled_raw", "ica"))
_GRAD_SOURCES: Registry = Registry(
    "grad source", not_ported=("logit_embed", "full"))


def register_features(extractor: FeatureExtractor, *,
                      overwrite: bool = False) -> FeatureExtractor:
    return _FEATURES.register(extractor.name, extractor, overwrite=overwrite)


def register_grad_source(source: GradSource, *,
                         overwrite: bool = False) -> GradSource:
    return _GRAD_SOURCES.register(source.name, source, overwrite=overwrite)


def resolve_features(name: Union[str, FeatureExtractor]) -> FeatureExtractor:
    if isinstance(name, FeatureExtractor):
        return name
    return _FEATURES.get(name)


def resolve_grad_source(name: Union[str, GradSource]) -> GradSource:
    if isinstance(name, GradSource):
        return name
    return _GRAD_SOURCES.get(name)


def probe_grad_source(inp: GradSourceInputs) -> torch.Tensor:
    """Probe-gradient surrogate from the softmax error signal (no backward):
    loss-scaled, error-norm-weighted pooled hiddens over labeled positions."""
    return logit_error_embeddings(inp.logits, inp.labels, inp.hiddens,
                                  mask=inp.mask)


SVD = register_features(FeatureExtractor("svd", features_lib.svd_features))
PROBE = register_grad_source(GradSource("probe", probe_grad_source))
