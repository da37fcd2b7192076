"""Feature-extractor / gradient-source registries for the selection inputs.

``launch/steps.py:selection_inputs`` resolves the feature path (the ``V``
matrix MaxVol pivots on) from ``GraftConfig.feature_mode`` and the
gradient-embedding path (the ``G`` matrix the rank sweep projects) from
``GraftConfig.grad_mode``, the JAX package's names in its order:

  * features ``svd`` (default), ``sketch_svd`` (randomized range finder),
    ``pca_sketch`` (Gaussian sketch to O(rank) columns, then PCA),
    ``pooled_raw`` (energy-ordered raw columns) and ``ica`` (FastICA,
    kurtosis-ordered);
  * grad sources ``probe`` (default; the softmax error signal, no extra
    backward), ``logit_embed`` (the exact head-input gradient ``Wᵀ(p − y)``)
    and ``full`` (exact per-sample gradients of every parameter, through
    ``torch.func``; smoke sizes only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import features as features_lib
from repro_torch.core.numerics import one_hot_valid
from repro_torch.core.grad_features import logit_error_embeddings, per_sample_grads_full
from repro_torch.distributed.sharding import materialize
from repro_torch.registry import Registry

# what the ``full`` source may hold as its (K, |Θ|) float32 gradient matrix:
# K = 16 full gradients of minicpm-2b's 2.7 B parameters would be 174 GB
FULL_GRAD_BYTES_LIMIT = 4 * 1024 ** 3


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


_FEATURES: Registry = Registry("feature extractor")
_GRAD_SOURCES: Registry = Registry("grad source")


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


def available_features() -> Tuple[str, ...]:
    return _FEATURES.available()


def available_grad_sources() -> Tuple[str, ...]:
    return _GRAD_SOURCES.available()


# ---------------------------------------------------------------------------
# built-in feature extractors
# ---------------------------------------------------------------------------

_SKETCH_SEED = 0x5A6E


def pca_sketch_features(A: torch.Tensor, rank: int) -> torch.Tensor:
    """Gaussian sketch to ``max(4·rank, rank + 8)`` columns, then PCA. The
    sketch matrix is a fixed function of its shape (``features.gaussian``,
    seed ``0x5A6E``), so the feature basis is stable between refreshes."""
    A = A.reshape(A.shape[0], -1).to(torch.float32)
    M = A.shape[1]
    width = min(M, max(4 * rank, rank + 8))
    if M > width:
        S = features_lib.gaussian(_SKETCH_SEED, (M, width), A.device)
        A = A @ (S / torch.sqrt(torch.tensor(width, dtype=torch.float32)))
    return features_lib.pca_features(A, rank)


def pooled_raw_features(A: torch.Tensor, rank: int) -> torch.Tensor:
    """Raw pooled matrix, columns ordered by descending energy (a stable
    sort) and truncated to ``rank``; zero-padded to ``rank`` columns when
    the source has fewer."""
    A = A.reshape(A.shape[0], -1).to(torch.float32)
    K, M = A.shape
    cols = min(rank, M)
    order = torch.argsort(-torch.sum(A * A, dim=0), stable=True)[:cols]
    V = A.index_select(1, order)
    if cols < rank:
        V = torch.cat([V, torch.zeros((K, rank - cols), dtype=torch.float32,
                                      device=A.device)], dim=1)
    return V


SVD = register_features(FeatureExtractor("svd", features_lib.svd_features))
SKETCH_SVD = register_features(
    FeatureExtractor("sketch_svd", features_lib.sketch_svd_features))
PCA_SKETCH = register_features(FeatureExtractor("pca_sketch", pca_sketch_features))
POOLED_RAW = register_features(FeatureExtractor("pooled_raw", pooled_raw_features))
ICA = register_features(FeatureExtractor("ica", features_lib.ica_features))


# ---------------------------------------------------------------------------
# built-in gradient sources
# ---------------------------------------------------------------------------

def probe_grad_source(inp: GradSourceInputs) -> torch.Tensor:
    """Probe-gradient surrogate from the softmax error signal (no backward):
    loss-scaled, error-norm-weighted pooled hiddens over labeled positions."""
    return logit_error_embeddings(inp.logits, inp.labels, inp.hiddens,
                                  mask=inp.mask)


def logit_embed_grad_source(inp: GradSourceInputs) -> torch.Tensor:
    """Exact per-example gradient of the probe CE w.r.t. the head input,
    ``Wᵀ(p − y)`` averaged over labeled probe positions — one extra matmul
    with the unembedding, no backward. Returns (K, d_model).

    The reference builds ``one_hot(labels)`` as a (K, S', V) tensor; the
    port subtracts 1 at each label in place (the same arithmetic: ``p − 0``
    is ``p``), which saves 2 GB at minicpm-2b's vocabulary. A label outside
    the vocabulary subtracts nothing, as its all-zero one-hot row does."""
    mcfg, params = inp.mcfg, inp.params
    if mcfg is not None and getattr(mcfg, "tie_embeddings", False):
        head = materialize(params["embed"]).T          # (D, V)
    elif "lm_head" in params:
        head = materialize(params["lm_head"])
    elif "embed" in params:
        head = materialize(params["embed"]).T
    else:
        raise ValueError("logit_embed grad source needs an unembedding "
                         "('lm_head' or tied 'embed') in params")
    err = torch.exp(torch.log_softmax(inp.logits.to(torch.float32), dim=-1))   # p
    idx, valid = one_hot_valid(inp.labels, err.shape[-1])
    err.scatter_add_(-1, idx[..., None],                                    # p − y
                     torch.where(valid, -1.0, 0.0).to(err.dtype)[..., None])
    if inp.mask is not None:
        m = inp.mask.to(torch.float32)
        err.mul_(m[..., None])
        count = torch.clamp(torch.sum(m, dim=-1, keepdim=True), min=1.0)
    else:
        count = float(err.shape[1])
    # jnp.einsum sums the positions out first, then contracts V
    emb = err.sum(dim=1) @ head.to(torch.float32).T
    return emb / count


def _param_count(mcfg: Any, params: Any) -> int:
    if isinstance(params, torch.Tensor):
        return math.prod(params.shape)
    items = params.values() if isinstance(params, dict) else params
    return sum(_param_count(mcfg, v) for v in items)


def full_grad_source(inp: GradSourceInputs) -> torch.Tensor:
    """EXACT per-sample gradients of the WHOLE parameter pytree, Alg. 1
    without the last-layer approximation: one backward per example of the
    raw batch through the model as configured (the flash or RWKV kernels on
    the card), flattened in the JAX leaf order. Returns (K, |Θ|) — the
    oracle for small models. A (K, |Θ|) matrix above
    ``FULL_GRAD_BYTES_LIMIT`` is refused."""
    from repro_torch.models import model as model_lib
    K = next(iter(inp.batch.values())).shape[0]
    need = 4 * K * _param_count(inp.mcfg, inp.params)
    if need > FULL_GRAD_BYTES_LIMIT:
        raise ValueError(
            f"grad source 'full' needs a (K, |params|) float32 matrix of {need / 1e9:.1f} GB "
            f"(limit {FULL_GRAD_BYTES_LIMIT / 1e9:.1f} GB): per-sample full gradients are "
            f"for smoke-size models; use grad_mode=probe or logit_embed")

    def one_example_loss(params, example):
        b = {k: v[None] for k, v in example.items()}
        return model_lib.loss_fn(inp.mcfg, params, b)[0]

    G, _ = per_sample_grads_full(one_example_loss, inp.params, inp.batch)
    return G.T                                          # (K, |Θ|) f32


PROBE = register_grad_source(GradSource("probe", probe_grad_source))
LOGIT_EMBED = register_grad_source(
    GradSource("logit_embed", logit_embed_grad_source, needs_params=True))
FULL = register_grad_source(
    GradSource("full", full_grad_source, needs_params=True, needs_batch=True,
               embed_dim_of=_param_count))
