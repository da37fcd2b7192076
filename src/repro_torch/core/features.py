"""Feature extraction for GRAFT (paper §3.1 Step 1).

Every extractor maps a batch matrix ``A ∈ R^{K×M}`` to ``V ∈ R^{K×R}`` with
columns ordered by descending relevance (singular value / variance /
non-Gaussianity), the precondition for Fast MaxVol's sequential pivoting.

Eigenvector signs depend on the LAPACK/cuSOLVER build, so ``V`` agrees
with the JAX reference up to column sign — which Fast MaxVol's pivots do
not see (``|W[:, j]|`` is sign-invariant column by column).

The fixed random matrices (``sketch_svd``'s Ω, ICA's start W0, and the
``pca_sketch`` source's S) come from :func:`gaussian`: a CPU generator
seeded with the JAX package's seed, copied to the device. Its draws are
not ``jax.random``'s; the parity tests monkeypatch ``gaussian`` to inject
JAX's.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.analysis.sync_guard import sync_allowed

_SKETCH_SVD_SEED = 0x51E7
# cuSOLVER's eigh, svd and solve report failure in an info flag that PyTorch
# reads back to the host: a sync each that the JAX reference does not make,
# sanctioned under this name for train.audit
LINALG_SYNC = "linalg_info"
_ICA_SEED = 0


def _flatten_batch(A: torch.Tensor) -> torch.Tensor:
    return A.reshape(A.shape[0], -1).to(torch.float32)


def _finite(M: torch.Tensor) -> torch.Tensor:
    """Non-finite entries zeroed; finite ones untouched. ``torch.linalg``
    raises on a non-finite matrix (LAPACK / cuSOLVER report no convergence)
    where ``jnp.linalg`` returns NaN. A poisoned step must reach the train
    step's divergence sentinel, which discards its selection with its
    update, instead of crashing the run."""
    return torch.nan_to_num(M, nan=0.0, posinf=0.0, neginf=0.0)


def svd_features(A: torch.Tensor, rank: int) -> torch.Tensor:
    """Top-``rank`` left singular vectors of A, scaled by singular values.

    Uses the K×K Gram eigendecomposition when M ≥ K (cheaper, same U).
    Columns ordered by descending σ.
    """
    A = _flatten_batch(A)
    K, M = A.shape
    if M >= K:
        with sync_allowed(LINALG_SYNC):
            evals, evecs = torch.linalg.eigh(_finite(A @ A.T))  # ascending
        evals = torch.flip(evals, (-1,))[:rank]
        U = torch.flip(evecs, (-1,))[:, :rank]
        sigma = torch.sqrt(torch.clamp(evals, min=0.0))
    else:
        with sync_allowed(LINALG_SYNC):
            U, s, _ = torch.linalg.svd(_finite(A), full_matrices=False)
        U, sigma = U[:, :rank], s[:rank]
    return U * sigma[None, :]


def pca_features(A: torch.Tensor, rank: int) -> torch.Tensor:
    """PCA scores: mean-center then project onto top principal axes."""
    A = _flatten_batch(A)
    return svd_features(A - A.mean(dim=0, keepdim=True), rank)


@functools.lru_cache(maxsize=16)
def gaussian(seed: int, shape, device) -> torch.Tensor:
    """A standard-normal float32 matrix of ``shape``, drawn once per
    ``(seed, shape, device)`` on a CPU generator seeded ``seed`` and copied
    to ``device``: the same numbers on the card as on the CPU, and a basis
    that stays fixed between refreshes. Callers must not modify it."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32).to(device)


def sketch_svd_features(A: torch.Tensor, rank: int, oversample: int = 8,
                        power_iters: int = 0) -> torch.Tensor:
    """Randomized range-finder SVD features (Halko et al.; SAGE-style).

    Sketch ``A (K, M)`` to ``Y = A Ω (K, L)`` with a fixed Gaussian
    ``Ω (M, L)``, ``L = min(K, M, rank + oversample)``, orthonormalize the
    range basis and diagonalize the ``L×L`` Gram of ``B = QᵀA`` — the only
    eigendecomposition. ``power_iters`` adds subspace-iteration passes.
    Output ``U_r σ_r``, columns relevance-ordered, as ``svd_features`` up to
    the sketching error.
    """
    A = _flatten_batch(A)
    K, M = A.shape
    L = min(min(K, M), rank + oversample)
    Y = A @ gaussian(_SKETCH_SVD_SEED, (M, L), A.device)     # (K, L) range sample
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Y = A @ (A.T @ Q)
    Q, _ = torch.linalg.qr(Y)                                # (K, L) range basis
    B = Q.T @ A                                              # (L, M)
    with sync_allowed(LINALG_SYNC):
        evals, evecs = torch.linalg.eigh(_finite(B @ B.T))   # L×L — the only eigh
    evals = torch.flip(evals, (-1,))[:rank]
    U_small = torch.flip(evecs, (-1,))[:, :rank]
    sigma = torch.sqrt(torch.clamp(evals, min=0.0))
    return (Q @ U_small) * sigma[None, :]


def _canonical_signs(E: torch.Tensor) -> torch.Tensor:
    """Columns of ``E`` flipped so that each one's entry of largest
    magnitude is positive: eigenvectors that do not depend on the
    eigensolver's sign choice, so a card run and a CPU run whiten alike."""
    idx = torch.argmax(torch.abs(E), dim=0)
    signs = torch.sign(E.gather(0, idx[None, :]))
    return E * torch.where(signs == 0, torch.ones_like(signs), signs)


def ica_features(A: torch.Tensor, rank: int, iters: int = 64,
                 key: Optional[torch.Generator] = None) -> torch.Tensor:
    """FastICA (parallel, tanh contrast) on the whitened batch.

    Components are re-ordered by descending |excess kurtosis| (a stable
    sort), so that the relevance ordering holds. W0 is drawn from ``key``
    when given, else from :func:`gaussian` with seed 0. The whitening
    eigenvectors take canonical signs (``_canonical_signs``); the reference
    takes LAPACK's, so the port equals it for the W0 whose rows are flipped
    where the two sign choices differ.
    """
    A = _flatten_batch(A)
    X = A - A.mean(dim=0, keepdim=True)
    with sync_allowed(LINALG_SYNC):
        evals, evecs = torch.linalg.eigh(_finite(X @ X.T / X.shape[1]))
    evals = torch.flip(evals, (-1,))[:rank]
    E = _canonical_signs(torch.flip(evecs, (-1,))[:, :rank])
    Z = (E / torch.sqrt(torch.clamp(evals, min=1e-12))[None, :]).T   # (rank, K)
    if key is None:
        W0 = gaussian(_ICA_SEED, (rank, rank), A.device)
    else:
        W0 = torch.randn((rank, rank), generator=key, dtype=torch.float32,
                         device=key.device).to(A.device)

    def sym_decorrelate(W):
        # W ← (W Wᵀ)^{-1/2} W
        with sync_allowed(LINALG_SYNC):
            s, u = torch.linalg.eigh(_finite(W @ W.T))
        inv_sqrt = u @ torch.diag(1.0 / torch.sqrt(torch.clamp(s, min=1e-12))) @ u.T
        return inv_sqrt @ W

    W = sym_decorrelate(W0)
    for _ in range(iters):
        g = torch.tanh(W @ Z)                                # (rank, K) sources
        g_prime = 1.0 - g * g
        W = sym_decorrelate((g @ Z.T) / Z.shape[1] - torch.mean(g_prime, dim=1)[:, None] * W)
    S = (W @ Z).T                                            # (K, rank)
    kurt = torch.mean(S ** 4, dim=0) / torch.clamp(torch.mean(S ** 2, dim=0) ** 2,
                                                    min=1e-12) - 3.0
    return S[:, torch.argsort(-torch.abs(kurt), stable=True)]


def encoder_features(apply_fn: Callable[..., torch.Tensor], params, batch,
                     rank: int) -> torch.Tensor:
    """Model-based embeddings (the paper's AE / 'GRAFT Warm' path):
    ``apply_fn(params, batch) → (K, E)`` pooled hiddens, SVD-ordered down to
    ``rank`` columns."""
    return svd_features(apply_fn(params, batch), rank)


EXTRACTORS = {
    "svd": svd_features,
    "sketch_svd": sketch_svd_features,
    "pca": pca_features,
    "ica": ica_features,
}


def extract(mode: str, A: torch.Tensor, rank: int) -> torch.Tensor:
    if mode not in EXTRACTORS:
        raise KeyError(f"unknown feature extractor '{mode}' (have {list(EXTRACTORS)})")
    return EXTRACTORS[mode](A, rank)
