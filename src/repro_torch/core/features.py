"""Feature extraction for GRAFT (paper §3.1 Step 1).

Every extractor maps a batch matrix ``A ∈ R^{K×M}`` to ``V ∈ R^{K×R}`` with
columns ordered by descending relevance (singular value / variance), the
precondition for Fast MaxVol's sequential pivoting.

Only ``svd`` and ``pca`` are ported; the sketched, ICA and encoder
extractors of the JAX package wait for a later slice (``ROADMAP.md``).
Eigenvector signs depend on the LAPACK/cuSOLVER build, so ``V`` agrees
with the JAX reference up to column sign — which Fast MaxVol's pivots do
not see (``|W[:, j]|`` is sign-invariant column by column).
"""
from __future__ import annotations

import torch


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
        evals, evecs = torch.linalg.eigh(_finite(A @ A.T))  # ascending
        evals = torch.flip(evals, (-1,))[:rank]
        U = torch.flip(evecs, (-1,))[:, :rank]
        sigma = torch.sqrt(torch.clamp(evals, min=0.0))
    else:
        U, s, _ = torch.linalg.svd(_finite(A), full_matrices=False)
        U, sigma = U[:, :rank], s[:rank]
    return U * sigma[None, :]


def pca_features(A: torch.Tensor, rank: int) -> torch.Tensor:
    """PCA scores: mean-center then project onto top principal axes."""
    A = _flatten_batch(A)
    return svd_features(A - A.mean(dim=0, keepdim=True), rank)
