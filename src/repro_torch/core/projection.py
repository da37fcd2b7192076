"""Gradient projection error + dynamic rank selection (paper §3.2).

Given the full-batch mean gradient ``ḡ`` and the per-sample gradient matrix
``G ∈ R^{d×R}`` of the MaxVol-ordered candidates, the projection error at
prefix rank ``r`` is ``d_r = ‖ḡ − P_r ḡ‖² / ‖ḡ‖²`` where ``P_r`` projects
onto the span of the first ``r`` columns. Because Fast MaxVol pivots are
prefix-consistent, one Gram-Schmidt sweep yields every candidate rank's
error (Lemma 1: errors are the residual energies, monotone in r).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.numerics import device_scalar

_EPS = 1e-12


def prefix_projection_errors(G: torch.Tensor, g_bar: torch.Tensor) -> torch.Tensor:
    """Normalized projection errors for every prefix rank 1..R.

    ``G``: (d, R) per-sample gradients in MaxVol pivot order; ``g_bar``:
    (d,) reference gradient. Returns ``err`` (R,) with
    ``err[r-1] = 1 − ‖Q_rᵀ ĝ‖²``, clipped to [0, 1].

    Each column is orthogonalized by two classical Gram-Schmidt passes
    (CGS2): every pass takes all its coefficients from the same ``q``,
    ``q ← q − Q (Qᵀ q)``, with ``Q`` holding zeros in the columns not yet
    filled — the arithmetic of the JAX reference.
    """
    d, R = G.shape
    Gf = G.to(torch.float32)
    g = g_bar.to(torch.float32)
    g_hat = g / torch.sqrt(torch.sum(g * g) + _EPS)
    Q = torch.zeros((d, R), dtype=torch.float32, device=G.device)
    captured = torch.zeros((), dtype=torch.float32, device=G.device)
    errs = []
    for j in range(R):
        q = Gf[:, j]
        for _ in range(2):
            q = q - Q @ (Q.T @ q)
        nrm = torch.sqrt(torch.sum(q * q))
        q = torch.where(nrm > 1e-8, q / (nrm + _EPS), torch.zeros_like(q))
        Q[:, j] = q
        captured = captured + torch.sum(q * g_hat) ** 2
        errs.append(1.0 - captured)
    return torch.clamp(torch.stack(errs), 0.0, 1.0)


def select_rank(errors: torch.Tensor, rset: Sequence[int],
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest candidate rank whose error ≤ eps (else fall back to R_max).

    ``errors``: prefix errors (R_max,); ``rset``: ascending candidate ranks.
    Returns ``(rank, err_at_rank)`` as 0-d device tensors (no host sync).
    When no candidate satisfies eps the largest candidate wins: by Lemma 1
    R_max is also the error minimizer, and a tie-break must never pick a
    SMALLER rank on a flat error plateau.
    """
    # the candidates cross from host memory without a wait for the stream
    cand = torch.tensor(tuple(rset), dtype=torch.int32).to(errors.device, non_blocking=True)
    cand_err = errors[(cand - 1).long()]
    ok = cand_err <= eps
    first_ok = torch.argmax(ok.to(torch.int32))     # first True (0 if none)
    idx = torch.where(ok.any(), first_ok,
                      device_scalar(len(rset) - 1, torch.int64, errors.device)).view(1)
    # index_select with a 1-element index: a 0-d index would be read to the host
    return cand.index_select(0, idx)[0], cand_err.index_select(0, idx)[0]


def projection_error(G: torch.Tensor, g_bar: torch.Tensor) -> torch.Tensor:
    """Single-rank normalized projection error ‖ḡ − G G† ḡ‖²/‖ḡ‖² via QR."""
    q, _ = torch.linalg.qr(G.to(torch.float32), mode="reduced")
    g = g_bar.to(torch.float32)
    g_norm2 = torch.sum(g * g) + _EPS
    coeffs = q.T @ g
    return torch.clamp(1.0 - torch.sum(coeffs * coeffs) / g_norm2, 0.0, 1.0)


def cosine_alignment(g_sub: torch.Tensor, g_bar: torch.Tensor) -> torch.Tensor:
    """cos(subset mean gradient, full-batch mean gradient) — Fig. 2 metric."""
    a = g_sub.to(torch.float32)
    b = g_bar.to(torch.float32)
    return torch.sum(a * b) / (torch.linalg.norm(a) * torch.linalg.norm(b) + _EPS)
