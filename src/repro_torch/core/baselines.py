"""Subset-selection baselines the paper compares against (§2, §4).

The port of the JAX package's ``core/baselines.py``: Random, GradMatch
(OMP), CRAIG (facility-location greedy), GLISTER (one-step validation
gain) and EL2N pre-scoring, on the same inputs GRAFT sees. The JAX
``fori_loop``s are Python loops over ``r``; every greedy step takes the
first maximum (``torch.argmax`` and ``jnp.argmax`` agree on that), and
every top-r ordering sorts stably (``jnp.argsort`` is stable,
``torch.argsort`` is not unless asked).

``random_subset`` draws from a ``torch.Generator``, not from
``jax.random``: the two give different permutations for the same seed.
"""
from __future__ import annotations

from typing import Tuple

import torch


def permutation(generator: torch.Generator, k: int) -> torch.Tensor:
    """A uniform permutation of ``range(k)`` drawn on the generator's device
    (the CPU for the selection key, so that a card run and a CPU run pick
    the same rows)."""
    return torch.randperm(k, generator=generator, device=generator.device)


def random_subset(generator: torch.Generator, k: int, r: int,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform random R-of-K (the paper's Table 14 baseline)."""
    pivots = permutation(generator, k)[:r].to(torch.int32).to(device)
    weights = torch.full((r,), 1.0 / r, dtype=torch.float32, device=device)
    return pivots, weights


def gradmatch_omp(G: torch.Tensor, g_bar: torch.Tensor,
                  r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GradMatch: orthogonal matching pursuit minimizing ‖ḡ − G_S w‖₂.

    G: (d, K) per-sample gradients. Greedy: at each step add the column most
    correlated with the residual, then refit the weights by ridge-regularized
    least squares on the selected set (a masked (K, K) solve, as in the
    reference). The final weights are clipped at 0 and NOT normalized.
    Returns (pivots (r,) int32, weights (r,)).
    """
    d, K = G.shape
    Gf = G.to(torch.float32)
    g = g_bar.to(torch.float32)
    Gn = Gf / (torch.linalg.norm(Gf, dim=0) + 1e-12)[None, :]
    eye = 1e-6 * torch.eye(K, dtype=torch.float32, device=G.device)
    pivots = torch.zeros(r, dtype=torch.int32, device=G.device)
    selected = torch.zeros(K, dtype=torch.float32, device=G.device)
    residual = g

    def refit(mask):
        A = Gf * mask[None, :]
        return A, torch.linalg.solve(A.T @ A + eye, A.T @ g)

    for j in range(r):
        scores = torch.abs(Gn.T @ residual)
        scores = torch.where(selected > 0, -torch.inf, scores)
        pj = torch.argmax(scores)
        pivots[j] = pj
        selected[pj] = 1.0
        A, w = refit(selected)
        residual = g - A @ (w * selected)
    _, w_full = refit(selected)
    return pivots, torch.clamp(w_full[pivots.long()], min=0.0)


def craig_greedy(G: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRAIG: facility-location greedy on gradient cosine similarity,
    maximizing F(S) = Σ_i max_{j∈S} sim(i, j); weights = cluster sizes / K.

    ``best_sim`` starts at −inf as in the reference, which makes every first
    gain +inf: the first pivot is always column 0.
    """
    d, K = G.shape
    Gf = G.to(torch.float32)
    norms = torch.linalg.norm(Gf, dim=0) + 1e-12
    S = (Gf.T @ Gf) / (norms[:, None] * norms[None, :])      # (K, K)
    best_sim = torch.full((K,), -torch.inf, dtype=torch.float32, device=G.device)
    pivots = torch.zeros(r, dtype=torch.int32, device=G.device)
    selected = torch.zeros(K, dtype=torch.bool, device=G.device)
    for j in range(r):
        gain = torch.sum(torch.clamp(S - best_sim[:, None], min=0.0), dim=0)
        pj = torch.argmax(torch.where(selected, -torch.inf, gain))
        best_sim = torch.maximum(best_sim, S[:, pj])
        pivots[j] = pj
        selected[pj] = True
    assign = torch.argmax(S[:, pivots.long()], dim=1)          # nearest medoid
    counts = torch.bincount(assign, minlength=r).to(torch.float32)
    return pivots, counts / K


def glister_greedy(G: torch.Tensor, g_val: torch.Tensor, r: int,
                   eta: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """GLISTER-online (greedy, first-order): the gain of adding sample i to
    the selected set S is ``g_iᵀ (g_val − η Σ_{j∈S} g_j)``. Uniform weights."""
    d, K = G.shape
    Gf = G.to(torch.float32)
    gv = g_val.to(torch.float32)
    acc = torch.zeros(d, dtype=torch.float32, device=G.device)
    pivots = torch.zeros(r, dtype=torch.int32, device=G.device)
    selected = torch.zeros(K, dtype=torch.bool, device=G.device)
    for j in range(r):
        scores = Gf.T @ (gv - eta * acc)
        pj = torch.argmax(torch.where(selected, -torch.inf, scores))
        acc = acc + Gf[:, pj]
        pivots[j] = pj
        selected[pj] = True
    return pivots, torch.full((r,), 1.0 / r, dtype=torch.float32, device=G.device)


def el2n_topk(G: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """EL2N pre-scoring: keep the r samples with the largest gradient norm."""
    norms = torch.linalg.norm(G.to(torch.float32), dim=0)
    pivots = torch.argsort(-norms, stable=True)[:r].to(torch.int32)
    return pivots, torch.full((r,), 1.0 / r, dtype=torch.float32, device=G.device)
