"""Seeded numpy inputs for the port's GRAFT-refresh, MaxVol-on-NaN and RWKV-scan tests,
shared by the JAX-parity tests (CPU) and the kernel-vs-twin tests (card).
Imports no JAX, so the card-only tests run where JAX is not installed."""
import numpy as np

CASES = ["slice", "tall", "near_square", "odd", "square", "rank_deficient",
         "duplicate_rows", "ties"]


def graft_case(name, seed=0):
    """(V (K,R), G (d,K), g_bar (d,), rank) as float32 numpy. The shapes and
    degenerate inputs of tests/test_kernel_parity.py, plus the training
    path's (K=16, R=8), K == R == rank, and exact magnitude ties."""
    rng = np.random.default_rng(seed)
    f = np.float32
    if name == "slice":                      # the training path: K=16, R=8
        K, R, d, rank = 16, 8, 72, 8
        V = rng.normal(size=(K, R)).astype(f)
    elif name == "tall":
        K, R, d, rank = 96, 12, 40, 12
        V = rng.normal(size=(K, R)).astype(f)
    elif name == "near_square":
        K, R, d, rank = 20, 16, 64, 10
        V = rng.normal(size=(K, R)).astype(f)
    elif name == "odd":
        K, R, d, rank = 17, 5, 9, 3
        V = rng.normal(size=(K, R)).astype(f)
    elif name == "square":                   # K == R == rank
        K, R, d, rank = 16, 16, 24, 16
        V = rng.normal(size=(K, R)).astype(f)
    elif name == "rank_deficient":           # true rank 3, ask for 6; zero column
        K, R, d, rank = 64, 8, 32, 6
        V = (rng.normal(size=(K, 3)) @ rng.normal(size=(3, R))).astype(f)
        V[:, 5] = 0.0
    elif name == "duplicate_rows":
        base = rng.normal(size=(8, 6)).astype(f)
        V = np.concatenate([base, base, base], axis=0)
        K, R, d, rank = 24, 6, 16, 6
    elif name == "ties":                     # many exactly equal magnitudes
        K, R, d, rank = 12, 6, 20, 6
        V = rng.choice([-2.0, -1.0, 1.0, 2.0], size=(K, R)).astype(f)
    else:
        raise KeyError(name)
    G = rng.normal(size=(d, K)).astype(f)
    if name == "rank_deficient":             # duplicated gradient columns too
        G[:, 1] = G[:, 0]
    return V, G, G.mean(axis=1).astype(f), rank


def sampler_case(d, K, R, seed=0):
    """(V (K,R), G (d,K), g_bar (d,), scores (K,)) float32 numpy for the
    sampler tests: G's columns share a common direction (as gradients do)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    V = rng.normal(size=(K, R)).astype(f)
    G = (rng.normal(size=(d, K)) + 0.3 * rng.normal(size=(d, 1))).astype(f)
    scores = rng.random(K).astype(f)
    return V, G, G.mean(axis=1).astype(f), scores


def assert_refresh_match(got, want, err_atol=1e-5, lv_rtol=1e-5):
    """Pivots and G_sel exactly equal; errors atol / logvol rtol (float32
    reassociation of the reductions)."""
    piv, err, lv, gsel = (np.asarray(x) for x in got)
    piv_w, err_w, lv_w, gsel_w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(piv.astype(np.int64), piv_w.astype(np.int64))
    np.testing.assert_array_equal(gsel, gsel_w)
    np.testing.assert_allclose(err, err_w, atol=err_atol)
    np.testing.assert_allclose(float(lv), float(lv_w), rtol=lv_rtol)
    assert np.all(np.isfinite(err)) and np.isfinite(float(lv))


# the NaN cases of Fast MaxVol's order: a NaN column, two scattered NaNs,
# an all-NaN V (a poisoned refresh's features)
NAN_CASES = ["nan_column", "scattered", "all_nan"]


def nan_case(name, K, R, seed=0):
    """V (K, R) float32 standard normal from ``seed`` with NaNs per ``name``."""
    V = np.random.default_rng(seed).standard_normal((K, R)).astype(np.float32)
    if name == "nan_column":
        V[:, 0] = np.nan
    elif name == "scattered":
        V[[3, K - 5], 2] = np.nan
    elif name == "all_nan":
        V[:] = np.nan
    else:
        raise KeyError(name)
    return V


# (BH, T, D, chunk) of tests/test_kernels.py::TestRwkvScanKernel
RWKV_SHAPES = [(1, 32, 16, 8), (4, 64, 32, 16), (2, 128, 64, 32), (3, 96, 48, 32)]


def rwkv_case(BH, T, D, seed=0, w_low=0.4):
    """(r, k, v, w (BH,T,D), u (BH,D), do (BH,T,D)) float32 numpy with the
    JAX kernel test's distributions: r/k/v normal × 0.3, w uniform in
    [w_low, w_low + 0.59), u normal × 0.1, and a normal upstream gradient."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.normal(size=(BH, T, D)).astype(f) * f(0.3) for _ in range(3))
    w = (w_low + 0.59 * rng.random(size=(BH, T, D))).astype(f)
    u = rng.normal(size=(BH, D)).astype(f) * f(0.1)
    do = rng.normal(size=(BH, T, D)).astype(f)
    return r, k, v, w, u, do
