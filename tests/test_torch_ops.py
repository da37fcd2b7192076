"""The port's ``kernels/ops`` surface and its standalone kernels against the
JAX package's Pallas kernels (interpret mode), on the CPU.

The port's wrappers run their plain versions for CPU tensors; the same
numpy inputs go to the JAX kernels with ``interpret=True``.

* ``fast_maxvol``: pivots EXACTLY equal — the port rounds the elimination
  once, and XLA:CPU contracts the standalone Pallas body into a fused
  multiply-add as it does the fused one (the rank-deficient case, whose
  pivots past the true rank are decided by rounding, shows it); logvol
  rtol 1e-5 (log accumulation order).
* ``projection_sweep``: atol 1e-5 — the Gram-Schmidt reductions over d sum
  in another order.
* the batched refresh: pivots and ``G_sel`` exactly equal, errors atol 1e-6
  and logvol rtol 1e-6 (the tolerances of the JAX package's own batched
  test); errors are sums in another order, so 1e-6 holds at this small d.
* shape errors: the same messages as the JAX wrappers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.fast_maxvol import fast_maxvol_pallas
from repro.kernels.graft_select import (fused_graft_select_batched_pallas,
                                        fused_graft_select_pallas)
from repro.kernels.projection_sweep import projection_sweep_pallas
from repro_torch.kernels import fast_maxvol as tfm
from repro_torch.kernels import graft_select as tgs
from repro_torch.kernels import ops
from repro_torch.kernels import projection_sweep as tps
from torch_cases import CASES, graft_case

T = torch.from_numpy


def _counts():
    return (tfm.fast_maxvol.launches, tps.projection_sweep.launches,
            tgs.graft_select.launches, tgs.graft_select_batched.launches)


@pytest.mark.parametrize("name", CASES)
def test_fast_maxvol_matches_pallas_kernel(name):
    V, _, _, rank = graft_case(name)
    jp, jlv = fast_maxvol_pallas(jnp.asarray(V), rank, interpret=True)
    before = _counts()
    tp, tlv = ops.fast_maxvol_with_logvol(T(V), rank)
    assert _counts() == before, "CPU tensors must not count a launch"
    assert tp.dtype == torch.int32 and tp.shape == (rank,)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ops.fast_maxvol(T(V), rank).numpy(), np.asarray(jp))
    np.testing.assert_allclose(float(tlv), float(jlv), rtol=1e-5)


def test_fast_maxvol_rank_deficient_needs_one_rounding():
    """Past the true rank (3) the pivots are decided by rounding noise: the
    JAX standalone kernel picks what a single-rounding elimination picks,
    i.e. XLA:CPU contracts ``W - f * p`` into an FMA here too."""
    V, _, _, rank = graft_case("rank_deficient")
    jp, _ = fast_maxvol_pallas(jnp.asarray(V), rank, interpret=True)
    W = V.astype(np.float32).copy()
    avail = np.ones(V.shape[0], bool)
    two_roundings = []
    for j in range(rank):
        scores = np.where(avail, np.abs(W[:, j]), -1.0)
        p = int(np.argmax(scores))
        pv = W[p, j] if abs(W[p, j]) >= 1e-12 else np.float32(1e-12 if W[p, j] >= 0 else -1e-12)
        f = (W[:, j] / pv).astype(np.float32)
        row = W[p].copy()
        W = (W - (f[:, None] * row[None, :]).astype(np.float32)).astype(np.float32)
        W[p] = row
        avail[p] = False
        two_roundings.append(p)
    assert list(np.asarray(jp)) != two_roundings
    np.testing.assert_array_equal(ops.fast_maxvol(T(V), rank).numpy(), np.asarray(jp))


@pytest.mark.parametrize("d,R", [(72, 8), (40, 12), (9, 5), (1024, 32)])
def test_projection_sweep_matches_pallas_kernel(d, R):
    rng = np.random.default_rng(d * 100 + R)
    G = rng.normal(size=(d, R)).astype(np.float32)
    g = rng.normal(size=(d,)).astype(np.float32)
    want = np.asarray(projection_sweep_pallas(jnp.asarray(G), jnp.asarray(g),
                                              interpret=True))
    before = _counts()
    got = ops.projection_sweep(T(G), T(g))
    assert _counts() == before
    assert got.shape == (R,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.all(np.diff(got.numpy()) <= 1e-5)


def test_projection_sweep_duplicated_column_before_the_duplicate():
    """A duplicated column's CGS2 residual is rounding noise above the 1e-8
    guard (ROADMAP §C), so the errors after it depend on summation order:
    parity holds up to and including the duplicate's predecessor."""
    rng = np.random.default_rng(7)
    G = rng.normal(size=(32, 7)).astype(np.float32)
    G[:, 4] = G[:, 2]
    g = G.mean(axis=1).astype(np.float32)
    want = np.asarray(projection_sweep_pallas(jnp.asarray(G), jnp.asarray(g),
                                              interpret=True))
    got = ops.projection_sweep(T(G), T(g)).numpy()
    np.testing.assert_allclose(got[:4], want[:4], atol=1e-5)


def test_fused_batched_matches_pallas_kernel():
    B, K, R, d, rank = 5, 40, 10, 24, 8
    rng = np.random.default_rng(11)
    Vs = rng.normal(size=(B, K, R)).astype(np.float32)
    Gs = rng.normal(size=(B, d, K)).astype(np.float32)
    gbs = Gs.mean(axis=2).astype(np.float32)
    jp, je, jlv, jgs = (np.asarray(x) for x in fused_graft_select_batched_pallas(
        jnp.asarray(Vs), jnp.asarray(Gs), jnp.asarray(gbs), rank, interpret=True))
    before = _counts()
    tp, te, tlv, tgsel = (t.numpy() for t in tgs.graft_select_batched(
        T(Vs), T(Gs), T(gbs), rank))
    assert _counts() == before
    assert tp.shape == (B, rank) and tgsel.shape == (B, d, rank) and tlv.shape == (B,)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tgsel, jgs)
    np.testing.assert_allclose(te, je, atol=1e-6)
    np.testing.assert_allclose(tlv, jlv, rtol=1e-6)
    op, oe, ogs = (t.numpy() for t in ops.fused_graft_select_batched(
        T(Vs), T(Gs), T(gbs), rank))
    np.testing.assert_array_equal(op, jp)
    np.testing.assert_array_equal(ogs, jgs)
    np.testing.assert_array_equal(oe, te)
    for b in range(B):                      # row b is the single refresh on row b
        sp, se, slv, sg = tgs.graft_select(T(Vs[b]), T(Gs[b]), T(gbs[b]), rank)
        np.testing.assert_array_equal(sp.numpy(), tp[b])
        np.testing.assert_array_equal(se.numpy(), te[b])
        np.testing.assert_array_equal(sg.numpy(), tgsel[b])
        assert float(slv) == float(tlv[b])


@pytest.mark.parametrize("name", ["slice", "rank_deficient", "ties"])
def test_fused_single_matches_jax_ops(name):
    V, G, gb, rank = graft_case(name)
    want = fused_graft_select_pallas(jnp.asarray(V), jnp.asarray(G), jnp.asarray(gb),
                                     rank, interpret=True)
    jp, je, jg = (np.asarray(x) for x in jops.fused_graft_select(
        jnp.asarray(V), jnp.asarray(G), jnp.asarray(gb), rank))
    tp, te, tg = (t.numpy() for t in ops.fused_graft_select(T(V), T(G), T(gb), rank))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp, np.asarray(want[0]))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(te, je, atol=1e-5)


def test_ops_cast_to_float32_like_jax():
    """The JAX wrappers cast their operands to float32; so do the port's."""
    V, G, gb, rank = graft_case("slice")
    want = ops.fast_maxvol(T(V), rank)
    got = ops.fast_maxvol(T(V).double(), rank)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    e64 = ops.projection_sweep(T(G[:, :rank]).double(), T(gb).double())
    assert e64.dtype == torch.float32


def _jax_error(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("case", ["batch_mismatch", "g_bar_mismatch", "rank",
                                  "budget"])
def test_batched_shape_errors_match_jax(case):
    B, K, R, d, rank = 2, 8, 4, 6, 3
    shapes = {"V": (B, K, R), "G": (B, d, K), "g_bar": (B, d)}
    if case == "batch_mismatch":
        shapes["G"] = (B + 1, d, K)
    elif case == "g_bar_mismatch":
        shapes["g_bar"] = (B, d + 1)
    elif case == "rank":
        rank = R + 1
    else:                                   # d·K alone is 16 MB > 12 MB
        d, K = 4096, 1024
        shapes = {"V": (B, K, R), "G": (B, d, K), "g_bar": (B, d)}
    arrays = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    want = _jax_error(fused_graft_select_batched_pallas,
                      *(jnp.asarray(arrays[k]) for k in ("V", "G", "g_bar")),
                      rank, interpret=True)
    got = _jax_error(tgs.graft_select_batched,
                     *(T(arrays[k]) for k in ("V", "G", "g_bar")), rank)
    assert got == want


def test_standalone_shape_errors_match_jax():
    V = np.zeros((8, 4), np.float32)
    assert _jax_error(ops.fast_maxvol, T(V), 5) == \
        _jax_error(fast_maxvol_pallas, jnp.asarray(V), 5, interpret=True)
    big = np.zeros((4096, 1024), np.float32)          # 16 MB > 8 MB
    assert _jax_error(ops.fast_maxvol, T(big), 4) == \
        _jax_error(fast_maxvol_pallas, jnp.asarray(big), 4, interpret=True)
    G = np.zeros((65536, 24), np.float32)              # d(2R+1)·4 = 12.25 MB
    g = np.zeros(65536, np.float32)
    assert _jax_error(ops.projection_sweep, T(G), T(g)) == \
        _jax_error(projection_sweep_pallas, jnp.asarray(G), jnp.asarray(g),
                   interpret=True)


def test_flash_attention_matches_jax_ops():
    """The ops-level flash entry point (plain version on the CPU) against
    the JAX one (Pallas in interpret mode), GQA 2 with a window."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 32, 8)).astype(np.float32)
    k = rng.normal(size=(2, 32, 8)).astype(np.float32)
    v = rng.normal(size=(2, 32, 8)).astype(np.float32)
    kw = dict(causal=True, window=12, block_q=16, block_k=16, group=2)
    want = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw))
    got = ops.flash_attention(T(q), T(k), T(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert _jax_error(ops.flash_attention, T(q), T(k), T(v), group=2, block_q=24) == \
        _jax_error(jops.flash_attention, jnp.asarray(q), jnp.asarray(k),
                   jnp.asarray(v), group=2, block_q=24)
