"""The port's GRAFT math against the JAX package's, on the same numpy inputs.

* Fast MaxVol: pivots EXACTLY equal (both round the elimination once);
  logvol rtol 1e-5 (log accumulation order).
* Prefix projection errors: atol 1e-5 — CGS2 reductions over d sum in
  another order.
* ``select_rank`` / ``_finalize``: rank exact, weights exactly equal (they
  depend only on the rank), error and alignment rtol 1e-5.
* ``svd_features``: V equal up to column sign (eigenvector signs are a
  LAPACK choice), atol 1e-4 relative to the largest singular value; the
  MaxVol pivots of both are equal, since |column| does not see the sign.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.core import grad_features as jgf
from repro.core import maxvol as jmaxvol
from repro.core import projection as jproj
from repro.selection import base as jbase
from repro.selection import graft as jgraft
from repro.selection import registry as jregistry
from repro.selection import sources as jsources
from repro_torch.core import features as tfeat
from repro_torch.core import grad_features as tgf
from repro_torch.core import maxvol as tmaxvol
from repro_torch.core import projection as tproj
from repro_torch.selection import base as tbase
from repro_torch.selection import graft as tgraft
from repro_torch.selection import registry as tregistry
from repro_torch.selection import sources as tsources
from torch_cases import CASES, graft_case

T = torch.from_numpy


@pytest.mark.parametrize("name", CASES)
def test_fast_maxvol_matches_jax(name):
    V, _, _, rank = graft_case(name)
    jp, jlv = jmaxvol.fast_maxvol(jnp.asarray(V), rank)
    tp, tlv = tmaxvol.fast_maxvol(T(V), rank)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_allclose(float(jlv), float(tlv), rtol=1e-5)
    with pytest.raises(ValueError, match="rank"):
        tmaxvol.fast_maxvol(T(V), min(V.shape) + 1)


@pytest.mark.parametrize("d,R", [(8, 16), (100, 7), (16, 16), (6, 12)])
def test_prefix_projection_errors_match_jax(rng, d, R):
    G = rng.normal(size=(d, R)).astype(np.float32)
    g = rng.normal(size=(d,)).astype(np.float32)
    je = np.asarray(jproj.prefix_projection_errors(jnp.asarray(G), jnp.asarray(g)))
    te = tproj.prefix_projection_errors(T(G), T(g)).numpy()
    np.testing.assert_allclose(te, je, atol=1e-5)
    assert np.all(np.diff(te) <= 1e-5)
    if d < R:                                 # past full rank the sweep is flat
        assert np.all(te[d:] < 1e-4)


def test_prefix_projection_errors_duplicated_column(rng):
    """A duplicated column's CGS2 residual is rounding noise (~1e-7·‖col‖),
    above the reference's absolute ``nrm > 1e-8`` guard, so both packages
    normalize noise into a new direction and the errors after it depend on
    the summation order. What is defined must agree: the errors before the
    duplicate, and a finite monotone sweep in [0, 1]."""
    G = rng.normal(size=(32, 7)).astype(np.float32)
    G[:, 3] = G[:, 0]
    g = rng.normal(size=(32,)).astype(np.float32)
    je = np.asarray(jproj.prefix_projection_errors(jnp.asarray(G), jnp.asarray(g)))
    te = tproj.prefix_projection_errors(T(G), T(g)).numpy()
    np.testing.assert_allclose(te[:3], je[:3], atol=1e-5)
    assert np.all(np.isfinite(te)) and np.all((te >= 0) & (te <= 1))
    assert np.all(np.diff(te) <= 1e-5)


@pytest.mark.parametrize("errs,rset,eps", [
    ([0.9, 0.8, 0.7, 0.6], (1, 2, 4), 0.1),      # none meets eps → r_max
    ([0.5] * 8, (1, 2, 8), 0.1),                  # flat plateau never shrinks
    ([0.9, 0.5, 0.2, 0.05], (1, 2, 3, 4), 0.3),   # smallest satisfying wins
    ([0.01, 0.005, 0.001, 0.0], (1, 2, 4), 0.25),  # all satisfy → first
])
def test_select_rank_matches_jax(errs, rset, eps):
    e = np.asarray(errs, np.float32)
    jr, je = jproj.select_rank(jnp.asarray(e), rset, eps)
    tr, te = tproj.select_rank(T(e), rset, eps)
    assert int(jr) == int(tr) and tr.dtype == torch.int32
    assert float(je) == float(te)


def test_projection_error_and_alignment_match_jax(rng):
    G = rng.normal(size=(40, 6)).astype(np.float32)
    g = rng.normal(size=(40,)).astype(np.float32)
    np.testing.assert_allclose(float(tproj.projection_error(T(G), T(g))),
                               float(jproj.projection_error(jnp.asarray(G), jnp.asarray(g))),
                               rtol=1e-5)
    a = rng.normal(size=(40,)).astype(np.float32)
    np.testing.assert_allclose(float(tproj.cosine_alignment(T(a), T(g))),
                               float(jproj.cosine_alignment(jnp.asarray(a), jnp.asarray(g))),
                               rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["slice", "tall", "rank_deficient"])
def test_graft_select_and_finalize_match_jax(name, use_pallas):
    V, G, gb, _ = graft_case(name)
    r = min(V.shape)
    rset = tuple(sorted({max(1, r // 4), max(1, r // 2), r}))
    kw = dict(rset=rset, eps=0.25, use_pallas=use_pallas)
    js = jgraft.graft_select(jbase.GraftConfig(**kw), jnp.asarray(V), jnp.asarray(G),
                             jnp.asarray(gb), jnp.int32(3))
    ts = tgraft.graft_select(tbase.GraftConfig(**kw), T(V), T(G), T(gb),
                             torch.tensor(3, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(js.pivots), ts.pivots.numpy())
    assert int(js.rank) == int(ts.rank) and int(ts.step) == 3
    np.testing.assert_array_equal(np.asarray(js.weights), ts.weights.numpy())
    np.testing.assert_allclose(float(js.last_error), float(ts.last_error), atol=1e-5)
    np.testing.assert_allclose(float(js.alignment), float(ts.alignment), rtol=1e-5)


def test_sampler_protocol_and_registry():
    V, G, gb, _ = graft_case("slice")
    cfg = tbase.GraftConfig(rset=(2, 4, 8))
    smp = tregistry.get_sampler("graft")
    state, carry = smp.select(cfg, tbase.SelectionInputs(T(V), T(G), T(gb)), step=5)
    assert carry == {} and int(state.step) == 5 and int(state.rank) in (2, 4, 8)
    init = smp.init_state(cfg, 16)
    assert init.pivots.tolist() == list(range(8)) and float(init.weights.sum()) == 1.0
    assert tregistry.available() == jregistry.available()
    assert tregistry.get_sampler("craig").name == "craig"
    with pytest.raises(KeyError, match="available"):
        tregistry.get_sampler("nope")
    assert tsources.available_features() == jsources.available_features()
    assert tsources.resolve_features("sketch_svd").name == "sketch_svd"
    assert tsources.available_grad_sources() == jsources.available_grad_sources()
    assert tsources.resolve_grad_source("full").needs_batch
    with pytest.raises(ValueError, match="ascending"):
        tbase.GraftConfig(rset=(4, 2))
    with pytest.raises(ValueError, match="r_max"):
        tbase.init_state(cfg, 4)


@pytest.mark.parametrize("fn", ["svd_features", "pca_features"])
@pytest.mark.parametrize("K,M", [(16, 72), (16, 8)])    # Gram path and SVD path
def test_features_match_jax_up_to_sign(rng, fn, K, M):
    A = rng.normal(size=(K, M)).astype(np.float32)
    rank = min(K, M, 8)
    jV = np.asarray(getattr(jfeat, fn)(jnp.asarray(A), rank))
    tV = getattr(tfeat, fn)(T(A), rank).numpy()
    signs = np.sign(np.sum(jV * tV, axis=0))
    np.testing.assert_allclose(tV * signs, jV, atol=1e-4 * np.abs(jV).max())
    jp, _ = jmaxvol.fast_maxvol(jnp.asarray(jV), rank)
    tp, _ = tmaxvol.fast_maxvol(T(tV), rank)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_logit_error_embeddings_match_jax(rng, masked):
    K, S, Vv, E = 6, 5, 33, 12
    logits = rng.normal(size=(K, S, Vv)).astype(np.float32)
    labels = rng.integers(0, Vv, size=(K, S)).astype(np.int32)
    h = rng.normal(size=(K, S, E)).astype(np.float32)
    mask = (rng.random((K, S)) > 0.3).astype(np.float32) if masked else None
    je = jgf.logit_error_embeddings(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(h),
                                    None if mask is None else jnp.asarray(mask))
    te = tgf.logit_error_embeddings(T(logits), T(labels), T(h),
                                    None if mask is None else T(mask))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
