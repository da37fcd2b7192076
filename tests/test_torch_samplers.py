"""The port's baseline samplers, feature sources and gradient sources
against the JAX package's, on the same numpy inputs (CPU).

* Baselines and samplers: pivots, rank and ``step`` EXACTLY equal. Uniform
  and CRAIG weights bit-equal (CRAIG's are counts over K); GradMatch weights
  rtol 1e-4 (a float32 (K, K) solve, with another LAPACK); ``last_error``
  and ``alignment`` rtol 1e-5 (Gram-Schmidt sums in another order). The
  inputs have no near-ties: CRAIG's greedy ties EXACTLY between two
  mutually nearest columns (a property of the reference, shown by
  ``test_craig_ties_exactly_between_mutually_nearest_columns``), where
  rounding decides, so its inputs are checked for a float64 gain margin.
* ``random`` draws from a ``torch.Generator``, not ``jax.random``: a
  contract test, and the exact test with JAX's permutation injected.
* Features: ``sketch_svd`` and ``pca_sketch`` with JAX's Ω / S injected, V
  equal up to column sign within rtol 1e-4 of max|V| (float32 range finder
  and eigh in another LAPACK; measured ≤ 3.5e-5); ``ica`` with JAX's W0
  injected (rows flipped where the port's canonical whitening signs differ
  from LAPACK's), within 1e-4 of max|V| (measured ≤ 1.6e-5 over 64 FastICA
  iterations: XLA:CPU's float32 tanh is less exact); ``pooled_raw``
  bit-equal.
* Grad sources: ``logit_embed`` rtol 1e-5 (masked and unmasked); ``full``
  at smoke size, each parameter leaf's gradient within 5e-5 of its largest
  value (the forward and backward sum in another order, as the RWKV
  gradients are held).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core import baselines as jbaselines
from repro.core import features as jfeat
from repro.core import grad_features as jgf
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.selection import base as jbase
from repro.selection import registry as jregistry
from repro.selection import sources as jsources
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import baselines as tbaselines
from repro_torch.core import features as tfeat
from repro_torch.core import grad_features as tgf
from repro_torch.models.model import Model
from repro_torch.selection import base as tbase
from repro_torch.selection import engine
from repro_torch.selection import registry as tregistry
from repro_torch.selection import sources as tsources
from torch_cases import sampler_case

T = torch.from_numpy
SAMPLERS = ("random", "loss_topk", "full", "el2n", "gradmatch", "craig", "glister")
# (d, K, R, rset, seed): the slice's K 16 × R 8 at a narrow and at
# minicpm-2b's full width, and a wider K; seeds whose CRAIG gains keep a
# float64 margin (asserted below)
SHAPES = [(72, 16, 8, (2, 4, 8), 4), (40, 32, 12, (4, 12), 2), (2304, 16, 8, (2, 4, 8), 0)]


def _craig_gains(G, pivots):
    """CRAIG's gains in float64 before each pick of ``pivots``."""
    G = G.astype(np.float64)
    n = np.linalg.norm(G, axis=0) + 1e-12
    S = (G.T @ G) / (n[:, None] * n[None, :])
    best, out = np.full(S.shape[0], -np.inf), []
    for j, p in enumerate(pivots):
        g = np.sum(np.maximum(S - best[:, None], 0.0), axis=0)
        g[list(pivots[:j])] = -np.inf
        out.append(g)
        best = np.maximum(best, S[:, p])
    return out


def _craig_margin(G, pivots):
    """Smallest relative gap between the best and second-best gain over the
    picks after the first (the first gains are all +inf)."""
    gaps = []
    for g in _craig_gains(G, pivots)[1:]:
        top = np.sort(g[np.isfinite(g)])[::-1]
        gaps.append((top[0] - top[1]) / abs(top[0]))
    return min(gaps)


@pytest.mark.parametrize("d,K,R,rset,seed", SHAPES)
def test_baselines_match_jax(d, K, R, rset, seed):
    _, G, gb, _ = sampler_case(d, K, R, seed)
    r = rset[-1]
    jp, jw = jbaselines.gradmatch_omp(jnp.asarray(G), jnp.asarray(gb), r)
    tp, tw = tbaselines.gradmatch_omp(T(G), T(gb), r)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-7)
    assert tw.min() >= 0.0
    jp, jw = jbaselines.craig_greedy(jnp.asarray(G), r)
    assert _craig_margin(G, np.asarray(jp)) > 1e-5
    tp, tw = tbaselines.craig_greedy(T(G), r)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for jfn, tfn, args in ((jbaselines.glister_greedy, tbaselines.glister_greedy, (gb,)),
                           (jbaselines.el2n_topk, tbaselines.el2n_topk, ())):
        jp, jw = jfn(jnp.asarray(G), *(jnp.asarray(a) for a in args), r)
        tp, tw = tfn(T(G), *(T(a) for a in args), r)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert tp.dtype == torch.int32


def test_craig_first_pivot_is_always_column_zero():
    """``best_sim`` starts at −inf in the reference, so every first gain is
    +inf and argmax takes column 0; the port keeps the arithmetic."""
    for seed in range(5):
        _, G, _, _ = sampler_case(72, 16, 8, seed)
        jp, _ = jbaselines.craig_greedy(jnp.asarray(G), 4)
        tp, _ = tbaselines.craig_greedy(T(G), 4)
        assert int(jp[0]) == int(tp[0]) == 0


def test_craig_ties_exactly_between_mutually_nearest_columns():
    """Once only two unselected, mutually nearest columns i and j still gain,
    both gains are (1 − bᵢ) + (Sᵢⱼ − bⱼ) in exact arithmetic: a tie that the
    float32 rounding of S decides, in the reference as in the port. Seed 0
    at (72, 16, 8) has such a tie."""
    _, G, _, _ = sampler_case(72, 16, 8, 0)
    jp = np.asarray(jbaselines.craig_greedy(jnp.asarray(G), 8)[0])
    tp = tbaselines.craig_greedy(T(G), 8)[0].numpy()
    gains = _craig_gains(G, jp)
    top = [np.sort(g[np.isfinite(g)])[::-1] for g in gains[1:]]
    tied = [j + 1 for j, t in enumerate(top) if (t[0] - t[1]) <= 1e-12 * abs(t[0])]
    assert tied, "expected an exact tie among the gains"
    first = tied[0]
    np.testing.assert_array_equal(tp[:first], jp[:first])     # equal up to the tie
    g = gains[first]
    assert np.isclose(g[tp[first]], g.max(), rtol=1e-12) and \
        np.isclose(g[jp[first]], g.max(), rtol=1e-12)          # each picks a tied column


def test_argsort_is_stable_as_in_jax():
    """``torch.argsort`` is not stable by default; ``jnp.argsort`` is. Every
    top-r of the port sorts stably, so exact ties keep index order."""
    scores = np.array([1, 2, 2, 2, 1, 2] * 10, dtype=np.float32)
    want = np.asarray(jnp.argsort(-jnp.asarray(scores))[:8])
    np.testing.assert_array_equal(want, [1, 2, 3, 5, 7, 8, 9, 11])
    K = scores.size
    cfg_kw = dict(rset=(8,))
    inputs = tbase.SelectionInputs(torch.zeros(K, 8), torch.ones(4, K), torch.ones(4),
                                   T(scores))
    st, _ = tregistry.get_sampler("loss_topk").select(tbase.GraftConfig(**cfg_kw), inputs)
    np.testing.assert_array_equal(st.pivots.numpy(), want)
    G = np.ones((3, K), np.float32) * scores[None, :]
    np.testing.assert_array_equal(tbaselines.el2n_topk(T(G), 8)[0].numpy(),
                                  np.asarray(jbaselines.el2n_topk(jnp.asarray(G), 8)[0]))
    A = np.ones((4, K), np.float32) * scores[None, :]
    np.testing.assert_array_equal(
        tsources.pooled_raw_features(T(A), 8).numpy(),
        np.asarray(jsources.pooled_raw_features(jnp.asarray(A), 8)))


def _jax_state(name, cfg_kw, V, G, gb, scores, step, key=None):
    cfg = jbase.GraftConfig(**cfg_kw)
    inp = jbase.SelectionInputs(jnp.asarray(V), jnp.asarray(G), jnp.asarray(gb),
                                jnp.asarray(scores), key)
    return jregistry.get_sampler(name).select(cfg, inp, step=step)[0]


@pytest.mark.parametrize("name", SAMPLERS)
@pytest.mark.parametrize("d,K,R,rset,seed", SHAPES)
def test_samplers_match_jax(monkeypatch, name, d, K, R, rset, seed):
    V, G, gb, scores = sampler_case(d, K, R, seed)
    cfg_kw = dict(rset=rset)
    key = jax.random.PRNGKey(seed)
    if name == "random":                    # inject JAX's draw into the port
        perm = np.asarray(jax.random.permutation(key, K))
        monkeypatch.setattr(tbaselines, "permutation", lambda gen, k: T(perm.copy()))
    js = _jax_state(name, cfg_kw, V, G, gb, scores, 7, key=key)
    ts, carry = tregistry.get_sampler(name).select(
        tbase.GraftConfig(**cfg_kw),
        tbase.SelectionInputs(T(V), T(G), T(gb), T(scores), torch.Generator()), step=7)
    assert carry == {}
    np.testing.assert_array_equal(ts.pivots.numpy(), np.asarray(js.pivots))
    assert ts.pivots.dtype == torch.int32
    assert int(ts.rank) == int(js.rank) == rset[-1] and int(ts.step) == int(js.step) == 7
    if name == "gradmatch":
        np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights), rtol=1e-4)
    else:
        np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(js.weights))
    np.testing.assert_allclose(float(ts.last_error), float(js.last_error), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(ts.alignment), float(js.alignment), rtol=1e-5)


def test_random_sampler_contract():
    """Distinct rows in range, uniform weights, deterministic per step, and
    the engines derive the same generator from the step as the train step."""
    K, cfg = 64, tbase.GraftConfig(rset=(4, 16))
    V, G, gb = torch.zeros(K, 16), torch.randn(8, K), torch.randn(8)
    picks = []
    for step in (0, 1, 1):
        st, _ = engine.select_batch(cfg, "random", V, G, gb, step=step)
        p = st.pivots.tolist()
        assert len(set(p)) == 16 and all(0 <= i < K for i in p)
        assert torch.equal(st.weights, torch.full((16,), 1 / 16))
        picks.append(p)
    assert picks[1] == picks[2] and picks[0] != picks[1]
    direct, _ = tregistry.get_sampler("random").select(
        cfg, tbase.SelectionInputs(V, G, gb, key=tbase.default_select_generator(1)), step=1)
    assert direct.pivots.tolist() == picks[1]
    with pytest.raises(ValueError, match="requires SelectionInputs.key"):
        tregistry.get_sampler("random").select(cfg, tbase.SelectionInputs(V, G, gb))
    multi, _ = engine.select_multi_batch(cfg, "random", V.expand(3, K, 16),
                                         G.expand(3, 8, K), gb.expand(3, 8), step=5)
    again, _ = engine.select_multi_batch(cfg, "random", V.expand(3, K, 16),
                                         G.expand(3, 8, K), gb.expand(3, 8), step=5)
    assert torch.equal(multi.pivots, again.pivots)
    assert len({tuple(p) for p in multi.pivots.tolist()}) == 3      # lanes differ


def test_registries_hold_jax_names_in_jax_order():
    assert tregistry.available() == jregistry.available()
    assert tsources.available_features() == jsources.available_features()
    assert tsources.available_grad_sources() == jsources.available_grad_sources()
    for reg in (tregistry._REGISTRY, tsources._FEATURES, tsources._GRAD_SOURCES):
        assert reg.not_ported == ()
    for name in tregistry.available():
        t, j = tregistry.get_sampler(name), jregistry.get_sampler(name)
        assert (t.needs_key, t.needs_scores, t.stateful) == (j.needs_key, j.needs_scores,
                                                             j.stateful)
    with pytest.raises(ValueError, match="requires SelectionInputs.scores"):
        engine.select_batch(tbase.GraftConfig(rset=(2,)), "el2n", torch.zeros(4, 2),
                            torch.zeros(3, 4), torch.zeros(3))


# ---------------------------------------------------------------------------
# feature sources
# ---------------------------------------------------------------------------

def _inject(monkeypatch, draws):
    """Route ``features.gaussian`` to JAX's draw for each seed."""
    monkeypatch.setattr(tfeat, "gaussian",
                        lambda seed, shape, device: T(draws[seed](shape)).to(device))


def _jax_normal(seed):
    return lambda shape: np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                                      dtype=jnp.float32))


def _assert_up_to_sign(tV, jV, rtol):
    signs = np.sign(np.sum(jV * tV, axis=0))
    signs[signs == 0] = 1.0
    np.testing.assert_allclose(tV * signs, jV, atol=rtol * np.abs(jV).max())


@pytest.mark.parametrize("K,M,rank", [(16, 72, 8), (16, 2304, 8), (24, 40, 6), (16, 8, 8)])
def test_sketch_features_match_jax_with_its_draws(monkeypatch, K, M, rank):
    A = np.random.default_rng(1).normal(size=(K, M)).astype(np.float32)
    _inject(monkeypatch, {tfeat._SKETCH_SVD_SEED: _jax_normal(jfeat._SKETCH_SVD_SEED),
                          tsources._SKETCH_SEED: _jax_normal(jsources._SKETCH_SEED)})
    for tfn, jfn in ((tfeat.sketch_svd_features, jfeat.sketch_svd_features),
                     (tsources.pca_sketch_features, jsources.pca_sketch_features)):
        _assert_up_to_sign(tfn(T(A), rank).numpy(), np.asarray(jfn(jnp.asarray(A), rank)), 1e-4)
    _assert_up_to_sign(tfeat.sketch_svd_features(T(A), rank, power_iters=2).numpy(),
                       np.asarray(jfeat.sketch_svd_features(jnp.asarray(A), rank,
                                                            power_iters=2)), 1e-4)
    np.testing.assert_array_equal(
        tsources.pooled_raw_features(T(A), rank).numpy(),
        np.asarray(jsources.pooled_raw_features(jnp.asarray(A), rank)))
    tV = tfeat.extract("sketch_svd", T(A), rank)
    assert tV.shape == (K, rank) and set(tfeat.EXTRACTORS) == set(jfeat.EXTRACTORS)


@pytest.mark.parametrize("K,M,rank", [(16, 72, 8), (16, 2304, 8), (24, 40, 6)])
def test_ica_matches_jax_with_its_start(monkeypatch, K, M, rank):
    A = np.random.default_rng(2).normal(size=(K, M)).astype(np.float32)
    jV = np.asarray(jfeat.ica_features(jnp.asarray(A), rank))
    # the reference whitens with LAPACK's eigenvector signs, the port with
    # canonical ones: flipping W0's columns where they differ gives the
    # port the same sources
    X = A - A.mean(axis=0, keepdims=True)
    E = np.asarray(jnp.flip(jnp.linalg.eigh(jnp.asarray(X @ X.T / M))[1], -1))[:, :rank]
    flips = np.sign(E[np.argmax(np.abs(E), axis=0), np.arange(rank)])
    W0 = _jax_normal(0)((rank, rank)) * flips[None, :]
    _inject(monkeypatch, {tfeat._ICA_SEED: lambda shape: W0.astype(np.float32)})
    _assert_up_to_sign(tfeat.ica_features(T(A), rank).numpy(), jV, 1e-4)
    _assert_up_to_sign(tsources.resolve_features("ica")(T(A), rank).numpy(), jV, 1e-4)


def test_feature_draws_are_fixed_and_cached():
    a = tfeat.gaussian(0x51E7, (40, 16), torch.device("cpu"))
    assert a is tfeat.gaussian(0x51E7, (40, 16), torch.device("cpu"))
    gen = torch.Generator().manual_seed(0x51E7)
    assert torch.equal(a, torch.randn((40, 16), generator=gen))
    A = torch.randn(16, 40)
    assert torch.equal(tfeat.ica_features(A, 4), tfeat.ica_features(A, 4))
    enc = tfeat.encoder_features(lambda p, b: b @ p, torch.eye(40), A, 4)
    assert torch.equal(enc, tfeat.svd_features(A, 4))


# ---------------------------------------------------------------------------
# gradient sources
# ---------------------------------------------------------------------------

def _smoke_params(arch="minicpm-2b"):
    jm = jsmoke(arch, param_dtype="float32")
    tm = tsmoke(arch, param_dtype="float32")
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), Model(tm))
    return jm, tm, jparams, model


@pytest.mark.parametrize("masked", [False, True])
def test_logit_embed_matches_jax(masked):
    jm, tm, jparams, model = _smoke_params()
    rng = np.random.default_rng(3)
    K, S, E = 6, 5, tm.d_model
    logits = rng.normal(size=(K, S, tm.vocab_size)).astype(np.float32)
    labels = rng.integers(0, tm.vocab_size, size=(K, S)).astype(np.int32)
    h = rng.normal(size=(K, S, E)).astype(np.float32)
    mask = (rng.random((K, S)) > 0.3).astype(np.float32) if masked else None
    je = jsources.logit_embed_grad_source(jsources.GradSourceInputs(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(h), mcfg=jm, params=jparams,
        mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():                       # as selection_inputs runs it
        te = tsources.resolve_grad_source("logit_embed")(tsources.GradSourceInputs(
            T(logits), T(labels), T(h), mcfg=tm, params=model.tree(),
            mask=None if mask is None else T(mask)))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="requires GradSourceInputs.params"):
        tsources.resolve_grad_source("logit_embed")(tsources.GradSourceInputs(
            T(logits), T(labels), T(h)))


def _full_grad_source_against_jax(arch):
    """Each leaf of the (K, |Θ|) matrix within 5e-5 of its largest value, as
    the RWKV gradients are held (float32; the reductions differ in order)."""
    jm, tm, jparams, model = _smoke_params(arch)
    b = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=8, global_batch=4)).batch_at(0)
    je = np.asarray(jsources.full_grad_source(jsources.GradSourceInputs(
        None, None, None, mcfg=jm, params=jparams, batch={k: jnp.asarray(v) for k, v in b.items()})))
    src = tsources.resolve_grad_source("full")
    before = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():                       # as selection_inputs runs it
        te = src(tsources.GradSourceInputs(None, None, None, mcfg=tm, params=model.tree(),
                                           batch={k: T(v) for k, v in b.items()})).numpy()
    assert all(torch.equal(a, p) and p.grad is None for a, p in zip(before, model.parameters()))
    assert te.shape == je.shape == (4, src.embed_dim(tm, model.tree()))
    offset = 0
    for leaf in jax.tree_util.tree_leaves(jparams):        # the JAX leaf order
        n = leaf.size
        want, got = je[:, offset:offset + n], te[:, offset:offset + n]
        np.testing.assert_allclose(got, want, atol=5e-5 * max(np.abs(want).max(), 1e-30))
        offset += n
    assert offset == je.shape[1]


def test_full_grad_source_matches_jax_per_leaf():
    _full_grad_source_against_jax("minicpm-2b")


def test_full_grad_source_matches_jax_per_leaf_through_rwkv():
    """The ssm family too: one backward per example runs the recurrence's
    autograd Function, which ``vmap`` could not."""
    _full_grad_source_against_jax("rwkv6-7b")


def test_full_grad_source_refuses_full_width():
    """K full gradients of a large model do not fit: refused, not tried."""
    tm = tsmoke("minicpm-2b")
    n = tsources.FULL_GRAD_BYTES_LIMIT // (4 * 16) + 1     # one value over the limit at K 16
    big = {"w": torch.zeros(1).expand(n)}
    with pytest.raises(ValueError, match="smoke-size"):
        tsources.full_grad_source(tsources.GradSourceInputs(
            None, None, None, mcfg=tm, params=big, batch={"tokens": torch.zeros(16, 4)}))
    assert tsources.resolve_grad_source("full").embed_dim(tm, big) == n


def test_per_sample_probe_grads_match_jax():
    rng = np.random.default_rng(4)
    K, E, C = 5, 12, 7
    h = rng.normal(size=(K, E)).astype(np.float32)
    y = rng.integers(0, C, size=K).astype(np.int32)
    W = rng.normal(size=(E, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)

    def jloss(p, hi, yi):
        return -jax.nn.log_softmax(hi @ p["W"] + p["b"])[yi]

    def tloss(p, hi, yi):
        return -torch.log_softmax(hi @ p["W"] + p["b"], dim=-1).gather(0, yi.long()[None])[0]

    jG, jg = jgf.per_sample_grads_probe(jloss, {"W": jnp.asarray(W), "b": jnp.asarray(b)},
                                        jnp.asarray(h), jnp.asarray(y))
    tG, tg = tgf.per_sample_grads_probe(tloss, {"W": T(W), "b": T(b)}, T(h), T(y))
    np.testing.assert_allclose(tG.numpy(), np.asarray(jG), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step with every sampler and source
# ---------------------------------------------------------------------------

SMALL = ["train.steps=4", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "train.log_every=0"]


@pytest.mark.parametrize("override", [f"train.sampler={s}" for s in SAMPLERS] + [
    "graft.feature_mode=sketch_svd", "graft.feature_mode=pca_sketch",
    "graft.feature_mode=pooled_raw", "graft.feature_mode=ica",
    "graft.grad_mode=logit_embed", "graft.grad_mode=full"])
def test_trainer_runs_every_sampler_and_source(override):
    report = Trainer(ExperimentConfig().apply_overrides(SMALL + [override]),
                     device="cpu").fit()
    assert report["steps"] == 4
    for row in report["history"]:
        assert np.isfinite(row["loss"]) and row["healthy"] == 1.0
        assert row["rank"] in (2, 4)


@pytest.mark.parametrize("sampler,feature,grad", [
    ("gradmatch", "sketch_svd", "logit_embed"), ("glister", "pooled_raw", "probe"),
    ("el2n", "pca_sketch", "probe")])
def test_eight_steps_with_other_samplers_and_sources_match_jax(monkeypatch, sampler,
                                                               feature, grad):
    """The whole step, as ``test_torch_slice.py`` holds GRAFT: the port's
    step functions against ``jax.jit(make_train_step)`` with JAX's draws
    injected; per-step loss rtol 1e-4, ranks and pivots equal. CRAIG is
    held by the tests above only: on these refreshes its greedy reaches an
    exact tie, which float32 rounding decides."""
    from repro.optim import OptimizerConfig as JOptCfg
    from repro_torch.optim import OptimizerConfig as TOptCfg
    from repro_torch.launch import steps as tsteps
    _inject(monkeypatch, {tfeat._SKETCH_SVD_SEED: _jax_normal(jfeat._SKETCH_SVD_SEED),
                          tsources._SKETCH_SEED: _jax_normal(jsources._SKETCH_SEED)})
    opt = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
               warmup_steps=1)
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, feature_mode=feature, grad_mode=grad)
    jm, tm, _, _ = _smoke_params()
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**opt), graft=jbase.GraftConfig(**gc),
                            sampler=sampler, probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**opt), graft=tbase.GraftConfig(**gc),
                            sampler=sampler, probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]), Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(8):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))
