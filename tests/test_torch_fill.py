"""Out-of-range ids and NaN inputs on the port's training path, held against
the JAX package on the CPU.

JAX reads an index it cannot read in fill mode: ``jnp.take`` gives a NaN
row, ``take_along_axis`` a NaN entry and ``one_hot`` a zero row, and the
gradient of a filled entry is dropped. The chaos harness's ``nan_batch``
fault relies on it (integer leaves become ``BAD_TOKEN_ID = 2**30``). The
port's ``core/numerics.py`` helpers give the same values in the same
places; in-range results are bit-equal to the plain ops (the existing
parity tests hold them). A poisoned step matches ``jax.jit(make_train_step)``
(non-finite loss, the update skipped), and runs on every family without an
exception. Fast MaxVol on a ``V`` holding NaN takes ``jnp.argmax``'s order
(NaN above every number, the first index on ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core import grad_features as jgf
from repro.core.maxvol import fast_maxvol as jax_fast_maxvol
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import OptimizerConfig as JOptCfg
from repro.resilience import chaos as jchaos
from repro.selection import sources as jsources
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch.api import ExperimentConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import grad_features as tgf
from repro_torch.core.maxvol import fast_maxvol as torch_fast_maxvol
from repro_torch.core.numerics import one_hot_valid, take_last, take_rows
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.resilience import chaos as tchaos
from repro_torch.selection import sources as tsources
from repro_torch.selection.base import GraftConfig as TGraftConfig
from torch_cases import NAN_CASES, nan_case

BAD = tchaos.BAD_TOKEN_ID


def _ids(shape, n, seed=0):
    """int32 ids mixing in-range ones with 2**30, -1 and -(n + 1): JAX
    wraps -1 (``take``) and fills the others."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, size=shape).astype(np.int32)
    flat = ids.reshape(-1)
    flat[::3] = BAD
    flat[1::7] = -1
    flat[2::11] = -(n + 1)
    return ids


def _equal_nan(got, want, rtol=0.0, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


# ---------------------------------------------------------------------------
# the fill helpers against jnp.take / take_along_axis / one_hot
# ---------------------------------------------------------------------------

def test_take_rows_fills_as_jnp_take_and_drops_the_gradient():
    rng = np.random.default_rng(1)
    E = rng.normal(size=(10, 6)).astype(np.float32)
    ids = _ids((4, 9), 10)
    want = np.asarray(jnp.take(jnp.asarray(E), jnp.asarray(ids), axis=0))
    Et = torch.from_numpy(E).requires_grad_()
    got = take_rows(Et, torch.from_numpy(ids))
    _equal_nan(got.detach().numpy(), want)
    assert np.isnan(want).any() and not np.isnan(want).all()
    got.nansum().backward()
    jgrad = jax.grad(lambda e: jnp.nansum(jnp.take(e, jnp.asarray(ids), axis=0)))(
        jnp.asarray(E))
    np.testing.assert_array_equal(Et.grad.numpy(), np.asarray(jgrad))


def test_take_last_fills_as_take_along_axis_and_drops_the_gradient():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    idx = _ids((3, 5), 7, seed=3)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx)[..., None],
                                          axis=-1))[..., 0]
    xt = torch.from_numpy(x).requires_grad_()
    got = take_last(xt, torch.from_numpy(idx))
    _equal_nan(got.detach().numpy(), want)
    got.nansum().backward()
    jgrad = jax.grad(lambda a: jnp.nansum(jnp.take_along_axis(
        a, jnp.asarray(idx)[..., None], axis=-1)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))


def test_one_hot_valid_is_one_hot_with_zero_rows():
    labels = _ids((4, 6), 9, seed=4)
    idx, valid = one_hot_valid(torch.from_numpy(labels), 9)
    got = torch.zeros(4, 6, 9).scatter_(-1, idx[..., None], valid[..., None].float())
    want = np.asarray(jax.nn.one_hot(jnp.asarray(labels), 9, dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the model's sites against the JAX model's
# ---------------------------------------------------------------------------

def _models(arch="minicpm-2b", **ov):
    jm = jsmoke(arch, param_dtype="float32", **ov)
    tm = tsmoke(arch, param_dtype="float32", **ov)
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tmodel.Model(tm))
    return jm, tm, jparams, model


def test_embedding_of_out_of_range_tokens_is_nan_as_in_jax():
    jm, tm, jparams, model = _models()
    tokens = _ids((2, 16), jm.vocab_size, seed=5)
    batch = {"tokens": tokens, "labels": np.zeros_like(tokens)}
    jx, _, _ = jmodel.embed_inputs(jm, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tx, _, _ = tmodel.embed_inputs(tm, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _equal_nan(tx.detach().numpy(), np.asarray(jx))


def test_loss_of_out_of_range_labels_is_nan_as_in_jax():
    """``_nll`` through ``per_example_loss``: the sequences holding a label
    JAX fills are NaN, the others equal at the slice tests' tolerance."""
    jm, tm, jparams, model = _models()
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=4))
    batch = data.batch_at(0)
    batch["labels"][1, 3] = BAD
    batch["labels"][3, 0] = -(jm.vocab_size + 2)
    want = np.asarray(jmodel.per_example_loss(
        jm, jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = tmodel.per_example_loss(tm, model, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()}).numpy()
    assert np.isnan(want[[1, 3]]).all() and np.isfinite(want[[0, 2]]).all()
    _equal_nan(got, want, rtol=1e-5)


def _probe_inputs(seed=6, K=4, S=5, V=11, E=8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(K, S, V)).astype(np.float32)
    hiddens = rng.normal(size=(K, S, E)).astype(np.float32)
    labels = rng.integers(0, V, size=(K, S)).astype(np.int32)
    labels[0, 1] = BAD
    labels[2, 4] = -1
    labels[3, :] = BAD
    mask = (rng.random((K, S)) > 0.2).astype(np.float32)
    return logits, labels, hiddens, mask


@pytest.mark.parametrize("masked", [False, True])
def test_logit_error_embeddings_skip_out_of_range_labels_as_one_hot(masked):
    logits, labels, hiddens, mask = _probe_inputs()
    m = mask if masked else None
    want = np.asarray(jgf.logit_error_embeddings(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(hiddens),
        None if m is None else jnp.asarray(m)))
    got = tgf.logit_error_embeddings(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(hiddens),
        None if m is None else torch.from_numpy(m)).numpy()
    assert np.isnan(want).any()
    _equal_nan(got, want, rtol=1e-5, atol=1e-6)


def test_logit_embed_skips_out_of_range_labels_as_one_hot():
    logits, labels, hiddens, mask = _probe_inputs(seed=7)
    rng = np.random.default_rng(8)
    head = rng.normal(size=(8, 11)).astype(np.float32)
    want = np.asarray(jsources.logit_embed_grad_source(jsources.GradSourceInputs(
        logits=jnp.asarray(logits), labels=jnp.asarray(labels),
        hiddens=jnp.asarray(hiddens), params={"lm_head": jnp.asarray(head)},
        mask=jnp.asarray(mask))))
    got = tsources.logit_embed_grad_source(tsources.GradSourceInputs(
        logits=torch.from_numpy(logits), labels=torch.from_numpy(labels),
        hiddens=torch.from_numpy(hiddens), params={"lm_head": torch.from_numpy(head)},
        mask=torch.from_numpy(mask))).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# a poisoned step
# ---------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_clone(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a == b


def _jax_equal(a, b) -> bool:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_poisoned_batch_is_byte_equal_to_jax():
    data = SyntheticLM(DataConfig(vocab_size=512, seq_len=16, global_batch=8))
    batch = dict(data.batch_at(0), x=np.ones((2, 3), np.float32),
                 small=np.arange(4, dtype=np.int8))
    jp = jchaos.FaultPlan([{"kind": "nan_batch", "step": 0}]).corrupt_batch(0, batch)
    tp = tchaos.FaultPlan([{"kind": "nan_batch", "step": 0}]).corrupt_batch(0, batch)
    assert jp.keys() == tp.keys()
    for k in jp:
        assert jp[k].dtype == tp[k].dtype and jp[k].tobytes() == tp[k].tobytes()
    assert (tp["tokens"] == BAD).all() and (tp["small"] == 127).all()


def test_poisoned_step_matches_jax_train_step():
    """One GRAFT refresh step on a poisoned batch after one clean step:
    both packages give a non-finite loss, healthy 0, bad_streak 1, and
    leave params, optimizer state and graft state as they were."""
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=1, use_pallas=False)
    opt = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=4,
               warmup_steps=1)
    jm, tm, _, _ = _models()
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**opt), graft=JGraftConfig(**gc),
                            probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**opt), graft=TGraftConfig(**gc),
                            probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                              tmodel.Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    clean = data.batch_at(0)
    jstate, _ = jfn(jstate, {k: jnp.asarray(v) for k, v in clean.items()})
    tstate, _ = tfn(tstate, {k: torch.from_numpy(v) for k, v in clean.items()})
    poisoned = tchaos.FaultPlan([{"kind": "nan_batch", "step": 1}]).corrupt_batch(
        1, data.batch_at(1))

    j_before = {k: jstate[k] for k in ("params", "opt", "graft")}
    j_before = jax.tree_util.tree_map(np.array, j_before)
    t_before = {"params": _clone(tstate["params"]), "opt": _clone(tstate["opt"]),
                "graft": _clone(tstate["graft"])}
    jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in poisoned.items()})
    tstate, tmet = tfn(tstate, {k: torch.from_numpy(v) for k, v in poisoned.items()})

    assert not np.isfinite(float(jmet["loss"])) and not np.isfinite(float(tmet["loss"]))
    assert float(jmet["healthy"]) == tmet["healthy"] == 0.0
    assert int(jmet["bad_streak"]) == tmet["bad_streak"] == 1
    assert int(jstate["step"]) == tstate["step"] == 2
    assert _jax_equal(jstate["params"], j_before["params"])
    assert _jax_equal(jstate["opt"], j_before["opt"])
    for f in ("pivots", "weights", "rank", "last_error", "alignment"):
        assert _jax_equal(getattr(jstate["graft"], f), getattr(j_before["graft"], f)), f
        assert _tree_equal(getattr(tstate["graft"], f), getattr(t_before["graft"], f)), f
    assert _tree_equal(tstate["params"], t_before["params"])
    assert _tree_equal(tstate["opt"], t_before["opt"])
    # the state after the skipped update still equals JAX's where the
    # clean step left them equal
    np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                  np.asarray(jstate["graft"].pivots))


@pytest.mark.parametrize("overrides", [
    ["model.arch=qwen3-moe-235b-a22b", "train.seq=32"],
    ["model.arch=rwkv6-7b"],
    ["model.arch=hymba-1.5b", "train.seq=32"],
    ["data.source=synthetic_classification", "model.arch=musicgen-medium"],
    ["data.source=synthetic_vision", "model.arch=internvl2-26b"],
    ["graft.grad_mode=logit_embed"],
    ["train.sampler=streaming_graft"]],
    ids=["moe", "ssm", "hybrid", "audio", "vlm", "logit_embed", "streaming"])
def test_poisoned_step_runs_on_every_family(overrides):
    """Each family's poisoned refresh step reads every index in fill mode
    (the CPU raises on any index out of range): no exception, the update
    skipped."""
    cfg = ExperimentConfig().apply_overrides(
        ["train.batch=8", "train.seq=16", "graft.rset=[2,4]"] + overrides)
    mcfg, tcfg, data = cfg.build()
    state = tsteps.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), 8)
    before = _clone(state["params"])
    batch = tchaos.FaultPlan([{"kind": "nan_batch", "step": 0}]).corrupt_batch(
        0, data.batch_at(0))
    state, metrics = tsteps.make_train_step(mcfg, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not np.isfinite(float(metrics["loss"]))
    assert metrics["healthy"] == 0.0 and metrics["bad_streak"] == 1
    assert _tree_equal(state["params"], before)


# ---------------------------------------------------------------------------
# Fast MaxVol on NaN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", NAN_CASES)
@pytest.mark.parametrize("K,R", [(40, 8), (16, 8), (64, 16)])
def test_fast_maxvol_nan_order_matches_jax(case, K, R):
    V = nan_case(case, K, R)
    want_p, want_lv = jax_fast_maxvol(jnp.asarray(V), R)
    got_p, got_lv = torch_fast_maxvol(torch.from_numpy(V), R)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert sorted(got_p.tolist()) == sorted(set(got_p.tolist()))     # distinct rows
    _equal_nan(got_lv.numpy(), np.asarray(want_lv), rtol=1e-5)
