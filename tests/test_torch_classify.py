"""The port's classification task against the JAX package, on the CPU at
smoke size: the ``synthetic_classification`` and ``synthetic_vision``
sources, the ``audio_frames`` and ``vision_patches`` frontends
(musicgen-medium, internvl2-26b), the accuracy eval, and GRAFT training on
batches that carry no ``tokens`` or ``tokens`` of width 1.

* Sources: ``batch_at``, ``classes_at``, ``images_at``, ``spec`` and the
  finite ``SyntheticClassification`` set (``split``, ``batches``) byte-equal
  to the JAX package's; the adapters' derived configs, pinned model fields
  and ``validate`` messages equal.
* Model, float32 params carried across by the bridge: ``loss_fn``,
  ``per_example_loss`` and ``pooled_features`` at rtol 1e-5, and the
  weighted subset loss's gradients at rtol 1e-4 with 1e-5 of each leaf's
  largest value (the tolerances of ``test_torch_families.py``); in bf16 the
  losses at rtol 1e-2, one bf16 rounding (as ``test_torch_optim.py`` holds
  bf16 leaves).
* ``selection_inputs`` under the probe, logit_embed and full grad sources
  against JAX's (V up to column sign, G, ḡ and scores at rtol 1e-5 with
  1e-5 of the largest value).
* A 6-step ``Trainer`` run on each source (JAX's initial weights loaded at
  ``on_train_start``) against ``jax.jit(make_train_step)``: losses rtol
  1e-4, ranks and pivots equal; the classification eval against JAX's
  ``_classification_eval`` (loss rtol 1e-5, accuracy equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import ExperimentConfig as JExperimentConfig
from repro.configs import get_smoke_config as jsmoke
from repro.data import pipeline as jpipe
from repro.data import sources as jsources
from repro.launch import evaluate as jevaluate
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.api.callbacks import Callback
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import pipeline as tpipe
from repro_torch.data import sources as tsources
from repro_torch.launch import evaluate as tevaluate
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel

T = torch.from_numpy
SOURCES = ["synthetic_classification", "synthetic_vision"]
ARCH_OF = {"synthetic_classification": "musicgen-medium", "synthetic_vision": "internvl2-26b"}
# (source, config fields): the defaults, and skew, noise and shape knobs
SOURCE_CASES = [
    ("synthetic_classification", {}),
    ("synthetic_classification", {"imbalance": 1.0, "label_noise": 0.3, "frames": 3,
                                  "feature_dim": 50, "num_classes": 7}),
    ("synthetic_vision", {}),
    ("synthetic_vision", {"imbalance": 0.8, "label_noise": 0.2, "image_size": 8,
                          "patch_size": 2, "channels": 2}),
]


def _close(got, want, rtol=1e-5, scale=1e-5, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


def _sources(name, fields, embed_dim=64, batch=8, **extra):
    kw = dict(fields, embed_dim=embed_dim, global_batch=batch, **extra)
    return (jsources.get_source(name).build(jsources.get_source(name).config_cls(**kw)),
            tsources.get_source(name).build(tsources.get_source(name).config_cls(**kw)))


def _same_bytes(a, b, msg=""):
    assert a.dtype == b.dtype and a.shape == b.shape, msg
    assert a.tobytes() == b.tobytes(), msg


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,fields", SOURCE_CASES)
def test_batches_are_byte_equal_to_jax(name, fields):
    js, ts = _sources(name, fields)
    assert {k: (tuple(v.shape), v.dtype) for k, v in js.spec().items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in ts.spec().items()}
    for step in (0, 1, 17):
        jb, tb = js.batch_at(step), ts.batch_at(step)
        assert list(jb) == list(tb)
        for k in jb:
            _same_bytes(jb[k], tb[k], f"{k} at step {step}")
            assert tb[k].shape == ts.spec()[k].shape
    _same_bytes(js.microbatch_stack(3, 2)[next(iter(jb))],
                ts.microbatch_stack(3, 2)[next(iter(tb))])
    if name == "synthetic_classification":
        _same_bytes(js.classes_at(5), ts.classes_at(5))
    else:
        for a, b in zip(js.images_at(5), ts.images_at(5)):
            _same_bytes(a, b)


@pytest.mark.parametrize("name", SOURCES)
def test_host_shards_are_byte_equal_to_jax(name):
    whole = _sources(name, {}, batch=8)[1].batch_at(2)
    for host in range(2):
        js, ts = _sources(name, {}, batch=8, num_hosts=2, host_index=host)
        jb, tb = js.batch_at(2), ts.batch_at(2)
        for k in jb:
            _same_bytes(jb[k], tb[k])
            _same_bytes(tb[k], whole[k][4 * host:4 * host + 4])


@pytest.mark.parametrize("imbalance", [0.0, 1.2])
def test_finite_classification_set_is_byte_equal_to_jax(imbalance):
    kw = dict(n=300, dim=12, num_classes=5, label_noise=0.1, seed=3, imbalance=imbalance)
    jd, td = jpipe.SyntheticClassification(**kw), tpipe.SyntheticClassification(**kw)
    _same_bytes(jd.x, td.x)
    _same_bytes(jd.y, td.y)
    for a, b in zip(jax.tree_util.tree_leaves(jd.split(0.25, seed=4)),
                    jax.tree_util.tree_leaves(td.split(0.25, seed=4))):
        _same_bytes(a, b)
    jit, tit = jpipe.batches(jd.x, jd.y, 16, seed=2), tpipe.batches(td.x, td.y, 16, seed=2)
    for _ in range(3):
        for a, b in zip(next(jit), next(tit)):
            _same_bytes(a, b)
    np.testing.assert_array_equal(tpipe.zipf_class_probs(5, imbalance),
                                  jpipe.zipf_class_probs(5, imbalance))


def test_registry_adapters_and_validate_messages_match_jax():
    assert tsources.available_sources() == jsources.available_sources()
    assert tsources._SOURCES.not_ported == ()
    for name in SOURCES:
        jm, tm = jsmoke(ARCH_OF[name]), tsmoke(ARCH_OF[name])
        jd = jsources.derive_config(name, jm, batch=8, seq=16, seed=3)
        td = tsources.derive_config(name, tm, batch=8, seq=16, seed=3)
        assert dataclasses.asdict(jd) == dataclasses.asdict(td)
        jt, tt = jsources.get_source(name).task, tsources.get_source(name).task
        assert jt.kind == tt.kind == "classification"
        assert jt.model_overrides(jd) == tt.model_overrides(td)
        bad = {"embed_dim": 3, "global_batch": 4, "num_classes": 11}
        if name == "synthetic_vision":
            bad["patch_size"] = 8
        jbad = dataclasses.replace(jd, **bad)
        tbad = dataclasses.replace(td, **bad)
        jmsg, tmsg = jt.validate(jbad, jm, 8, 16), tt.validate(tbad, tm, 8, 16)
        assert tmsg == jmsg and len(tmsg) == 4
        zero = dataclasses.replace(td, embed_dim=0, global_batch=0)
        assert tt.finalize(zero, tm, batch=8, seq=16, seed=3) == td
        with pytest.raises(ValueError, match="exceeds embed_dim"):
            tsources.get_source(name).build(dataclasses.replace(td, embed_dim=1))


@pytest.mark.parametrize("name", SOURCES)
def test_experiment_configs_switch_sources_as_in_jax(name):
    overrides = [f"data.source={name}", f"model.arch={ARCH_OF[name]}", "train.batch=8"]
    jcfg = JExperimentConfig().apply_overrides(overrides)
    tcfg = ExperimentConfig().apply_overrides(overrides)
    assert tcfg.finalized().to_dict() == jcfg.finalized().to_dict()
    assert tcfg.config_hash() == jcfg.config_hash()
    mcfg, _, data = tcfg.build()
    jm, _, _ = jcfg.build()
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(jm)
    assert mcfg.vocab_size == 10 and data.cfg.embed_dim == mcfg.d_model
    back = ExperimentConfig.from_json(tcfg.to_json())
    assert back.config_hash() == tcfg.config_hash()
    # a later model override re-derives the data section, as in JAX
    over = ["model.overrides={\"d_model\": 96}"]
    assert ExperimentConfig().apply_overrides(overrides + over).finalized().data.embed_dim == \
        JExperimentConfig().apply_overrides(overrides + over).finalized().data.embed_dim == 96


# ---------------------------------------------------------------------------
# the frontends
# ---------------------------------------------------------------------------

def _model_pair(name, dtype="float32", seed=1):
    js, ts = (jsources.get_source(name), tsources.get_source(name))
    jd = js.task.derive(jsmoke(ARCH_OF[name]), batch=4, seq=16, seed=0)
    td = ts.task.derive(tsmoke(ARCH_OF[name]), batch=4, seq=16, seed=0)
    jm = jsmoke(ARCH_OF[name], param_dtype=dtype, **js.task.model_overrides(jd))
    tm = tsmoke(ARCH_OF[name], param_dtype=dtype, **ts.task.model_overrides(td))
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(seed))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tmodel.Model(tm))
    return jm, tm, jparams, model, ts.build(td).batch_at(0)


@pytest.mark.parametrize("name", SOURCES)
def test_forward_losses_and_pooled_features_match_jax(name):
    jm, tm, jparams, model, b = _model_pair(name)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jh, jmask = jmodel.forward_hiddens(jm, jparams, jb)
    jl, jloss, jpool = (jmodel.per_example_loss(jm, jparams, jb),
                        jmodel.loss_fn(jm, jparams, jb)[0],
                        jmodel.pooled_features(jm, jparams, jb))
    tb = {k: T(v) for k, v in b.items()}
    with torch.no_grad():
        th, tmask = tmodel.forward_hiddens(tm, model, tb)
        tl = tmodel.per_example_loss(tm, model, tb)
        tloss, _ = tmodel.loss_fn(tm, model, tb)
        tpool = tmodel.pooled_features(tm, model, tb)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    if name == "synthetic_vision":      # patches unlabeled, the query token labeled
        assert tmask.shape[1] == tm.num_patches + 1 and tmask[:, :-1].sum() == 0
    _close(th.numpy(), jh, msg="hiddens")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close(tpool.numpy(), jpool, msg="pooled")
    _close(tmodel.pooled_hiddens(th, tmask).numpy(), jpool, msg="pooled_hiddens")


@pytest.mark.parametrize("name", SOURCES)
def test_weighted_subset_loss_grads_match_jax(name):
    jm, tm, jparams, model, b = _model_pair(name)
    w = np.asarray([0.5, 0.25, 0.25, 0.0], np.float32)
    jg = jax.grad(lambda p: jnp.sum(jmodel.per_example_loss(
        jm, p, {k: jnp.asarray(v) for k, v in b.items()}) * jnp.asarray(w)))(jparams)
    loss = torch.sum(tmodel.per_example_loss(tm, model, {k: T(v) for k, v in b.items()}) * T(w))
    leaves, spec = torch.utils._pytree.tree_flatten(model.tree())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    tg = params_to_numpy(torch.utils._pytree.tree_unflatten(grads, spec))
    flat_t, tdef = jax.tree_util.tree_flatten(tg)
    flat_j, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert tdef == jdef
    for a, e in zip(flat_t, flat_j):
        _close(a, e, rtol=1e-4, scale=1e-5)


@pytest.mark.parametrize("name", SOURCES)
def test_bf16_losses_match_jax(name):
    jm, tm, jparams, model, b = _model_pair(name, dtype="bfloat16")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    with torch.no_grad():
        tl = tmodel.per_example_loss(tm, model, {k: T(v) for k, v in b.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jmodel.per_example_loss(jm, jparams, jb)),
                               rtol=1e-2)


def test_families_build_dense_blocks_with_their_frontends():
    for arch in ARCH_OF.values():
        tm = tsmoke(arch)
        model = tmodel.Model(tm)
        assert set(model.tree()["blocks"][0]) == {"ln1", "attn", "ln2", "mlp"}
    with pytest.raises(ValueError, match="frontend"):
        tmodel.Model(tsmoke("minicpm-2b", frontend="mel_frames"))


# ---------------------------------------------------------------------------
# selection and training on classification batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("grad_mode", ["probe", "logit_embed", "full"])
def test_selection_inputs_match_jax(name, grad_mode):
    from repro.selection.base import GraftConfig as JGraftConfig
    from repro_torch.selection.base import GraftConfig as TGraftConfig
    jm, tm, jparams, model, b = _model_pair(name)
    gc = dict(rset=(2, 4), eps=0.25, grad_mode=grad_mode)
    jt = jsteps.TrainConfig(graft=JGraftConfig(**gc), probe_positions=2)
    tt = tsteps.TrainConfig(graft=TGraftConfig(**gc), probe_positions=2)
    jout = jsteps.selection_inputs(jm, jt, jparams, {k: jnp.asarray(v) for k, v in b.items()})
    tout = tsteps.selection_inputs(tm, tt, model.tree(), {k: T(v) for k, v in b.items()})
    V, Vj = tout[0].numpy(), np.asarray(jout[0])
    _close(V * np.sign(np.sum(V * Vj, axis=0)), Vj, msg="V")
    for got, want, what in zip(tout[1:], jout[1:], ("G", "g_bar", "scores")):
        _close(got.numpy(), want, msg=what)


OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8, warmup_steps=1)


class _LoadJaxWeights(Callback):
    """Loads JAX's initial params into the port's state before the first
    step, and records each step's pivots."""
    priority = 0

    def __init__(self, jparams):
        self.jparams = jparams
        self.pivots = []

    def on_train_start(self, trainer):
        params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams),
                          trainer.state["model"])

    def on_step_end(self, trainer, step, metrics):
        self.pivots.append(trainer.state["graft"].pivots.tolist())


@pytest.mark.parametrize("name", SOURCES)
def test_six_trainer_steps_match_jax_step_functions(name):
    overrides = [f"data.source={name}", f"model.arch={ARCH_OF[name]}",
                 'model.overrides={"param_dtype": "float32"}', "train.batch=8",
                 "train.steps=6", "graft.rset=[2,4]", "graft.refresh_every=2",
                 "graft.use_pallas=true", "train.log_every=0", "train.eval_every=3",
                 "train.probe_positions=2"] + [f"optimizer.{k}={v}" for k, v in OPT.items()]
    jm, jt, jdata = JExperimentConfig().apply_overrides(overrides).build()
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    jparams0 = jax.tree_util.tree_map(np.asarray, jstate["params"])
    jfn = jax.jit(jsteps.make_train_step(jm, jt))
    jrows = []
    for step in range(6):
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in jdata.batch_at(step).items()})
        jrows.append((float(jmet["loss"]), int(jmet["rank"]),
                      np.asarray(jstate["graft"].pivots).tolist()))
    loader = _LoadJaxWeights(jparams0)
    trainer = Trainer(ExperimentConfig().apply_overrides(overrides), callbacks=[loader],
                      device="cpu")
    report = trainer.fit()
    assert report["steps"] == 6
    for row, pivots, (jl, jr, jp) in zip(report["history"], loader.pivots, jrows):
        np.testing.assert_allclose(row["loss"], jl, rtol=1e-4)
        assert int(row["rank"]) == jr and pivots == jp
    # the held-out eval of the trained params against JAX's on the same batches
    evals = [r for r in report["history"] if "eval_acc" in r]
    assert len(evals) == 2 and 0.0 <= report["eval"]["eval_acc"] <= 1.0
    dcfg = trainer.config.data
    data = tsources.get_source(name).build(dataclasses.replace(dcfg, global_batch=8))
    batches = [data.batch_at(tevaluate.EVAL_STEP_OFFSET + i) for i in range(4)]
    jev = jevaluate._classification_eval(jm, batches)(jstate["params"])
    tev = tevaluate._classification_eval(trainer.mcfg, batches, "cpu")(trainer.state["model"])
    np.testing.assert_allclose(tev["eval_loss"], jev["eval_loss"], rtol=1e-4)
    assert tev["eval_acc"] == jev["eval_acc"]


@pytest.mark.parametrize("name", SOURCES)
def test_classification_eval_matches_jax(name):
    jm, tm, jparams, model, _ = _model_pair(name, seed=5)
    dcfg = tsources.get_source(name).task.derive(tm, batch=8, seq=16, seed=2)
    data = tsources.get_source(name).build(dcfg)
    batches = [data.batch_at(tevaluate.EVAL_STEP_OFFSET + i) for i in range(4)]
    jev = jevaluate._classification_eval(jm, batches)(jparams)
    tev = tevaluate._classification_eval(tm, batches, "cpu")(model)
    assert set(tev) == set(jev) == {"eval_loss", "eval_acc"}
    np.testing.assert_allclose(tev["eval_loss"], jev["eval_loss"], rtol=1e-5)
    assert tev["eval_acc"] == jev["eval_acc"]
    hits = []
    with torch.no_grad():
        for b in batches:
            tb = {k: T(v) for k, v in b.items()}
            h, mask = tmodel.forward_hiddens(tm, model, tb)
            pred = tmodel.logits_from_hiddens(tm, model, h).argmax(-1)
            labels = tmodel._pad_labels(tb["labels"], h.shape[1])
            hits.append(float(((pred == labels).float() * mask).sum() / mask.sum()))
    assert tev["eval_acc"] == pytest.approx(np.mean(hits), abs=1e-7)


@pytest.mark.parametrize("name", SOURCES)
def test_baseline_step_accumulates_classification_batches_as_jax(name):
    overrides = [f"data.source={name}", f"model.arch={ARCH_OF[name]}",
                 'model.overrides={"param_dtype": "float32"}', "train.batch=8", "graft=none",
                 "train.microbatches=2"] + [f"optimizer.{k}={v}" for k, v in OPT.items()]
    jm, jt, jdata = JExperimentConfig().apply_overrides(overrides).build()
    tm, tt, tdata = ExperimentConfig().apply_overrides(overrides).build()
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                              tmodel.Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(3):
        b = tdata.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
