"""The port's streaming sampler against the JAX package, ``graft.overlap``
against the sequential step, and the sketch carry through both checkpoint
formats (CPU).

* ``streaming_graft``: at β = 0 the first refresh is bit-identical to plain
  ``graft`` in the port, and equals JAX's (pivots, rank, weights exactly;
  error and alignment rtol 1e-5). Pivots equal JAX's at every refresh
  (MaxVol runs on V alone). At the default L 64 with K 16, the errors,
  rank, weights and carry are held for refreshes 1–2: error, alignment,
  agreement rtol 1e-5, weights atol 1e-6, ``g_ema`` and ``count``
  bit-equal, the sketch as ``sketchᵀ·sketch`` within 1e-5 of its largest
  entry (row signs are free; the Gram eigh is float32 in another LAPACK).
  From the third refresh the reference's rounding-noise sketch rows pass
  the ``norm > 1e-8`` guard (``test_noise_rows_of_the_sketch_pass_the_guard``)
  and what depends on the agreement follows its eigensolver's rounding; the
  port's float64 Gram eigh leaves those rows below the guard.
  With ``sketch_rows`` ≤ K the combined matrix has full rank and everything
  is held over 6 refreshes.
* The train step with ``streaming_graft`` against
  ``jax.jit(repro.launch.steps.make_train_step)`` (no mesh): per-step loss
  rtol 1e-4, ranks and pivots equal, as ``test_torch_slice.py`` holds GRAFT.
* Overlap: ``graft.overlap`` runs the sequential step
  (``launch.steps.make_run_step``), so its trajectory (losses, ranks,
  pivots, params) is bit-identical to the sequential one; the JAX
  ``TestOverlappedSelector`` fails on jax 0.9, and the sequential path is
  held to JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import ExperimentConfig as JExperimentConfig
from repro.backend import resolve as jresolve_backend
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection import base as jbase
from repro.selection import graft as jgraft
from repro.selection import streaming as jstream
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.checkpoint import (CheckpointManager, load_train_state, params_from_numpy,
                                    train_state_spec, train_state_to_host)
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import steps as tsteps
from repro_torch.models.model import Model
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.selection import base as tbase
from repro_torch.selection import engine, registry
from repro_torch.selection import graft as tgraft
from repro_torch.selection import streaming as tstream

T = torch.from_numpy
OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
           warmup_steps=1)
SMALL = ["train.steps=6", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0"]


def _stream_inputs(n, d=72, K=16, R=8, seed=0):
    """``n`` refreshes' (V, G, ḡ): G shares a drift direction so that the
    batches agree with the stream."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = []
    for _ in range(n):
        V = rng.normal(size=(K, R)).astype(f)
        G = (rng.normal(size=(d, K)) + 0.5 * rng.normal(size=(d, 1))).astype(f)
        out.append((V, G, G.mean(axis=1).astype(f)))
    return out


def _run_both(L, n, use_pallas=False, **shape):
    kw = dict(rset=(2, 4, 8), eps=0.25, sketch_rows=L, use_pallas=use_pallas)
    jc, tc = jbase.GraftConfig(**kw), tbase.GraftConfig(**kw)
    inputs = _stream_inputs(n, **shape)
    K, d = inputs[0][0].shape[0], inputs[0][1].shape[0]
    jcar = jstream.init_sketch_carry(jc, jbase.CarrySpec(K, d))
    tcar = tstream.init_sketch_carry(tc, tbase.CarrySpec(K, d))
    rows = []
    for i, (V, G, gb) in enumerate(inputs):
        js, jcar = jstream.streaming_select_fn(
            jc, jbase.SelectionInputs(jnp.asarray(V), jnp.asarray(G), jnp.asarray(gb)),
            jcar, jnp.int32(i))
        ts, tcar = registry.get_sampler("streaming_graft").select(
            tc, tbase.SelectionInputs(T(V), T(G), T(gb)), tcar, i)
        rows.append((js, jcar, ts, tcar))
    return rows


def _assert_held(js, jcar, ts, tcar):
    assert int(ts.rank) == int(js.rank) and int(ts.step) == int(js.step)
    np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights), atol=1e-6)
    np.testing.assert_allclose(float(ts.last_error), float(js.last_error), rtol=1e-5)
    np.testing.assert_allclose(float(ts.alignment), float(js.alignment), rtol=1e-5)
    np.testing.assert_allclose(float(tcar.agreement), float(jcar.agreement), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(tcar.g_ema.numpy(), np.asarray(jcar.g_ema))
    assert float(tcar.count) == float(jcar.count)
    sj, st = np.asarray(jcar.sketch), tcar.sketch.numpy()
    gj, gt = sj.T @ sj, st.T @ st
    np.testing.assert_allclose(gt, gj, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_first_refresh_is_plain_graft(use_pallas):
    (V, G, gb), = _stream_inputs(1)
    cfg = tbase.GraftConfig(rset=(2, 4, 8), use_pallas=use_pallas)
    step = torch.tensor(0, dtype=torch.int32)
    ts, carry = tstream.streaming_select_fn(
        cfg, tbase.SelectionInputs(T(V), T(G), T(gb)),
        tstream.init_sketch_carry(cfg, tbase.CarrySpec(16, 72)), step)
    plain = tgraft.graft_select(cfg, T(V), T(G), T(gb), step)
    for f in plain._fields:
        assert torch.equal(getattr(ts, f), getattr(plain, f)), f
    assert float(carry.agreement) == 0.0 and float(carry.count) == 1.0
    js = jgraft.graft_select(jbase.GraftConfig(rset=(2, 4, 8), use_pallas=use_pallas),
                             jnp.asarray(V), jnp.asarray(G), jnp.asarray(gb), jnp.int32(0))
    np.testing.assert_array_equal(ts.pivots.numpy(), np.asarray(js.pivots))
    np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(js.weights))
    assert int(ts.rank) == int(js.rank)
    np.testing.assert_allclose(float(ts.last_error), float(js.last_error), rtol=1e-5)
    np.testing.assert_allclose(float(ts.alignment), float(js.alignment), rtol=1e-5)


def test_default_sketch_matches_jax_where_it_is_determined():
    """L 64, K 16: pivots at all 6 refreshes; everything else for 1–2."""
    rows = _run_both(64, 6)
    for i, (js, jcar, ts, tcar) in enumerate(rows):
        np.testing.assert_array_equal(ts.pivots.numpy(), np.asarray(js.pivots), err_msg=str(i))
        if i < 2:
            _assert_held(js, jcar, ts, tcar)


@pytest.mark.parametrize("L", [8, 16])
def test_full_rank_sketch_matches_jax_over_six_refreshes(L):
    for js, jcar, ts, tcar in _run_both(L, 6):
        np.testing.assert_array_equal(ts.pivots.numpy(), np.asarray(js.pivots))
        _assert_held(js, jcar, ts, tcar)


def test_noise_rows_of_the_sketch_pass_the_guard():
    """The reference's fault: after the second ``fd_update`` at K 16, L 64,
    d 2304 only 32 rows are real, yet rows whose norms are below 1e-4 of the
    largest (images of null-space eigenvectors) pass ``sketch_projection``'s
    ``norm > 1e-8`` guard and are scaled to unit length. The port takes the
    Gram's eigendecomposition in float64 (MKL's float32 one fails to
    converge on such Grams), so its null-space rows stay below the guard."""
    rng = np.random.default_rng(0)
    K, d, L = 16, 2304, 64
    jc, tc = jbase.GraftConfig(rset=(2, 4, 8)), tbase.GraftConfig(rset=(2, 4, 8))
    sj, st = jnp.zeros((L, d)), torch.zeros(L, d)
    for _ in range(2):
        G = rng.normal(size=(d, K)).astype(np.float32)
        sj, st = jstream.fd_update(jc, sj, jnp.asarray(G)), tstream.fd_update(tc, st, T(G))
    jn = np.sort(np.linalg.norm(np.asarray(sj), axis=1))[::-1]
    tn = np.sort(torch.linalg.norm(st, dim=1).numpy())[::-1]
    np.testing.assert_allclose(tn[:2 * K], jn[:2 * K], rtol=1e-5)    # the real rows
    assert jn[2 * K - 1] > 0.1 * jn[0] and jn[2 * K] < 1e-3 * jn[0]
    noise = (jn > 1e-8) & (jn < 1e-4 * jn[0])
    assert noise.sum() > 0                                        # pass the guard
    assert np.all(tn[2 * K:] < 1e-8)                              # below the guard
    jp = np.asarray(jstream.sketch_projection(sj, jnp.ones(d)))
    tp = tstream.sketch_projection(st, torch.ones(d)).numpy()
    assert np.linalg.norm(jp) > np.linalg.norm(tp)                # noise rows count in full


def test_fd_gram_eigh_survives_exact_zero_rows():
    """The Gram of a sketch with 56 exact zero rows of 72 (smoke size, the
    second refresh), on which MKL's float32 eigh does not converge."""
    rng = np.random.default_rng(1)
    cfg = tbase.GraftConfig(rset=(2, 4), sketch_rows=64)
    sketch = torch.zeros(64, 72)
    for _ in range(2):
        sketch = tstream.fd_update(cfg, sketch, T(rng.normal(size=(72, 8)).astype(np.float32)))
    norms = torch.linalg.norm(sketch, dim=1)
    assert torch.isfinite(sketch).all() and int((norms > 1e-8).sum()) == 16


@pytest.mark.parametrize("sketch_rows,steps", [(8, 8), (64, 4)])
def test_streaming_steps_match_jax_train_step(sketch_rows, steps):
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True, sketch_rows=sketch_rows)
    jm = jsmoke("minicpm-2b", param_dtype="float32")
    tm = tsmoke("minicpm-2b", param_dtype="float32")
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), graft=jbase.GraftConfig(**gc),
                            sampler="streaming_graft", probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), graft=tbase.GraftConfig(**gc),
                            sampler="streaming_graft", probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]), Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    assert isinstance(tstate["sampler_carry"], tstream.SketchCarry)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(steps):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))
        jc, tc = jstate["sampler_carry"], tstate["sampler_carry"]
        assert float(tc.count) == float(jc.count) == step // 2 + 1
        np.testing.assert_allclose(tc.g_ema.numpy(), np.asarray(jc.g_ema), rtol=1e-4, atol=1e-6)


def test_multi_batch_streaming_lanes_are_independent_streams():
    cfg = tbase.GraftConfig(rset=(2, 4, 8), use_pallas=True)
    ins = _stream_inputs(6)
    Vs, Gs, gbs = (torch.stack([T(x[i]) for x in ins[:3]]) for i in range(3))
    carry = None
    singles = [None] * 3
    for step in range(2):
        multi, carry = engine.select_multi_batch(cfg, "streaming_graft", Vs, Gs, gbs,
                                                 carry=carry, step=step)
        for b in range(3):
            st, singles[b] = engine.select_batch(cfg, "streaming_graft", Vs[b], Gs[b], gbs[b],
                                                 carry=singles[b], step=step)
            assert torch.equal(multi.pivots[b], st.pivots)
            assert torch.equal(multi.weights[b], st.weights)
    assert isinstance(carry, tstream.SketchCarry) and carry.sketch.shape == (3, 64, 72)
    for b in range(3):
        assert torch.equal(carry.sketch[b], singles[b].sketch)
        assert float(carry.count[b]) == 2.0


# ---------------------------------------------------------------------------
# the carry in the checkpoint
# ---------------------------------------------------------------------------

STREAM = SMALL + ["graft.streaming=true", "graft.sketch_rows=8"]


def test_carry_round_trips_through_the_port_checkpoint_format():
    trainer = Trainer(ExperimentConfig().apply_overrides(STREAM + ["train.steps=3"]),
                      device="cpu")
    trainer.fit()
    carry = trainer.state["sampler_carry"]
    assert isinstance(carry, tstream.SketchCarry) and float(carry.count) == 2.0
    flat = train_state_to_host(trainer.state)
    assert {k for k in flat if k.startswith("sampler_carry/")} == {
        "sampler_carry/.sketch", "sampler_carry/.g_ema", "sampler_carry/.count",
        "sampler_carry/.agreement"}
    fresh = tsteps.init_train_state(trainer.mcfg, trainer.tcfg,
                                    torch.Generator().manual_seed(1), 8, "cpu")
    assert float(fresh["sampler_carry"].count) == 0.0
    load_train_state(fresh, flat)
    assert isinstance(fresh["sampler_carry"], tstream.SketchCarry)
    for f in carry._fields:
        assert torch.equal(getattr(fresh["sampler_carry"], f), getattr(carry, f)), f
    assert train_state_spec(fresh) == train_state_spec(trainer.state)


def test_streaming_checkpoint_crosses_to_jax_and_back(tmp_path):
    overrides = STREAM + ["train.steps=4", f"train.checkpoint_dir={tmp_path / 'port'}"]
    trainer = Trainer(ExperimentConfig().apply_overrides(overrides), device="cpu")
    trainer.fit()
    port = train_state_to_host(trainer.state)
    jm, jt, _ = JExperimentConfig().apply_overrides(overrides).build()
    assert jt.sampler == "streaming_graft"
    target = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(1), 8)
    tree = JCheckpointManager(str(tmp_path / "port")).restore(
        4, target, verify=True, backend=jresolve_backend(None))
    assert isinstance(tree["sampler_carry"], jstream.SketchCarry)
    jflat = _flatten_with_paths(tree)
    assert set(jflat) == set(port)
    for k in ("sampler_carry/.sketch", "sampler_carry/.g_ema", "sampler_carry/.count",
              "sampler_carry/.agreement"):
        np.testing.assert_array_equal(jflat[k], port[k].numpy(), err_msg=k)
    # the reverse: a JAX state stepped twice by its own step function
    jfn = jax.jit(jsteps.make_train_step(jm, jt))
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    for step in range(3):
        jstate, _ = jfn(jstate, {k: jnp.asarray(v) for k, v in data.batch_at(step).items()})
    JCheckpointManager(str(tmp_path / "jax")).save(3, jstate)
    tstate = tsteps.init_train_state(trainer.mcfg, trainer.tcfg,
                                     torch.Generator().manual_seed(0), 8, "cpu")
    step0, flat, _ = CheckpointManager(str(tmp_path / "jax")).restore_latest_good(
        train_state_spec(tstate))
    load_train_state(tstate, flat)
    assert step0 == 3 and float(tstate["sampler_carry"].count) == 2.0
    for f in jstate["sampler_carry"]._fields:
        np.testing.assert_array_equal(getattr(tstate["sampler_carry"], f).numpy(),
                                      np.asarray(getattr(jstate["sampler_carry"], f)), err_msg=f)


def test_streaming_resume_is_exact(tmp_path):
    whole = Trainer(ExperimentConfig().apply_overrides(STREAM), device="cpu").fit()
    ckpt = [f"train.checkpoint_dir={tmp_path}"]
    Trainer(ExperimentConfig().apply_overrides(STREAM + ckpt + ["train.stop_after=3"]),
            device="cpu").fit()
    resumed = Trainer.from_checkpoint(str(tmp_path), device="cpu").fit()
    assert [r["loss"] for r in resumed["history"]] == [r["loss"] for r in whole["history"][3:]]
    assert resumed["config_hash"] == whole["config_hash"]


# ---------------------------------------------------------------------------
# overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["graft", "streaming_graft", "random"])
def test_overlapped_trajectory_is_bit_identical_to_sequential(sampler):
    runs = {}
    for overlap in (False, True):
        cfg = ExperimentConfig().apply_overrides(
            SMALL + [f"train.sampler={sampler}", f"graft.overlap={str(overlap).lower()}"])
        mcfg, tcfg, data = cfg.build()
        state = tsteps.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), 8, "cpu")
        run_step = tsteps.make_run_step(mcfg, tcfg)
        rows = []
        for step in range(6):
            state, m = run_step(state, {k: T(v) for k, v in data.batch_at(step).items()})
            rows.append((m["loss"].item(), int(m["rank"]), state["graft"].pivots.tolist(),
                         state["graft"].weights.tolist(), float(m["proj_error"]),
                         float(m["alignment"])))
        runs[overlap] = (rows, [p.detach().clone() for p in state["params"]])
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


@pytest.mark.parametrize("override", ["graft.streaming=true", "graft.overlap=true",
                                      "train.sampler=random"])
def test_trainer_runs_what_was_refused(override):
    """The three overrides ``test_not_ported_parts_raise_pointing_to_roadmap``
    refused before this slice, run end to end with eval and metrics."""
    report = Trainer(ExperimentConfig().apply_overrides(
        SMALL + [override, "train.eval_every=2"]), device="cpu").fit()
    assert report["steps"] == 6
    for row in report["history"]:
        assert np.isfinite(row["loss"]) and row["rank"] in (2, 4)
    assert all(np.isfinite(r["eval_loss"]) for r in report["history"][1::2])
