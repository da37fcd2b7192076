"""The port's Trainer shell on the CPU: checkpoints that cross between the
packages, stop and resume, eval, JSONL metrics, callbacks and the
divergence rollback.

* A checkpoint the JAX ``CheckpointManager`` writes of a state stepped by
  ``jax.jit(repro.launch.steps.make_train_step)`` (no mesh) restores in the
  port, and the next steps' losses match JAX's at the tolerance of
  ``test_eight_steps_match_jax_step_functions`` (rtol 1e-4), ranks and
  pivots exactly.
* A checkpoint the port writes restores through the JAX
  ``CheckpointManager.restore`` with its checksums verified: every leaf
  equal, and the manifest's paths, shapes and dtypes those of the JAX
  package's own checkpoint of the same experiment.
* A run stopped at step 3 and resumed to 6 (API and ``--resume``) is bit
  for bit the uninterrupted run, with the same config hash.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Trainer as JTrainer
from repro.api.config import ExperimentConfig as JExperimentConfig
from repro.backend import resolve as jresolve_backend
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.distributed.straggler import StragglerMonitor as JStragglerMonitor
from repro.launch import evaluate as jevaluate
from repro.launch import steps as jsteps
from repro.launch.metrics import MetricsLogger as JMetricsLogger
from repro.launch.metrics import read_metrics as jread_metrics
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.api import callbacks as cb_lib
from repro_torch.api import cli as tcli
from repro_torch.checkpoint import (CheckpointManager, load_train_state, params_from_numpy,
                                    train_state_spec, train_state_to_host)
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.launch import evaluate as tevaluate
from repro_torch.launch import steps as tsteps
from repro_torch.launch.metrics import MetricsLogger, read_metrics
from repro_torch.models.model import Model
from repro_torch.optim import OptimizerConfig as TOptCfg

OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
           warmup_steps=1)
SMALL = ["train.steps=6", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0"]
_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                      torch.int32: "int32"}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _bits(a) -> np.ndarray:
    """A leaf as comparable numpy: bf16 by its bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True)
    jm = jsmoke("minicpm-2b", param_dtype="float32")
    tm = tsmoke("minicpm-2b", param_dtype="float32")
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), graft=JGraftConfig(**gc),
                            probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), graft=tsteps.GraftConfig(**gc),
                            probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    jfn = jax.jit(jsteps.make_train_step(jm, jt))
    for step in range(3):
        jstate, _ = jfn(jstate, {k: jnp.asarray(v) for k, v in data.batch_at(step).items()})
    JCheckpointManager(str(tmp_path)).save(3, jstate)
    want = []
    for step in range(3, 6):
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in data.batch_at(step).items()})
        want.append((float(jmet["loss"]), int(jmet["rank"]), np.asarray(jstate["graft"].pivots)))

    tstate = tsteps.state_for_model(tm, tt, Model(tm), 8)
    step0, flat, _ = CheckpointManager(str(tmp_path)).restore_latest_good(
        train_state_spec(tstate))
    load_train_state(tstate, flat)
    assert step0 == 3 and tstate["step"] == 3 and tstate["health"]["count"] == 3
    tfn = tsteps.make_train_step(tm, tt)
    for step, (loss, rank, pivots) in zip(range(3, 6), want):
        tstate, tmet = tfn(tstate, _tb(data.batch_at(step)))
        np.testing.assert_allclose(float(tmet["loss"]), loss, rtol=1e-4)
        assert int(tmet["rank"]) == rank
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(), pivots)


@pytest.mark.parametrize("name", ["adamw", "sgd", "lion", "adafactor"])
def test_port_state_has_the_jax_train_state_leaves(name):
    """Paths, shapes and dtypes of the port's checkpoint leaves are those of
    ``repro.launch.steps.init_train_state`` flattened by the JAX
    checkpointer, for every optimizer's state."""
    overrides = SMALL + [f"optimizer.name={name}"]
    mcfg, tcfg, _ = ExperimentConfig().apply_overrides(overrides).build()
    tstate = tsteps.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), 8)
    jm, jt, _ = JExperimentConfig().apply_overrides(overrides).build()
    jflat = _flatten_with_paths(jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8))
    got = {k: (tuple(s), _TORCH_DTYPE_NAMES[d]) for k, (s, d) in
           train_state_spec(tstate).items()}
    assert got == {k: (tuple(a.shape), a.dtype.name) for k, a in jflat.items()}
    host = train_state_to_host(tstate)
    assert {k: (tuple(t.shape), t.dtype) for k, t in host.items()} == \
        {k: (s, d) for k, (s, d) in train_state_spec(tstate).items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    overrides = SMALL + ["train.steps=2", f"optimizer.name={name}",
                         f"train.checkpoint_dir={tmp_path / 'port'}"]
    trainer = Trainer(ExperimentConfig().apply_overrides(overrides), device="cpu")
    trainer.fit()
    jm, jt, _ = JExperimentConfig().apply_overrides(overrides).build()
    target = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(1), 8)
    jmgr = JCheckpointManager(str(tmp_path / "port"))
    assert jmgr.all_steps() == [2]
    tree = jmgr.restore(2, target, verify=True, backend=jresolve_backend(None))
    jflat = _flatten_with_paths(tree)
    port = train_state_to_host(trainer.state)
    assert set(jflat) == set(port)
    for k in port:
        np.testing.assert_array_equal(_bits(jflat[k]), _bits(port[k]), err_msg=k)
    JCheckpointManager(str(tmp_path / "jax")).save(2, target)
    leaves = {d: {k: (m["shape"], m["dtype"]) for k, m in
                  JCheckpointManager(str(tmp_path / d)).manifest(2)["leaves"].items()}
              for d in ("port", "jax")}
    assert leaves["port"] == leaves["jax"]


def _report_rows(report):
    return [{k: v for k, v in r.items() if k != "step_time_s"} for r in report["history"]]


def test_stop_and_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, capsys):
    extra = ["train.eval_every=2", "train.checkpoint_every=3"]
    full = Trainer(ExperimentConfig().apply_overrides(SMALL + extra), device="cpu")
    rep_full = full.fit()
    ck = str(tmp_path / "ck")
    rep_first = Trainer(ExperimentConfig().apply_overrides(
        SMALL + extra + ["train.stop_after=3", f"train.checkpoint_dir={ck}"]),
        device="cpu").fit()
    assert rep_first["stopped"] == "stop_after" and len(rep_first["history"]) == 3
    resumed = Trainer.from_checkpoint(ck, device="cpu")
    rep_resumed = resumed.fit()
    assert resumed.start_step == 3 and len(rep_resumed["history"]) == 3
    assert _report_rows(rep_first) + _report_rows(rep_resumed) == _report_rows(rep_full)
    assert "eval_loss" in rep_full["history"][3]
    assert all(torch.equal(a, b) for a, b in zip(full.state["params"],
                                                 resumed.state["params"]))
    assert rep_full["config_hash"] == rep_first["config_hash"] == rep_resumed["config_hash"]
    # the same through the CLI
    capsys.readouterr()
    ck2 = str(tmp_path / "cli")
    args = ["--device=cpu"] + [f"--{o}" for o in SMALL + extra]
    assert tcli.main(args + ["--train.stop_after=3", f"--train.checkpoint_dir={ck2}"]) == 0
    capsys.readouterr()
    assert tcli.main(["--device=cpu", "--resume", ck2]) == 0
    out = capsys.readouterr().out.splitlines()
    report = json.loads("\n".join(out[out.index("{"):]))
    assert report["final_loss"] == rep_full["final_loss"]
    assert report["config_hash"] == rep_full["config_hash"]
    assert tcli.main(["--resume", ck2, "--train.steps=9"]) == 2


def test_callbacks_run_in_the_jax_order(tmp_path):
    """The stock set, sorted by priority, is the JAX package's for the same
    config; a stop is checkpointed before the loop ends."""
    overrides = SMALL + ["train.eval_every=2", "train.log_every=2",
                         f"train.checkpoint_dir={tmp_path / 'order'}"]
    port = Trainer(ExperimentConfig().apply_overrides(overrides), device="cpu")
    jax_tr = JTrainer(JExperimentConfig().apply_overrides(overrides))
    assert [(type(c).__name__, c.priority) for c in port.callbacks] == \
        [(type(c).__name__, c.priority) for c in jax_tr.callbacks]
    rec = cb_lib.HookRecorder()
    cfg = ExperimentConfig().apply_overrides(
        SMALL + ["train.stop_after=4", f"train.checkpoint_dir={tmp_path / 'ck'}",
                 "train.checkpoint_every=100"])
    report = Trainer(cfg, callbacks=[rec], device="cpu").fit()
    # the checkpointer (90) commits and announces before the recorder (95)
    # sees the step's end
    assert rec.events == [("on_train_start", None)] + [("on_step_end", s) for s in range(3)] \
        + [("on_checkpoint", 3), ("on_step_end", 3), ("on_train_end", None)]
    assert report["stopped"] == "stop_after" and len(report["history"]) == 4


def test_metrics_logger_rows_match_jax(tmp_path):
    rows = [{"loss": 2.5, "grad_norm": 1.25, "rank": 4.0, "healthy": 1.0, "lr": 1e-3},
            {"loss": float("nan"), "grad_norm": 3.0, "rank": 2.0, "healthy": 0.0,
             "lr": 2e-3, "eval_loss": 2.0, "eval_ppl": 7.5}]
    paths = {"port": str(tmp_path / "port.jsonl"), "jax": str(tmp_path / "jax.jsonl")}
    for key, cls in (("port", MetricsLogger), ("jax", JMetricsLogger)):
        log = cls(paths[key], flops_per_step=1e12, flush_every=2)
        for step, row in enumerate(rows):
            log.log(step, dict(row), tokens=128, step_time=0.5)
        log.close()
    got, want = read_metrics(paths["port"]), jread_metrics(paths["jax"])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("time", "mfu")} == \
            {k: v for k, v in w.items() if k not in ("time", "mfu")}
        # the port's peak is the H100's 989e12, JAX's the TPU's 197e12
        np.testing.assert_allclose(g["mfu"] * 989e12, w["mfu"] * 197e12, rtol=1e-12)
    assert got[1]["nonfinite_keys"] == ["loss"] and got[1]["loss"] is None


def test_trainer_jsonl_stream_has_the_jax_row_keys(tmp_path):
    path = str(tmp_path / "m.jsonl")
    Trainer(ExperimentConfig().apply_overrides(
        SMALL + [f"train.metrics_path={path}", "train.eval_every=2",
                 "train.metrics_flush_every=4"]), device="cpu").fit()
    rows = read_metrics(path)
    assert [r["step"] for r in rows] == list(range(6))
    base = {"step", "time", "tokens_seen", "step_time_s", "tokens_per_s", "mfu",
            "mfu_source", "loss", "grad_norm", "lr", "rank", "proj_error", "alignment",
            "healthy", "bad_streak"}
    assert all(base <= set(r) for r in rows)
    assert [("eval_loss" in r) for r in rows] == [s % 2 == 1 for s in range(6)]
    assert rows[-1]["tokens_seen"] == 6 * 8 * 16


def test_history_cap_keeps_the_first_row_and_a_tail():
    cfg = ExperimentConfig().apply_overrides(SMALL + ["train.history_cap=2"])
    capped = Trainer(cfg, device="cpu").fit()
    full = Trainer(ExperimentConfig().apply_overrides(SMALL), device="cpu").fit()
    assert capped["history_dropped"] == 3 and capped["host_loop"]["steps"] == 6
    assert _report_rows(capped) == [_report_rows(full)[i] for i in (0, 4, 5)]
    assert capped["final_loss"] == full["final_loss"]


def test_eval_matches_jax():
    overrides = SMALL + ['model.overrides={"param_dtype": "float32"}']
    jcfg = JExperimentConfig().apply_overrides(overrides)
    tcfg = ExperimentConfig().apply_overrides(overrides)
    jm, jt, _ = jcfg.build()
    tm, _, _ = tcfg.build()
    jparams = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)["params"]
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), Model(tm))
    want = jevaluate.make_eval_fn_for(jcfg, jm)(jparams)
    got = tevaluate.make_eval_fn_for(tcfg, tm, device="cpu")(model)
    assert set(got) == set(want) == {"eval_loss", "eval_ppl"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_straggler_monitor_matches_jax():
    times = [0.1, 0.11, 0.1, 0.12, 0.1, 0.5, 0.1, 0.3, 0.11, 0.1]
    port, ref = StragglerMonitor(), JStragglerMonitor()
    assert [port.record(t) for t in times] == [ref.record(t) for t in times]
    assert port.summary() == ref.summary() and port.flagged == [5, 7]
    assert port.suggested_rank(8, True) == ref.suggested_rank(8, True) == 4


def _flat(v):
    return {"params/w": torch.full((3, 4), float(v)),
            "params/b": torch.arange(5, dtype=torch.float32).to(torch.bfloat16),
            "step": torch.tensor(v, dtype=torch.int32)}


def test_corrupt_checkpoint_is_quarantined(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=3)
    for s in (1, 2):
        mgr.save(s, _flat(s), extra={"health": {"healthy": True, "bad_streak": 0}})
    path = tmp_path / "step_00000002" / "params_w.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF                                      # flip the last data byte
    path.write_bytes(bytes(raw))
    step, flat, _ = mgr.restore_latest_good()
    assert step == 1 and int(flat["step"]) == 1 and flat["params/b"].dtype == torch.bfloat16
    assert torch.equal(flat["params/b"], _flat(1)["params/b"])
    assert os.path.isdir(tmp_path / "corrupt.00000002") and mgr.all_steps() == [1]


def test_gc_keeps_the_newest_healthy_step_and_recover_rolls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
    mgr.save(1, _flat(1), extra={"health": {"healthy": True, "bad_streak": 0}})
    mgr.save(2, _flat(2), extra={"health": {"healthy": False, "bad_streak": 3}})
    assert mgr.all_steps() == [1, 2]
    step, _, _ = mgr.restore_latest_good()
    assert step == 1                                   # step 2 stamped unhealthy
    # a crash between the two commit renames leaves step_X.old alone
    os.rename(tmp_path / "step_00000001", tmp_path / "step_00000001.old")
    os.makedirs(tmp_path / "tmp.9.1")
    mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
    assert mgr.all_steps() == [1, 2] and not os.path.exists(tmp_path / "tmp.9.1")


def test_rollback_restores_the_last_healthy_checkpoint(tmp_path):
    """A rollback requested at step 4 restores the step-4 checkpoint and
    replays: the final state is the uninterrupted run's."""
    class Tripper(cb_lib.Callback):
        priority = 46
        fired = False

        def on_step_end(self, trainer, step, metrics):
            if step == 4 and not self.fired:
                self.fired = True
                trainer.request_rollback("test trip")

    base = SMALL + ["train.checkpoint_every=2"]
    full = Trainer(ExperimentConfig().apply_overrides(base), device="cpu")
    full.fit()
    tr = Trainer(ExperimentConfig().apply_overrides(
        base + [f"train.checkpoint_dir={tmp_path}"]), callbacks=[Tripper()], device="cpu")
    report = tr.fit()
    assert report["resilience"]["rollbacks"] == [
        {"at_step": 4, "to_step": 4, "reason": "test trip"}]
    assert report["host_loop"]["steps"] == 7
    assert all(torch.equal(a, b) for a, b in zip(full.state["params"], tr.state["params"]))
    lone = Trainer(ExperimentConfig().apply_overrides(base), callbacks=[Tripper()],
                   device="cpu").fit()
    assert lone["stopped"] == "diverged" and len(lone["history"]) == 5
