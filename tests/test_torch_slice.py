"""The port's training slice against the JAX package's step functions, and
its entry points, on the CPU.

An 8-step GRAFT run of ``repro_torch.launch.steps`` is held against
``jax.jit(repro.launch.steps.make_train_step)`` (no mesh) on the smoke
minicpm with float32 params, the JAX init carried across by the bridge and
the same ``SyntheticLM`` batches: per-step loss rtol 1e-4 (the forward and
backward sums reassociate and AdamW compounds it over 8 updates), ranks and
pivots EXACTLY equal. The same holds under ``attn_backend="flash"`` for the
minicpm, stablelm (GQA 2) and gemma2 (window 16 on alternate layers at
seq 32, softcaps, post-norms, GQA 2) smoke configs: the JAX side runs its
Pallas flash kernels in interpret mode, the port its plain flash versions.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import ExperimentConfig as JExperimentConfig
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.api import cli as tcli
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import steps as tsteps
from repro_torch.models.model import Model
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.selection.base import GraftConfig as TGraftConfig

OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
           warmup_steps=1)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_eight_steps_match_jax_step_functions(use_pallas):
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=use_pallas)
    jm = jsmoke("minicpm-2b", param_dtype="float32")
    tm = tsmoke("minicpm-2b", param_dtype="float32")
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), graft=JGraftConfig(**gc),
                            probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), graft=TGraftConfig(**gc),
                            probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]), Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(8):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, _tb(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))
        np.testing.assert_array_equal(tstate["graft"].weights.numpy(),
                                      np.asarray(jstate["graft"].weights))
        assert tmet["healthy"] == float(jmet["healthy"]) == 1.0
        assert tstate["step"] == int(jstate["step"]) == step + 1


@pytest.mark.parametrize("arch,seq", [("minicpm-2b", 16), ("stablelm-12b", 16),
                                      ("gemma2-27b", 32)])
def test_eight_flash_steps_match_jax_step_functions(arch, seq):
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True)
    ov = dict(param_dtype="float32", attn_backend="flash")
    jm, tm = jsmoke(arch, **ov), tsmoke(arch, **ov)
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), graft=JGraftConfig(**gc),
                            probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), graft=TGraftConfig(**gc),
                            probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=seq, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]), Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(8):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, _tb(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))


SMALL = ["train.steps=5", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0"]


def test_trainer_matches_the_step_loop():
    cfg = ExperimentConfig().apply_overrides(SMALL)
    report = Trainer(cfg, device="cpu").fit()
    mcfg, tcfg, data = cfg.build()
    state = tsteps.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), 8)
    step_fn = tsteps.make_train_step(mcfg, tcfg)
    losses = []
    for s in range(5):
        state, m = step_fn(state, _tb(data.batch_at(s)))
        losses.append(float(m["loss"]))
    assert [r["loss"] for r in report["history"]] == losses
    assert report["steps"] == 5 and report["final_loss"] == losses[-1]
    assert report["config_hash"] == JExperimentConfig().apply_overrides(SMALL).config_hash()
    for row in report["history"]:
        assert {"loss", "rank", "proj_error", "alignment", "grad_norm", "lr",
                "step_time_s"} <= row.keys()
        assert row["rank"] in (2, 4)


@pytest.mark.parametrize("overrides", [
    [],
    SMALL,
    ["model.smoke=false", 'model.overrides={"attn_backend": "dense"}',
     "graft.rset=[2,4,8]", "train.batch=16", "train.seq=256", "train.steps=6",
     "optimizer.learning_rate=1e-4"],
    ["graft=none", "optimizer.schedule=wsd", "train.seed=3", "train.log_every=5"],
    ["model.arch=qwen1.5-32b"], ["model.arch=qwen3-moe-235b-a22b"],
    ["model.arch=kimi-k2-1t-a32b", "optimizer.name=adafactor"], ["model.arch=hymba-1.5b"],
    ["graft=none", "train.microbatches=4"], ['model.overrides={"remat": "dots"}'],
    ["model.arch=qwen3-moe-235b-a22b", "model.smoke=false",
     'model.overrides={"num_layers": 2}', "optimizer.state_dtype=bfloat16"],
])
def test_config_hash_and_json_match_jax(overrides):
    t = ExperimentConfig().apply_overrides(overrides)
    j = JExperimentConfig().apply_overrides(overrides)
    assert t.config_hash() == j.config_hash()
    assert t.finalized().to_json() == j.finalized().to_json()
    assert ExperimentConfig.from_json(t.to_json()) == t


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(ExperimentConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--train.steps=1"])
    assert tcli.main(["--dump-config", "--train.steps=3"]) == 0
    assert json.loads(capsys.readouterr().out)["train"]["steps"] == 3
    assert tcli.main(["--device=cpu", "--train.steps=2", "--train.batch=8",
                      "--train.seq=8", "--train.log_every=0"]) == 0


@pytest.mark.parametrize("override", [
    "train.audit=true", "model.arch=musicgen-medium",
    "data.source=synthetic_classification", "train.fault_plan=x", "backend.kind=multiprocess",
    "data.source=synthetic_vision", "model.arch=internvl2-26b",
    'model.overrides={"frontend": "audio_frames"}',
    'model.overrides={"frontend": "vision_patches"}'])
def test_not_ported_parts_raise_pointing_to_roadmap(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg = ExperimentConfig().apply_overrides(SMALL + [override])
        Trainer(cfg, device="cpu").fit()


def test_sentinel_skips_an_unhealthy_update_and_is_neutral_when_healthy():
    cfg = ExperimentConfig().apply_overrides(SMALL)
    mcfg, tcfg, data = cfg.build()
    b = _tb(data.batch_at(0))
    runs = {}
    for sentinel in (True, False):
        tc = tsteps.TrainConfig(**{**tcfg.__dict__, "sentinel": sentinel})
        st = tsteps.init_train_state(mcfg, tc, torch.Generator().manual_seed(0), 8)
        st, _ = tsteps.make_train_step(mcfg, tc)(st, b)
        runs[sentinel] = [p.detach().clone() for p in st["params"]]
    assert all(torch.equal(a, c) for a, c in zip(runs[True], runs[False]))

    st = tsteps.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), 8)
    with torch.no_grad():
        st["model"].blocks[0].mlp["w_up"][0, 0] = float("nan")
    before = [p.detach().clone() for p in st["params"]]
    graft_before = st["graft"]
    st, m = tsteps.make_train_step(mcfg, tcfg)(st, b)
    assert m["healthy"] == 0.0 and m["bad_streak"] == 1 and st["step"] == 1
    assert all(torch.equal(p, q) or (torch.isnan(p).any() and
                                     torch.equal(torch.nan_to_num(p), torch.nan_to_num(q)))
               for p, q in zip(st["params"], before))
    assert all(float(t.abs().sum()) == 0.0 for t in st["opt"]["m"])
    assert torch.equal(st["graft"].pivots, graft_before.pivots)
    assert int(st["graft"].step) == 1 and st["health"]["count"] == 0


def test_port_imports_no_jax_and_nothing_of_repro():
    code = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
print(len(mods), bad)
assert not bad, bad
assert "repro_torch.kernels.graft_select" in sys.modules
assert "triton" not in sys.modules
"""
    import os
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[0]) >= 25
