"""The port's chaos harness (``repro_torch.resilience``) beside the JAX
package's ``repro.resilience.chaos``, and its scenario matrix on the CPU.

The fault plan parses, falls back to the environment and fires each fault
once exactly as JAX's does on the same spec (the same fired sequence); a
poisoned batch is byte-equal; a bit flip hits the same byte of the same
port-written checkpoint. The checkpoint writer's crash points sit at the
reference's commit boundaries. The stall fault delays a DeviceClock event
(a fake event here: the clock only polls ``query()``), and never fires
where the Trainer keeps no clock. The five scenarios of
``python -m repro_torch.resilience`` run here as cases of one test: the JAX
Trainer cannot run on this tree (``ROADMAP.md``, known failures), so the
matrix's bars are held within the port.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.resilience import chaos as jchaos
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.checkpoint import CheckpointManager, EmergencySaver
from repro_torch.launch.metrics import DeviceClock
from repro_torch.resilience import __main__ as matrix
from repro_torch.resilience import chaos

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


# ---------------------------------------------------------------------------
# fault plans, beside the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    '[{"kind": "sigterm", "step": 3}]',
    '{"kind": "nan_batch", "step": 1}',
    '{"faults": [{"kind": "crash", "point": "x", "skip": 2}]}',
    [{"kind": "stall", "step": 2, "seconds": 0.5}],
    "FILE", "@FILE"])
def test_fault_plan_parses_as_jax(spec, tmp_path):
    if isinstance(spec, str) and spec.endswith("FILE"):
        p = tmp_path / "plan.json"
        p.write_text('{"faults": [{"kind": "crash", "point": "x"}, {"kind": "bit_flip"}]}')
        spec = spec.replace("FILE", str(p))
    assert chaos.FaultPlan.from_spec(spec).faults == jchaos.FaultPlan.from_spec(spec).faults


def test_fault_plan_rejects_unknown_kind():
    for mod in (chaos, jchaos):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultPlan([{"kind": "meteor", "step": 1}])
    assert chaos.KINDS == jchaos.KINDS and chaos.ENV_VAR == jchaos.ENV_VAR
    assert chaos.BAD_TOKEN_ID == jchaos.BAD_TOKEN_ID


def test_fault_plan_env_fallback(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, '[{"kind": "sigterm", "step": 9}]')
    for mod in (chaos, jchaos):
        assert mod.load_plan(None).faults == [{"kind": "sigterm", "step": 9}]
        # explicit config wins over the environment
        assert mod.load_plan('[{"kind": "sigterm", "step": 1}]').faults[0]["step"] == 1
    monkeypatch.delenv(chaos.ENV_VAR)
    assert chaos.load_plan(None) is None and jchaos.load_plan(None) is None


def _fired(mod, steps):
    """(step, fired) for nan_batch over ``steps`` — a replayed range included."""
    plan = mod.FaultPlan([{"kind": "nan_batch", "step": 4}, {"kind": "nan_batch", "step": 6}])
    clean = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "x": np.ones((2, 3), np.float32)}
    return [(s, plan.corrupt_batch(s, clean) is not clean) for s in steps], plan.fired


def test_nan_batch_fires_once_as_jax():
    steps = [3, 4, 5, 6, 4, 5, 6, 7]          # a rollback replays 4..6
    got, want = _fired(chaos, steps), _fired(jchaos, steps)
    assert got == want
    assert [s for s, hit in got[0] if hit] == [4, 6]


def _crash_hits(mod):
    out = []
    plan = mod.FaultPlan([{"kind": "crash", "point": "p", "skip": 2},
                          {"kind": "crash", "point": "q"}])
    with mod.active_plan(plan):
        for point in ["p", "other", "p", "q", "p", "p", "q"]:
            try:
                mod.crash_point(point)
                out.append((point, False))
            except mod.ChaosCrash:
                out.append((point, True))
    mod.crash_point("p")                      # no active plan — inert
    return out


def test_crash_point_skip_counter_as_jax():
    got = _crash_hits(chaos)
    assert got == _crash_hits(jchaos)
    assert got == [("p", False), ("other", False), ("p", False), ("q", True),
                   ("p", True), ("p", False), ("q", False)]


def test_sigterm_fires_once_as_jax():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda *_: seen.append(len(seen)))
    try:
        counts = []
        for mod in (chaos, jchaos):
            plan = mod.FaultPlan([{"kind": "sigterm", "step": 2}])
            before = len(seen)
            for s in (0, 1, 2, 2, 3):
                plan.fire_signals(s)
            counts.append(len(seen) - before)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert counts == [1, 1]


def _checkpoint(tmp_path, name):
    """A port-written checkpoint of a bf16 and a float32 leaf."""
    import torch
    mgr = CheckpointManager(str(tmp_path / name), async_save=False)
    flat = {"params/embed": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "params/w": torch.linspace(0, 1, 8), "opt/m": torch.ones(5)}
    mgr.save(3, flat, extra={"train_step": 3})
    return str(tmp_path / name)


@pytest.mark.parametrize("leaf,bit", [("params", 0), ("params/w", 13), ("opt", 7)])
def test_flip_checkpoint_leaf_is_byte_equal_to_jax(tmp_path, leaf, bit):
    ours = _checkpoint(tmp_path, "ours")
    theirs = str(tmp_path / "theirs")
    shutil.copytree(ours, theirs)
    key = chaos.flip_checkpoint_leaf(ours, 3, leaf, bit=bit)
    assert key == jchaos.flip_checkpoint_leaf(theirs, 3, leaf, bit=bit)
    step = "step_00000003"
    for name in sorted(os.listdir(os.path.join(ours, step))):
        with open(os.path.join(ours, step, name), "rb") as a, \
                open(os.path.join(theirs, step, name), "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(IOError):
        CheckpointManager(ours).restore(3)
    with pytest.raises(KeyError):
        chaos.flip_checkpoint_leaf(ours, 3, "nothing")


# ---------------------------------------------------------------------------
# the checkpoint writer's crash points
# ---------------------------------------------------------------------------

def test_resave_crash_between_renames_keeps_committed_step(tmp_path):
    import torch
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, {"w": torch.arange(8.0)}, extra={"train_step": 5})
    plan = chaos.FaultPlan([{"kind": "crash", "point": "checkpoint.mid_commit"}])
    with chaos.active_plan(plan), pytest.raises(chaos.ChaosCrash):
        mgr.save(5, {"w": torch.arange(8.0) * 2}, extra={"train_step": 5})
    assert "step_00000005.old" in os.listdir(tmp_path)
    mgr2 = CheckpointManager(str(tmp_path))          # _recover renames it back
    assert mgr2.all_steps() == [5]
    assert torch.equal(mgr2.restore(5)["w"], torch.arange(8.0))


@pytest.mark.parametrize("point,committed", [("checkpoint.pre_commit", []),
                                             ("checkpoint.post_commit", [1])])
def test_async_writer_failure_surfaces_on_wait(tmp_path, point, committed):
    import torch
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    with chaos.active_plan(chaos.FaultPlan([{"kind": "crash", "point": point}])):
        mgr.save(1, {"w": torch.ones(2)}, extra={})
        with pytest.raises(chaos.ChaosCrash):
            mgr.wait()
    mgr.wait()                       # exception is one-shot
    assert CheckpointManager(str(tmp_path)).all_steps() == committed


def test_crash_mode_exit_kills_the_process(tmp_path):
    """``"mode": "exit"`` ends the process with code 17 at the crash point —
    only ever in a subprocess."""
    code = (
        "import torch\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch.resilience import chaos\n"
        "chaos.activate(chaos.FaultPlan([{'kind': 'crash', 'mode': 'exit',\n"
        "                                 'point': 'checkpoint.mid_commit'}]))\n"
        f"m = CheckpointManager({str(tmp_path)!r})\n"
        "m.save(1, {'w': torch.ones(2)}, extra={})\n"
        "print('survived')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 17, proc.stderr
    assert "survived" not in proc.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == []


# ---------------------------------------------------------------------------
# stall
# ---------------------------------------------------------------------------

class _FakeEvent:
    """Stands in for a recorded torch.cuda.Event on the CPU: complete at
    once, 1 ms after any other."""

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_stall_marker_reads_incomplete_then_clears():
    clock = DeviceClock(stall_timeout_s=0.2)
    clock.observe(0, _FakeEvent())
    stalled = chaos.FaultPlan([{"kind": "stall", "step": 1, "seconds": 1.0}]).wrap_marker(
        1, _FakeEvent())
    assert isinstance(stalled, chaos.StallMarker) and not stalled.query()
    clock.observe(1, stalled)
    t0 = time.time()
    clock.drain(timeout=8.0)
    assert time.time() - t0 < 0.9, "drain blocked despite the watchdog"
    assert clock.stalled and clock.device_time(1, timeout=5.0) is None
    time.sleep(1.0)
    assert clock.device_time(1) == 1e-3 and not clock.stalled   # completion clears it
    t0 = time.time()
    chaos.StallMarker(_FakeEvent(), 0.3).synchronize()
    assert time.time() - t0 >= 0.25
    clock.close()


def test_stall_fault_never_fires_without_a_device_clock(monkeypatch):
    """On the CPU the Trainer keeps no DeviceClock: as in the JAX package,
    the stall fault stays unfired and the run reports no stall."""
    calls = []
    monkeypatch.setattr(chaos.FaultPlan, "wrap_marker",
                        lambda self, step, marker: calls.append(step) or marker)
    plan = json.dumps([{"kind": "stall", "step": 2, "seconds": 3.0}])
    report = Trainer(ExperimentConfig().apply_overrides([
        "train.steps=4", "train.batch=4", "train.seq=16", "train.log_every=0",
        "train.device_timeout_s=0.3", "graft=none", "train.sampler=random",
        f"train.fault_plan={plan}"]), device="cpu").fit()
    assert calls == [] and "device_stalled" not in report["host_loop"]


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", matrix.SCENARIOS, ids=matrix.scenario_name)
def test_matrix_scenario_passes_on_cpu(scenario, tmp_path, monkeypatch):
    if scenario is matrix.scenario_sigterm:
        # the saver's handler must be in place before the signal, or the
        # signal would end the test process
        orig = chaos.FaultPlan.fire_signals

        def checked(self, step):
            if any(f["kind"] == "sigterm" and f["step"] == step for f in self.faults):
                handler = signal.getsignal(signal.SIGTERM)
                assert isinstance(getattr(handler, "__self__", None), EmergencySaver)
            orig(self, step)

        monkeypatch.setattr(chaos.FaultPlan, "fire_signals", checked)
    before = signal.getsignal(signal.SIGTERM)
    result = scenario(str(tmp_path), device="cpu")
    assert np.isfinite(result["final_loss"])
    assert signal.getsignal(signal.SIGTERM) is before
    assert chaos._active is None                     # deactivated by fit()
    if "rolled_back_to" in result:
        assert result["rolled_back_to"] == 15


def test_matrix_main_runs_one_scenario_and_writes_json(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert matrix.main(["--device=cpu", "--only", "corrupt_leaf", "--json", str(out)]) == 0
    results = json.loads(out.read_text())
    assert list(results) == ["corrupt_leaf"] and results["corrupt_leaf"]["ok"]
    assert "[chaos] matrix: PASS" in capsys.readouterr().out


def test_matrix_main_fails_with_exit_code_1(monkeypatch, tmp_path):
    def broken(td, device=None):
        raise AssertionError("bar missed")
    broken.__name__ = "scenario_broken"
    monkeypatch.setattr(matrix, "SCENARIOS", [broken])
    out = tmp_path / "r.json"
    assert matrix.main(["--device=cpu", "--json", str(out)]) == 1
    assert json.loads(out.read_text())["broken"] == {
        "ok": False, "error": "AssertionError: bar missed"}


def test_matrix_refuses_to_run_without_a_gpu_unless_asked():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        matrix.main(["--only", "sigterm"])


# ---------------------------------------------------------------------------
# signal-handler hygiene
# ---------------------------------------------------------------------------

def test_two_trainers_one_process_no_stale_handlers(tmp_path):
    before_term = signal.getsignal(signal.SIGTERM)
    before_int = signal.getsignal(signal.SIGINT)
    plan = json.dumps([{"kind": "sigterm", "step": 2}])
    common = ["train.steps=4", "train.batch=4", "train.seq=16",
              "train.log_every=0", "graft=none", "train.sampler=random"]
    rep1 = Trainer(ExperimentConfig().apply_overrides(
        common + [f"train.fault_plan={plan}", f"train.checkpoint_dir={tmp_path / 'ck'}"]),
        device="cpu").fit()
    assert rep1.get("stopped") == "preempted"
    # handlers unwound → process defaults back in place
    assert signal.getsignal(signal.SIGTERM) is before_term
    assert signal.getsignal(signal.SIGINT) is before_int
    # a second fit in the same process must not inherit the stop flag
    rep2 = Trainer(ExperimentConfig().apply_overrides(common), device="cpu").fit()
    assert "stopped" not in rep2
    assert rep2["host_loop"]["steps"] == 4
    assert signal.getsignal(signal.SIGTERM) is before_term


def test_abort_releases_handlers_and_flushes_metrics(tmp_path):
    """A chaos crash aborts fit() before on_train_end — the abort hooks
    still unwind signal handlers and flush the JSONL tail."""
    before = signal.getsignal(signal.SIGTERM)
    plan = json.dumps([{"kind": "crash", "point": "checkpoint.pre_commit"}])
    cfg = ExperimentConfig().apply_overrides([
        "train.steps=6", "train.batch=4", "train.seq=16",
        "train.log_every=0", "graft=none", "train.sampler=random",
        f"train.checkpoint_dir={tmp_path / 'ck'}",
        "train.checkpoint_every=2", "train.metrics_flush_every=100",
        f"train.metrics_path={tmp_path / 'm.jsonl'}",
        f"train.fault_plan={plan}"])
    with pytest.raises(chaos.ChaosCrash):
        Trainer(cfg, device="cpu").fit()
    assert signal.getsignal(signal.SIGTERM) is before
    assert chaos._active is None
    with open(tmp_path / "m.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows, "buffered metrics were lost on abort"
