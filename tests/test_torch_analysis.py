"""The port's ``train.audit`` machinery (``repro_torch.analysis``) beside the
JAX package's ``repro.analysis``: the report format and its JSON (the rule
table with the JAX ids and severities), the sync
guard (strict raise, SY001 report, sanctioned sites, thread-local scope,
patches restored exactly), the signature watcher (the same key paths and
specs for the same numpy batch), and ``train.audit`` through the Trainer —
a per-step sync raises ``SyncGuardError``, a clean run reports no
unsanctioned sync and no drift, and the drain points report under the
reference's site names (plus the port's own ``sentinel``; ``step_sync``
syncs only on the card). Then the battery runner (``python -m
repro_torch.analysis``) beside ``repro.analysis.runner``: the probe config,
SP001, and the CLI on the CPU, clean and with a planted per-step sync.
"""
import json
import threading
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import recompile as jrecompile
from repro.analysis import report as jreport
from repro.data.pipeline import DataConfig, SyntheticLM
from repro_torch.analysis import recompile as trecompile
from repro_torch.analysis import report as treport
from repro_torch.analysis.recompile import RecompileWatcher
from repro_torch.analysis.report import Finding, Report
from repro_torch.analysis.sync_guard import SyncGuard, SyncGuardError, sync_allowed
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.api.callbacks import Callback

# the drain points' site names: the JAX package's six, and the port's own
# two per-step syncs (ROADMAP.md C)
REFERENCE_SITES = {"metrics_flush", "console", "checkpoint", "rollback",
                   "divergence_guard", "eval_collect"}
PORT_SITES = {"sentinel", "step_sync"}


# ---------------------------------------------------------------------------
# report format
# ---------------------------------------------------------------------------

def _findings(mod):
    return [mod.Finding(rule="JX001", location="a", message="bad", fix_hint="fix it"),
            mod.Finding(rule="VM003", location="b", message="note"),
            mod.Finding(rule="SY001", location="c.py:3 in f", message="m", severity="info")]


def test_report_json_and_format_equal_jax():
    t, j = treport.Report(_findings(treport)), jreport.Report(_findings(jreport))
    assert t.to_json() == j.to_json()
    assert json.loads(t.to_json())["ok"] is False
    assert t.format() == j.format() and t.format(show_info=False) == j.format(show_info=False)
    # the same rule ids and severities; the descriptions name the port's checks
    assert {k: v[0] for k, v in treport.RULES.items()} == \
        {k: v[0] for k, v in jreport.RULES.items()}
    table = treport.rule_table().splitlines()
    assert table[:2] == jreport.rule_table().splitlines()[:2]
    assert [row.split(" | ")[:2] for row in table[2:]] == \
        [row.split(" | ")[:2] for row in jreport.rule_table().splitlines()[2:]]


def test_finding_defaults_severity_from_registry():
    assert Finding(rule="VM003", location="x", message="m").severity == "info"
    assert Finding(rule="SY001", location="x", message="m").severity == "error"
    with pytest.raises(ValueError):
        Finding(rule="SY001", location="x", message="m", severity="loud")
    r = Report([Finding(rule="RC001", location="a", message="m")])
    assert not r.ok and [f.rule for f in r.by_rule("RC001")] == ["RC001"]


# ---------------------------------------------------------------------------
# sync_guard
# ---------------------------------------------------------------------------

def test_sync_guard_strict_raises_on_float():
    x = torch.ones(())
    with pytest.raises(SyncGuardError, match="unsanctioned"), SyncGuard(strict=True):
        float(x)


def test_sync_guard_records_and_reports_sy001():
    x = torch.ones(())
    with SyncGuard() as g:
        float(x)                             # violation
        with sync_allowed("probe"):
            x.tolist()                       # sanctioned
    kinds = [(e.kind, e.site) for e in g.events]
    assert ("__float__", None) in kinds and ("tolist", "probe") in kinds
    report = g.report()
    assert [f.rule for f in report.errors] == ["SY001"]
    assert "test_torch_analysis.py" in report.errors[0].location
    assert any(f.severity == "info" and "probe=1" in f.message for f in report.findings)


def test_sync_guard_sanctioned_sites_pass_strict():
    x = torch.ones(2)
    with SyncGuard(strict=True) as g, sync_allowed("flush"):
        x.cpu()
        float(x[0])
    assert g.violations == [] and len(g.events) == 2


@pytest.mark.parametrize("kind,call", [
    ("item", lambda x: x.item()), ("tolist", lambda x: x.tolist()),
    ("numpy", lambda x: x.numpy()), ("cpu", lambda x: x.cpu()),
    ("__float__", float), ("__int__", int), ("__bool__", bool),
    ("__array__", np.asarray)])
def test_sync_guard_records_each_entry_point_once(kind, call):
    x = torch.ones(())
    with SyncGuard() as g:
        call(x)
    assert [e.kind for e in g.events] == [kind]      # nested syncs not recounted
    assert g.events[0].where.startswith("test_torch_analysis.py:")


def test_sync_guard_is_thread_local():
    x = torch.ones(())
    errors = []

    def other_thread():
        try:
            float(x)                         # unguarded thread: free
        except Exception as e:               # pragma: no cover
            errors.append(e)

    with SyncGuard(strict=True) as g:
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    assert errors == [] and g.events == []


def test_sync_guard_restores_patches():
    """What ``torch.Tensor.__dict__`` held is put back; what was inherited
    from ``torch._C.TensorBase`` is deleted again, nested guards included."""
    x = torch.ones(()) * 3
    before = dict(vars(torch.Tensor))
    sync, event_sync = torch.cuda.synchronize, vars(torch.cuda.Event)["synchronize"]
    with SyncGuard():
        assert "__float__" in vars(torch.Tensor)
        _nested_guard_in_thread()
        assert torch.cuda.synchronize is not sync
    assert dict(vars(torch.Tensor)) == before
    for name in ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__"):
        assert name not in vars(torch.Tensor)
    assert torch.cuda.synchronize is sync
    assert vars(torch.cuda.Event)["synchronize"] is event_sync
    assert float(x) == 3.0 and x.item() == 3.0 and bool(x)


def _nested_guard_in_thread():
    """A second guard in another thread while the first is active: the
    patches are refcounted, so its exit leaves them installed."""
    done = []

    def run():
        with SyncGuard() as g:
            float(torch.ones(()))
        done.append(len(g.events))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert done == [1] and "__float__" in vars(torch.Tensor)


# ---------------------------------------------------------------------------
# recompile
# ---------------------------------------------------------------------------

def test_recompile_watcher_names_drifting_arg():
    w = RecompileWatcher(label="step")
    assert w.observe(step=0, batch={"x": torch.ones((8, 16))}) == []
    assert w.observe(step=1, batch={"x": torch.ones((8, 16))}) == []
    drift = w.observe(step=2, batch={"x": torch.ones((8, 32))})
    assert [f.rule for f in drift] == ["RC001"]
    assert "batch['x']" in drift[0].message
    assert "float32[8,16]" in drift[0].message and "float32[8,32]" in drift[0].message
    assert not w.ok and w.report().by_rule("RC001")


def test_recompile_watcher_dtype_and_static_drift():
    w = RecompileWatcher()
    w.observe(x=torch.ones(3, dtype=torch.float32), n=4)
    drift = w.observe(x=torch.ones(3, dtype=torch.bfloat16), n=5)
    msgs = " ".join(f.message for f in drift)
    assert "bfloat16" in msgs and "'n'" in msgs


class _Sel(NamedTuple):
    pivots: np.ndarray
    rank: int


def test_signature_of_equals_jax_key_for_key():
    batch = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=8)).batch_at(0)
    tree = {"batch": batch, "sel": _Sel(np.zeros(4, np.int32), 2), "none": None,
            "seq": [np.ones((2, 3), np.float32), (np.float32(1.5), 7)], "empty": {}}
    want = jrecompile.signature_of(**tree)
    assert trecompile.signature_of(**tree) == want
    # device arrays of the same batch: torch tensors here, jax arrays there
    tb = trecompile.signature_of(batch={k: torch.from_numpy(v) for k, v in batch.items()})
    jb = jrecompile.signature_of(batch={k: jnp.asarray(v) for k, v in batch.items()})
    assert tb == jb == {"batch['labels']": "int32[8,16]", "batch['tokens']": "int32[8,16]"}


# ---------------------------------------------------------------------------
# train.audit through the Trainer
# ---------------------------------------------------------------------------

def _audited(*extra):
    pairs = ["train.steps=4", "train.batch=4", "train.seq=16", "train.log_every=0",
             "train.audit=true", "graft.rset=[2,4]", "graft.refresh_every=2"]
    return ExperimentConfig().apply_overrides(pairs + list(extra))


def _sites(report):
    return {key.split(":")[0] for key in report["audit"]["sync_sites"]}


def test_audit_knob_does_not_change_config_hash():
    base = ExperimentConfig()
    assert base.config_hash() == base.apply_overrides(["train.audit=true"]).config_hash()


def test_trainer_audit_catches_per_step_sync():
    class PerStepSync(Callback):
        def on_step_end(self, trainer, step, metrics):
            float(metrics["loss"])           # a read inside the step loop

    with pytest.raises(SyncGuardError, match="unsanctioned"):
        Trainer(_audited(), callbacks=[PerStepSync()], device="cpu").fit()


def test_trainer_audit_clean_run_reports_the_drain_sites(tmp_path):
    """Every drain point of a run under audit: the JSONL flush, console
    lines, eval collection, checkpoint saves and the sentinel's read in a
    clean run; the guard's aged-row read and the rollback in a run with a
    poisoned batch. None unsanctioned, no drift, and between them exactly
    the sanctioned site names that sync on the CPU."""
    clean = Trainer(_audited(
        f"train.metrics_path={tmp_path / 'm.jsonl'}", "train.metrics_flush_every=2",
        "train.log_every=2", "train.eval_every=2",
        f"train.checkpoint_dir={tmp_path / 'ck'}", "train.checkpoint_every=2"),
        device="cpu").fit()
    plan = json.dumps([{"kind": "nan_batch", "step": 5}])
    poisoned = Trainer(_audited(
        "train.steps=8", "train.metrics_flush_every=2", "train.bad_step_patience=1",
        f"train.checkpoint_dir={tmp_path / 'ck2'}", "train.checkpoint_every=2",
        f"train.fault_plan={plan}"), device="cpu").fit()
    for report in (clean, poisoned):
        assert report["audit"]["unsanctioned"] == 0
        assert report["audit"]["recompiles"] == 0
        assert report["audit"]["sync_events"] == sum(report["audit"]["sync_sites"].values())
        assert report["final_loss"] is not None
    assert _sites(clean) == {"metrics_flush", "console", "eval_collect", "checkpoint",
                             "sentinel"}
    assert len(poisoned["resilience"]["rollbacks"]) == 1
    assert {"rollback", "divergence_guard"} <= _sites(poisoned)
    assert _sites(clean) | _sites(poisoned) == REFERENCE_SITES | PORT_SITES - {"step_sync"}


def test_trainer_audit_raises_on_batch_drift(monkeypatch):
    """A batch whose shape drifts between steps stops the audited run."""
    from repro_torch.data import pipeline

    orig = pipeline.SyntheticLM.batch_at

    def drifting(self, step):
        b = orig(self, step)
        return {k: v[:, :8] for k, v in b.items()} if step == 2 else b

    monkeypatch.setattr(pipeline.SyntheticLM, "batch_at", drifting)
    with pytest.raises(RuntimeError, match=r"\[train.audit\].*batch\['labels'\]"):
        Trainer(_audited(), device="cpu").fit()


# ---------------------------------------------------------------------------
# the battery runner (python -m repro_torch.analysis)
# ---------------------------------------------------------------------------

def test_runner_probe_overrides_equal_jax():
    from repro.analysis import runner as jrunner
    from repro_torch.analysis import runner as trunner
    assert trunner.probe_overrides("/x") == jrunner.probe_overrides("/x")
    assert (trunner.SEL_K, trunner.SEL_D, trunner.SEL_R) == \
        (jrunner._SEL_K, jrunner._SEL_D, jrunner._SEL_R)
    assert (trunner.ATTN_LAYERS, trunner.ATTN_B, trunner.ATTN_S) == \
        (jrunner._ATTN_LAYERS, jrunner._ATTN_B, jrunner._ATTN_S)


def test_sp001_counts_the_same_samplers_as_jax():
    from repro.analysis import runner as jrunner
    from repro_torch.analysis import runner as trunner
    (got,), (want,) = trunner.check_sampler_closures(), jrunner.check_sampler_closures()
    assert (got.rule, got.severity, got.message) == (want.rule, want.severity, want.message)


def test_cli_on_the_cpu_exits_0(tmp_path):
    import subprocess
    import sys
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device=cpu", f"--json={out}"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["ok"] is True
    rules = {f["rule"] for f in report["findings"]}
    assert {"SP001", "VM003", "SY001", "JX002"} <= rules


def test_cli_fails_on_a_planted_per_step_item(monkeypatch, capsys):
    """A ``.item()`` in every step stops the audited probe run: SY001, exit 1."""
    from repro_torch.analysis import runner as trunner
    from repro_torch.launch import steps as steps_lib

    orig = steps_lib.make_run_step

    def planted(mcfg, tcfg, **kw):
        run = orig(mcfg, tcfg, **kw)

        def step(state, batch):
            state, metrics = run(state, batch)
            metrics["loss"].item()
            return state, metrics
        return step

    monkeypatch.setattr(steps_lib, "make_run_step", planted)
    assert trunner.main(["--device=cpu", "--quiet"]) == 1
    out = capsys.readouterr().out
    assert "ERROR   SY001" in out and "unsanctioned host sync: item" in out


def test_cli_rules_prints_every_id(capsys):
    from repro_torch.analysis import runner as trunner
    assert trunner.main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"| {rid} |" in out for rid in treport.RULES)


def test_probe_without_a_device_runs_on_the_card_or_raises():
    """``run_probe``/``check_runtime`` default to the card, as the Trainer
    does; the CPU only when asked."""
    from repro_torch.analysis import runner as trunner
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    for fn in (trunner.run_probe, trunner.check_runtime):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_selection_and_attention_checks_without_a_device_run_on_the_card_or_raise():
    """``check_fused_selection``, ``check_streaming_selection``,
    ``check_sharded_selection`` and ``check_attention`` default to the card,
    as ``run_probe`` does; the CPU only when asked."""
    from repro_torch.analysis import runner as trunner
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    for fn in (trunner.check_fused_selection, trunner.check_streaming_selection,
               trunner.check_sharded_selection, trunner.check_attention):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert trunner.check_fused_selection("cpu", 32, 64, 8, (2, 4, 8)).ok


def test_cli_without_a_device_runs_on_the_card_or_raises():
    from repro_torch.analysis import runner as trunner
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.run_all(runtime=False)
