"""The chaos matrix: every recovery path exercised by an injected fault —
the port of the JAX package's ``python -m repro.resilience``, with its
cell, its scenarios and its bars.

    python -m repro_torch.resilience [--device=cpu] [--only NAME] [--json PATH]

It runs on the CUDA device unless ``--device`` says otherwise (and refuses
to run where there is none). Five end-to-end scenarios against a small
synthetic_lm cell (20 steps, batch 8, seq 16, a checkpoint every 5 steps, a
metrics flush every 4, patience 1, GRAFT ranks [2, 4] refreshed every 3
steps):

  * **nan_rollback** — a NaN batch at step 12: the sentinel skips the
    update, the guard trips (patience 1) at the next drain boundary, the
    trainer rolls back to the last healthy checkpoint and finishes — with a
    final loss BIT-IDENTICAL to an uninjected run resumed from that same
    checkpoint, and the poisoned JSONL row serialized as ``null`` +
    ``nonfinite_keys`` (valid JSON throughout);
  * **streaming_nan_rollback** — the same with the streaming sampler's
    sketch reservoir riding the train state: rolled back and replayed
    exactly;
  * **corrupt_leaf** — a bit flipped in the newest checkpoint's params:
    ``restore_latest_good`` quarantines it to ``corrupt.<step>`` and
    resumes from the prior step;
  * **sigterm** — SIGTERM mid-run: emergency checkpoint, clean stop, the
    resume runs the remaining steps;
  * **kill_mid_save** — the async checkpoint writer dies pre-commit: the
    failure surfaces on the next save, abort cleanup releases handlers and
    files, and a restart recovers (stale tmp dropped, committed checkpoints
    intact).

Each scenario takes extra overrides after its directory (``_cell(td,
*extra)``) and the device as a keyword, so that another script can run it
at another width. Exit code 0 iff every scenario passes; ``--json PATH``
dumps the results.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, List, Optional

from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.api.trainer import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.resilience import chaos

STEPS = 20
FAULT_STEP = 12          # the step the step-keyed faults hit


def _cell(td: str, *extra: str, fault_plan=None) -> ExperimentConfig:
    ck = os.path.join(td, "ck")
    overrides = [
        f"train.steps={STEPS}", "train.batch=8", "train.seq=16",
        "train.log_every=0", f"train.checkpoint_dir={ck}",
        "train.checkpoint_every=5", "train.metrics_flush_every=4",
        f"train.metrics_path={os.path.join(td, 'metrics.jsonl')}",
        "train.bad_step_patience=1", "graft.rset=[2,4]",
        "graft.refresh_every=3", *extra,
    ]
    if fault_plan is not None:
        overrides.append("train.fault_plan=" + json.dumps(fault_plan))
    return ExperimentConfig().apply_overrides(overrides)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _rollback_and_twin(td: str, cfg: ExperimentConfig, device, what: str) -> Dict:
    """Run ``cfg`` (one poisoned batch), require one rollback, and require an
    uninjected run resumed from the checkpoint the rollback landed on to end
    on the same final loss, bit for bit."""
    report = Trainer(cfg, device=device).fit()
    rollbacks = report.get("resilience", {}).get("rollbacks", [])
    _require(len(rollbacks) == 1, f"expected one rollback, got {rollbacks}")
    to_step = rollbacks[0]["to_step"]
    twin_dir = os.path.join(td, "twin")
    os.makedirs(twin_dir)
    shutil.copytree(os.path.join(td, "ck", f"step_{to_step:08d}"),
                    os.path.join(twin_dir, f"step_{to_step:08d}"))
    twin = Trainer.from_checkpoint(twin_dir, device=device).fit()
    _require(twin["final_loss"] == report["final_loss"],
             f"final loss diverged{what}: injected {report['final_loss']} vs "
             f"clean resume {twin['final_loss']}")
    return {"rolled_back_to": to_step, "final_loss": report["final_loss"]}


def scenario_nan_rollback(td: str, *extra: str, device=None, nan_step: int = FAULT_STEP) -> Dict:
    cfg = _cell(td, *extra, fault_plan=[{"kind": "nan_batch", "step": nan_step}])
    out = _rollback_and_twin(td, cfg, device, "")
    # the poisoned step's telemetry row is valid JSON with null markers
    with open(os.path.join(td, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    poisoned = [r for r in rows if r["step"] == nan_step and r.get("loss") is None]
    _require(bool(poisoned), "no sanitized NaN row for the poisoned step")
    _require("loss" in poisoned[0].get("nonfinite_keys", []), "nonfinite_keys missing 'loss'")
    return out


def scenario_streaming_nan_rollback(td: str, *extra: str, device=None) -> Dict:
    """nan_rollback with a LIVE sketch reservoir: the streaming sampler's
    carry (frequent-directions sketch + stream-mean EMA) rides the train
    state, so the rollback must restore it and the replay must advance it
    identically."""
    cfg = _cell(td, "train.sampler=streaming_graft", *extra,
                fault_plan=[{"kind": "nan_batch", "step": FAULT_STEP}])
    return _rollback_and_twin(td, cfg, device, " with live reservoir")


def scenario_corrupt_leaf(td: str, *extra: str, device=None) -> Dict:
    Trainer(_cell(td, *extra), device=device).fit()
    ck = os.path.join(td, "ck")
    steps = CheckpointManager(ck).all_steps()
    newest, prior = steps[-1], steps[-2]
    key = chaos.flip_checkpoint_leaf(ck, newest, "params")
    trainer = Trainer.from_checkpoint(ck, device=device)
    report = trainer.fit()
    _require(trainer.start_step == prior,
             f"resumed from {trainer.start_step}, wanted prior step {prior}")
    names = os.listdir(ck)
    _require(f"corrupt.{newest:08d}" in names,
             f"bit-flipped step {newest} not quarantined: {sorted(names)}")
    _require(newest not in CheckpointManager(ck).all_steps()
             or os.path.exists(os.path.join(ck, f"step_{newest:08d}")),
             "all_steps inconsistent after quarantine")
    return {"flipped": key, "quarantined": newest, "resumed_from": prior,
            "final_loss": report["final_loss"]}


def scenario_sigterm(td: str, *extra: str, device=None) -> Dict:
    cfg = _cell(td, "train.checkpoint_every=50", *extra,
                fault_plan=[{"kind": "sigterm", "step": FAULT_STEP}])
    first = Trainer(cfg, device=device).fit()
    _require(first.get("stopped") == "preempted",
             f"expected preempted stop, got {first.get('stopped')!r}")
    resumed = Trainer.from_checkpoint(os.path.join(td, "ck"), device=device).fit()
    total = first["host_loop"]["steps"] + resumed["host_loop"]["steps"]
    _require(total == STEPS, f"{total} steps across stop+resume, wanted {STEPS}")
    return {"stopped_after": first["host_loop"]["steps"], "final_loss": resumed["final_loss"]}


def scenario_kill_mid_save(td: str, *extra: str, device=None) -> Dict:
    # the SECOND async save's writer dies before the commit rename; the
    # stored failure surfaces from wait() at the third save → fit aborts
    cfg = _cell(td, *extra, fault_plan=[{"kind": "crash", "skip": 1,
                                         "point": "checkpoint.pre_commit"}])
    try:
        Trainer(cfg, device=device).fit()
        raise AssertionError("injected writer crash never surfaced")
    except chaos.ChaosCrash:
        pass
    ck = os.path.join(td, "ck")
    survivors = CheckpointManager(ck).all_steps()   # init ran recover()
    _require(survivors == [5], f"committed checkpoints after crash: {survivors} (wanted [5])")
    report = Trainer.from_checkpoint(ck, device=device).fit()
    _require(report["host_loop"]["steps"] == STEPS - 5,
             f"restart ran {report['host_loop']['steps']} steps, wanted {STEPS - 5}")
    return {"survivors": survivors, "final_loss": report["final_loss"]}


SCENARIOS: List[Callable[..., Dict]] = [
    scenario_nan_rollback,
    scenario_streaming_nan_rollback,
    scenario_corrupt_leaf,
    scenario_sigterm,
    scenario_kill_mid_save,
]


def scenario_name(scenario: Callable) -> str:
    return scenario.__name__.removeprefix("scenario_")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="run the chaos matrix")
    parser.add_argument("--json", default=None, help="write the scenario results to this path")
    parser.add_argument("--only", default=None, help="run a single scenario by name")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    results: Dict[str, Dict] = {}
    failed = False
    for scenario in SCENARIOS:
        name = scenario_name(scenario)
        if args.only and name != args.only:
            continue
        td = tempfile.mkdtemp(prefix=f"chaos_{name}_")
        try:
            results[name] = {"ok": True, **scenario(td, device=device)}
            print(f"[chaos] {name}: PASS {results[name]}")
        except Exception as e:                      # noqa: BLE001
            failed = True
            results[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            print(f"[chaos] {name}: FAIL {e}")
        finally:
            shutil.rmtree(td, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print("[chaos] matrix:", "FAIL" if failed else "PASS")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
