"""``python -m repro_torch.backend`` — the 2-rank fleet harness, the twin of
the JAX package's ``python -m repro.backend``.

It runs one config (8 steps, batch 8, seq 16, a refresh every 2 steps, a
checkpoint every 4, the refresh through its kernel route) three ways and
checks the two promises of the backend:

  1. **Loss parity** — a 2-rank fleet (``torch.distributed``, stopped after
     4 steps) tracks the 1-process run of the same config step for step,
     in loss and grad norm: step 0 within rtol 1e-5, every later step
     within rtol 3e-3 (a different rank count sums the gradients in another
     order, as in the JAX harness). Its ranks end with bit-equal
     parameters, its pivots and rank at the first refresh equal the
     1-process run's, its ranks' pivots are equal at every refresh, each
     rank's kernel launches equal the one-rank reckoning, only rank 0
     writes the JSONL stream, and the checkpoint's manifest is stamped
     ``{2, 2, replicated}``.
  2. **Elastic resume** — the fleet's step-4 checkpoint resumes in ONE
     process from the directory alone, and its final loss tracks the
     uninterrupted run's within rtol 3e-3.

It runs on the card unless ``--device=cpu`` asks for the CPU (the two
ranks then use gloo; on one card they share it, also over gloo). Exit code
0 means both hold; ``--json`` prints the measurements as the last line.
``--worker`` is one rank's entry point: the flags after it are the
experiment's overrides, and it prints its result as JSON. It trains
(``fleet.run_worker``), or with ``--job=F --out=D`` runs a job file's
sharded-selection and pipeline tasks on a mesh over the rank's backend
(``fleet.run_mesh_job``; the overrides name the backend).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List

import numpy as np

from repro_torch.backend import fleet

STEPS = 8
STOP_AFTER = 4

BASE_OVERRIDES = [
    f"train.steps={STEPS}",
    "train.batch=8",
    "train.seq=16",
    "train.log_every=0",
    "train.checkpoint_every=4",
    "train.metrics_flush_every=1",
    "graft.refresh_every=2",
    "graft.use_pallas=true",
]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _losses(result: Dict, key: str = "losses") -> Dict[int, float]:
    return {int(k): v for k, v in result[key].items()}


def check_fleet(ref: Dict, ranks: List[Dict]) -> None:
    """The fleet's promises against the 1-process ``ref`` (both as
    ``fleet.run_worker`` results). The loss and the grad norm of every step
    track the 1-process run's (the norm is of the reduced gradients, so a
    missing or mis-scaled reduce shows there even where AdamW hides it in
    the loss), and the ranks end with bit-equal parameters."""
    ref_loss, ref_norm = _losses(ref), _losses(ref, "grad_norms")
    for res in ranks:
        two, norm = _losses(res), _losses(res, "grad_norms")
        steps = sorted(two)
        _require(bool(steps), f"rank {res['process_index']} ran no step")
        first = steps[0]
        for what, got, want in (("loss", two, ref_loss), ("grad norm", norm, ref_norm)):
            _require(np.isclose(got[first], want[first], rtol=1e-5, atol=0),
                     f"step {first}: fleet {what} {got[first]} vs 1 process {want[first]}")
            for s in steps:
                _require(np.isclose(got[s], want[s], rtol=3e-3, atol=0),
                         f"{what} parity broke at step {s}: fleet {got[s]} vs {want[s]}")
        _require(res["params_sha256"] == ranks[0]["params_sha256"],
                 f"rank {res['process_index']} ends with other parameters than rank 0")
        _require(all(res["launches"].get(k, 0) == v
                     for k, v in res["launches_expected"].items()),
                 f"rank {res['process_index']} launches {res['launches']}, reckoned "
                 f"{res['launches_expected']}")
        _require(res["topology"] == {"process_count": len(ranks),
                                     "device_count": len(ranks),
                                     "shard_layout": "replicated"},
                 f"topology {res['topology']}")
    first_refresh = min(ranks[0]["pivots"], key=int)
    for res in ranks:
        _require(res["pivots"][first_refresh] == ref["pivots"][first_refresh],
                 f"rank {res['process_index']} pivots {res['pivots'][first_refresh]} at the "
                 f"first refresh vs 1 process {ref['pivots'][first_refresh]}")
        _require(res["ranks"][first_refresh] == ref["ranks"][first_refresh],
                 "the rank chosen at the first refresh differs from the 1-process run's")
        _require(res["pivots"] == ranks[0]["pivots"],
                 f"ranks disagree on pivots: {res['pivots']} vs {ranks[0]['pivots']}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--worker":
        ap = argparse.ArgumentParser(prog="python -m repro_torch.backend --worker")
        ap.add_argument("--device", default=None)
        ap.add_argument("--job", default=None)
        ap.add_argument("--out", default=None)
        args, rest = ap.parse_known_args(argv[1:])
        overrides = [tok[2:] for tok in rest]
        if args.job:
            result = fleet.run_mesh_job(args.job, args.out, overrides, device=args.device)
        else:
            result = fleet.run_worker(overrides, device=args.device)
        print(json.dumps(result), flush=True)
        return 0
    ap = argparse.ArgumentParser(prog="python -m repro_torch.backend", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true", help="print the measurements as JSON")
    ap.add_argument("--workdir", default=None, help="keep artifacts here, not in a temp dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU on "
                         "purpose)")
    ap.add_argument("--timeout", type=float, default=fleet.DEFAULT_TIMEOUT_S,
                    help="seconds each fleet may take before it is killed")
    args = ap.parse_args(argv)

    from repro_torch.api import Trainer
    from repro_torch.backend import resolve_device
    device = str(resolve_device(args.device))
    work = args.workdir or tempfile.mkdtemp(prefix="fleet.")
    os.makedirs(work, exist_ok=True)

    # ---- 1: the 1-process reference -------------------------------------
    ref_ckpt = os.path.join(work, "ref_ckpt")
    ref = fleet.run_worker(BASE_OVERRIDES + [
        f"train.metrics_path={os.path.join(work, 'ref.jsonl')}",
        f"train.checkpoint_dir={ref_ckpt}"], device=device)
    print(f"[fleet] 1 process: losses {[round(v, 5) for v in _losses(ref).values()]}",
          flush=True)

    # ---- 2: the 2-rank fleet --------------------------------------------
    port = fleet.free_port()
    two_ckpt = os.path.join(work, "two_ckpt")
    metrics = [os.path.join(work, f"two.p{r}.jsonl") for r in (0, 1)]
    cmds = [fleet.worker_command(BASE_OVERRIDES + [
        f"train.metrics_path={metrics[r]}", f"train.checkpoint_dir={two_ckpt}",
        f"train.stop_after={STOP_AFTER}",
        *fleet.backend_overrides(2, r, port, "backend.compress_reduce=true")], device=device)
        for r in (0, 1)]
    ranks = [r.last_json() for r in fleet.launch(cmds, timeout=args.timeout)]
    print(f"[fleet] 2 ranks:   losses {[round(v, 5) for v in _losses(ranks[0]).values()]}",
          flush=True)
    check_fleet(ref, ranks)
    _require(os.path.exists(metrics[0]) and not os.path.exists(metrics[1]),
             "the JSONL stream must come from rank 0 alone")
    with open(os.path.join(two_ckpt, f"step_{STOP_AFTER:08d}", "manifest.json")) as f:
        stamp = json.load(f)["topology"]
    _require(stamp == {"process_count": 2, "device_count": 2, "shard_layout": "replicated"},
             f"manifest topology {stamp}")
    print("[fleet] loss parity OK (2 ranks == 1 process)", flush=True)

    # ---- 3: elastic resume, 2-rank checkpoint → 1 process ----------------
    resumed = Trainer.from_checkpoint(two_ckpt, device=device)
    report = resumed.fit()
    _require(resumed.start_step == STOP_AFTER,
             f"resume started at step {resumed.start_step}, not {STOP_AFTER}")
    ref_final = _losses(ref)[STEPS - 1]
    _require(np.isclose(report["final_loss"], ref_final, rtol=3e-3, atol=0),
             f"post-resume final loss {report['final_loss']} vs uninterrupted {ref_final}")
    print(f"[fleet] elastic resume OK (2-rank checkpoint → 1 process, final "
          f"{report['final_loss']:.5f} vs {ref_final:.5f})", flush=True)

    if args.json:
        print(json.dumps({"reference": ref, "ranks": ranks, "stamp": stamp,
                          "resume_final": report["final_loss"],
                          "resume_losses": [r["loss"] for r in report["history"]]}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
