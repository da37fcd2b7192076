"""Running a fleet of ranks on one host, and the worker each rank runs —
shared by the 2-rank harness (``python -m repro_torch.backend``), the tests
and the card's smoke script.

``launch`` starts one process per rank and waits for all of them under one
time limit; on a timeout it kills the whole fleet and raises with every
rank's stderr, so that no caller can hang. Each rank gets an even share of
the host's cores (``OMP_NUM_THREADS``), since ranks that each spin on every
core run an order of magnitude slower.

``run_worker`` trains one experiment under the launch audit and returns
what a fleet is held to: per-step losses, grad norms and ranks, the pivots
of every refresh, a digest of the final parameters, each kernel's
launches, the backend's topology and collectives, its gradient-reduce
seconds, and a probe of the host-side ``all_reduce``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# seconds a fleet may take before it is killed
DEFAULT_TIMEOUT_S = 120
# what every rank's process group waits for a peer (REPRO_TORCH_DIST_TIMEOUT_S)
DIST_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_overrides(world: int, rank: int, port: int, *extra: str) -> List[str]:
    """The ``backend`` overrides of rank ``rank`` of a ``world``-rank fleet
    that meets at ``127.0.0.1:port``."""
    return ["backend.kind=multiprocess", f"backend.coordinator=127.0.0.1:{port}",
            f"backend.num_processes={world}", f"backend.process_id={rank}", *extra]


def fleet_env(world: int, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // max(1, world))))
    env.setdefault("REPRO_TORCH_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
    if extra:
        env.update(extra)
    return env


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str

    def last_json(self) -> Dict[str, Any]:
        """The JSON object on the last line of stdout."""
        lines = [ln for ln in self.stdout.splitlines() if ln.strip()]
        if not lines:
            raise ValueError(f"rank {self.rank} printed nothing")
        return json.loads(lines[-1])


class FleetError(RuntimeError):
    """A fleet that timed out (and was killed) or whose ranks failed."""


def _tails(results: Sequence[RankResult]) -> str:
    return "\n".join(f"--- rank {r.rank} (rc {r.returncode}) stderr ---\n{r.stderr[-3000:]}"
                     f"\n--- rank {r.rank} stdout ---\n{r.stdout[-1500:]}" for r in results)


def launch(commands: Sequence[Sequence[str]], *, timeout: float = DEFAULT_TIMEOUT_S,
           env: Optional[Dict[str, str]] = None, check: bool = True,
           cwd: Optional[str] = None) -> List[RankResult]:
    """Run one process per rank (``commands[r]`` is rank r's argv) and wait
    for all of them, ``timeout`` seconds in all. A timeout kills every rank
    and raises :class:`FleetError` with their stderr; with ``check`` a
    nonzero exit of any rank raises it too."""
    env = env if env is not None else fleet_env(len(commands))
    procs = [subprocess.Popen(list(cmd), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=cwd) for cmd in commands]
    results: List[Optional[RankResult]] = [None] * len(procs)
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            results[r] = RankResult(r, p.returncode, out, err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        got = []
        for r, p in enumerate(procs):
            out, err = p.communicate()
            got.append(RankResult(r, p.returncode, out, err))
        raise FleetError(f"fleet timed out after {timeout:.0f} s and was killed\n"
                         + _tails(got)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if check and any(r.returncode != 0 for r in results):
        raise FleetError("fleet rank(s) failed\n" + _tails(results))
    return results


def worker_command(overrides: Sequence[str], device: Optional[str] = None) -> List[str]:
    """argv of one rank running :func:`run_worker` (``python -m
    repro_torch.backend --worker``)."""
    cmd = [sys.executable, "-m", "repro_torch.backend", "--worker"]
    if device is not None:
        cmd.append(f"--device={device}")
    return cmd + [f"--{o}" for o in overrides]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

# the host-side all_reduce probe: rank r's leaves, a function of r alone
def all_reduce_probe_inputs(rank: int) -> Dict[str, Any]:
    x = np.linspace(-1.0, 1.0, 300, dtype=np.float32) * (rank + 1) + 0.01 * rank
    return {"vec": x, "scalar": np.float32(0.5 + rank)}


def params_digest(params) -> str:
    """sha256 of the parameters' bytes, in order: equal on every rank of a
    fleet whose replicated state stayed equal."""
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def run_worker(overrides: Sequence[str], device=None) -> Dict[str, Any]:
    """Train the experiment of ``overrides`` under the launch audit; the
    result dict is JSON-ready."""
    from repro_torch.analysis import launch_audit
    from repro_torch.api import Callback, ExperimentConfig, Trainer
    from repro_torch.models.layers import resolve_attn_backend

    class PivotRecorder(Callback):
        priority = 94

        def __init__(self):
            self.pivots: Dict[int, List[int]] = {}
            self.all_reduce: List[Any] = []

        def on_step_end(self, trainer, step, metrics) -> None:
            gcfg = trainer.tcfg.graft
            if gcfg is not None and step % gcfg.refresh_every == 0:
                self.pivots[step] = trainer.state["graft"].pivots.tolist()

        def on_train_end(self, trainer, report) -> None:
            # two calls, so that the compressed reduce's error carry shows
            probe = all_reduce_probe_inputs(trainer.backend.process_index)
            self.all_reduce = [
                {k: np.asarray(v).tolist() for k, v in trainer.backend.all_reduce(probe).items()}
                for _ in range(2)]

    cfg = ExperimentConfig().apply_overrides(list(overrides))
    rec = PivotRecorder()
    trainer = Trainer(cfg, callbacks=[rec], device=device)
    with launch_audit.recording() as trace:
        report = trainer.fit()
    backend = trainer.backend          # torn down: its counts come from its config
    rows = report["history"]
    out: Dict[str, Any] = {
        "process_index": backend.process_index,
        "backend": backend.name,
        "collectives": getattr(backend, "collectives", None),
        "topology": backend.topology(),
        "losses": {str(i + trainer.start_step): r["loss"] for i, r in enumerate(rows)},
        "ranks": {str(i + trainer.start_step): r.get("rank") for i, r in enumerate(rows)},
        "grad_norms": {str(i + trainer.start_step): r["grad_norm"] for i, r in enumerate(rows)},
        "params_sha256": params_digest(trainer.state["params"]),
        "step_s": [r["step_time_s"] for r in rows],
        "pivots": {str(k): v for k, v in rec.pivots.items()},
        "launches": dict(trace.counts),
        "final_loss": report["final_loss"],
        "rollbacks": report.get("resilience", {}).get("rollbacks", []),
        "start_step": trainer.start_step,
        "reduce_s": list(getattr(backend, "reduce_seconds", [])),
        "all_reduce": rec.all_reduce,
        "device": str(trainer.device),
    }
    run_cfg = dataclasses.replace(trainer.config, train=dataclasses.replace(
        trainer.config.train, steps=len(rows)))
    flash = resolve_attn_backend(trainer.mcfg, cfg.train.seq, cfg.train.seq,
                                 trainer.device) == "flash"
    if trainer.tcfg.use_graft:
        out["launches_expected"] = launch_audit.expected_launches(
            trainer.mcfg, run_cfg, launch_audit.optim_groups(trainer.state["params"]),
            flash=flash, card=trainer.device.type == "cuda")
    return out
