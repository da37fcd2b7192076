"""Legacy flat-config training driver — a thin shim over
``repro_torch.api``, as the JAX package's ``launch/train.py`` is over
``repro.api``.

``RunConfig`` and ``train(run)`` keep the JAX driver's signatures and
report shape; the loop is ``repro_torch.api.Trainer``'s. The flat
``RunConfig`` becomes a declarative ``ExperimentConfig`` (the same
``config_hash`` as the JAX shim's), and each legacy per-step function is a
``LegacyFunctionCallback``. New code should use ``repro_torch.api``::

    from repro_torch.api import ExperimentConfig, Trainer
    report = Trainer(ExperimentConfig()).fit()

``python -m repro_torch.launch.train --steps 8`` trains on the card;
``--device=cpu`` runs on the CPU on purpose.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch.api.config import ExperimentConfig, GraftConfig
from repro_torch.api.config import ModelConfig as ApiModelConfig
from repro_torch.api.config import OptimizerConfig
from repro_torch.api.config import TrainConfig as ApiTrainConfig


@dataclasses.dataclass
class RunConfig:
    arch: str = "minicpm-2b"
    smoke: bool = True
    steps: int = 100
    batch: int = 16
    seq: int = 64
    use_graft: bool = True
    sampler: str = "graft"              # any repro_torch.selection registry name
    graft_rset: tuple = (2, 4, 8)
    graft_eps: float = 0.25
    graft_refresh: int = 5
    lr: float = 3e-4
    optimizer: str = "adamw"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    stop_after: Optional[int] = None    # stop after N steps (the schedule
                                        # still spans ``steps``)
    metrics_path: Optional[str] = None  # JSONL telemetry stream
    eval_every: int = 0                 # 0 = no held-out evaluation


def to_experiment(run: RunConfig) -> ExperimentConfig:
    """The flat RunConfig as the declarative API config (the two drivers run
    the same trajectory)."""
    graft = GraftConfig(rset=tuple(run.graft_rset), eps=run.graft_eps,
                        refresh_every=run.graft_refresh,
                        grad_mode="probe") if run.use_graft else None
    return ExperimentConfig(
        model=ApiModelConfig(arch=run.arch, smoke=run.smoke),
        train=ApiTrainConfig(
            steps=run.steps, batch=run.batch, seq=run.seq, seed=run.seed,
            sampler=run.sampler, probe_positions=min(64, run.seq),
            log_every=run.log_every, eval_every=run.eval_every,
            checkpoint_dir=run.checkpoint_dir,
            checkpoint_every=run.checkpoint_every,
            metrics_path=run.metrics_path, stop_after=run.stop_after),
        graft=graft,
        optimizer=OptimizerConfig(
            name=run.optimizer, learning_rate=run.lr, schedule="cosine",
            total_steps=run.steps, warmup_steps=max(run.steps // 20, 1)))


def build(run: RunConfig):
    """(deprecated) → (model config, step TrainConfig, data source)."""
    return to_experiment(run).build()


def train(run: RunConfig, callbacks=None, device=None) -> Dict[str, Any]:
    """(deprecated) Train ``run`` with ``repro_torch.api.Trainer`` on
    ``device`` (default: the card). ``callbacks`` are legacy per-step
    functions ``fn(step, state, metrics)``."""
    from repro_torch.api.callbacks import LegacyFunctionCallback
    from repro_torch.api.trainer import Trainer
    extra = [LegacyFunctionCallback(cb) for cb in callbacks] if callbacks else None
    return Trainer(to_experiment(run), callbacks=extra, device=device).fit()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--no-graft", action="store_true")
    ap.add_argument("--sampler", default="graft",
                    help="selection strategy (see repro_torch.selection.available())")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU "
                         "on purpose)")
    args = ap.parse_args(argv)
    run = RunConfig(arch=args.arch, smoke=not args.full_config,
                    steps=args.steps, batch=args.batch, seq=args.seq,
                    use_graft=not args.no_graft, sampler=args.sampler,
                    checkpoint_dir=args.ckpt_dir, seed=args.seed)
    report = train(run, device=args.device)
    print(json.dumps({k: v for k, v in report.items() if k != "history"}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
