"""`python -m repro_torch.api` — declarative experiment launcher.

Input sources, later ones winning:

  1. defaults (``ExperimentConfig()``)
  2. ``--config exp.json`` — a saved config file (the JAX package's format)
  3. flat dotted overrides: ``--train.steps=5 --graft.eps=0.3``
     (``--graft=none`` disables selection; values are JSON, falling back
     to strings)

``--resume DIR`` ignores all of the above and reconstructs the experiment
from the manifest embedded in ``DIR``'s latest checkpoint.

Training runs on the GPU; ``--device=cpu`` runs on the CPU on purpose.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.trainer import Trainer


def _split_args(argv: List[str]):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None,
                    help="path to an ExperimentConfig JSON file")
    ap.add_argument("--resume", default=None, metavar="CKPT_DIR",
                    help="resume from a checkpoint directory's embedded config")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the finalized config JSON and exit (no training)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the run refuses to "
                         "start without a GPU unless this says cpu)")
    args, rest = ap.parse_known_args(argv)
    overrides = []
    for tok in rest:
        if tok.startswith("--") and "=" in tok:
            overrides.append(tok[2:])
        else:
            ap.error(f"unrecognized argument '{tok}' "
                     "(overrides use --section.field=value)")
    return args, overrides


def main(argv: Optional[List[str]] = None) -> int:
    args, overrides = _split_args(sys.argv[1:] if argv is None else argv)
    if args.resume:
        if overrides or args.config:
            print("error: --resume reconstructs the experiment from the "
                  "manifest alone; drop the other flags", file=sys.stderr)
            return 2
        trainer = Trainer.from_checkpoint(args.resume, device=args.device)
        if args.dump_config:
            print(trainer.config.to_json(indent=1))
            return 0
    else:
        cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
        cfg = cfg.apply_overrides(overrides)
        if args.dump_config:
            print(cfg.finalized().to_json(indent=1))
            return 0
        trainer = Trainer(cfg, device=args.device)
    report = trainer.fit()
    print(json.dumps({k: v for k, v in report.items() if k != "history"}, indent=1))
    return 0
