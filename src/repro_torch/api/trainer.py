"""The ``Trainer``: build, init, step, history — over a declarative
``ExperimentConfig``.

It runs on the CUDA device: ``Trainer(cfg)`` picks ``cuda`` and raises if
there is none. Only an explicit ``device="cpu"`` runs on the CPU (the tests
do). Each step is timed on the host clock around work that ends in a
device synchronize, and its metrics are read to the host once the loop is
done.

Callbacks, checkpoint save/resume, held-out eval, the overlapped refresh,
the audit and the chaos harness of the JAX ``Trainer`` are still to port;
a config that asks for one of them is refused with ``NotImplementedError``
(``ROADMAP.md``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.launch import steps as steps_lib

# train/graft fields whose machinery is not ported, with their inert value
_NOT_PORTED = (
    ("train", "eval_every", 0), ("train", "checkpoint_dir", None),
    ("train", "metrics_path", None), ("train", "stop_after", None),
    ("train", "audit", False), ("train", "fault_plan", None),
    ("train", "history_cap", 0), ("graft", "overlap", False),
    ("graft", "streaming", False),
)


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` → the CUDA device, or an error when there is none: an entry
    point never falls back to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch trains on the GPU; pass "
                "device='cpu' (or --device=cpu) to run on the CPU on purpose")
        return torch.device("cuda")
    return torch.device(device)


def _scalar(v: Any) -> Any:
    return v.item() if isinstance(v, torch.Tensor) else v


class Trainer:
    """Runs one experiment on ``device`` (default: the GPU)."""

    def __init__(self, config: ExperimentConfig,
                 device: Optional[str | torch.device] = None):
        self.config = config.finalized()
        for section, field, inert in _NOT_PORTED:
            sec = getattr(self.config, section)
            if sec is not None and getattr(sec, field) != inert:
                raise NotImplementedError(
                    f"{section}.{field}={getattr(sec, field)!r} needs machinery "
                    "that is not ported to repro_torch yet (see ROADMAP.md)")
        self.device = resolve_device(device)
        self.mcfg = None
        self.tcfg: Optional[steps_lib.TrainConfig] = None
        self.data = None
        self.state: Optional[Dict[str, Any]] = None
        self.num_params = 0

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self) -> Dict[str, Any]:
        cfg = self.config
        tr = cfg.train
        self.mcfg, self.tcfg, self.data = cfg.build()
        gen = torch.Generator(device=self.device).manual_seed(tr.seed)
        self.state = steps_lib.init_train_state(self.mcfg, self.tcfg, gen,
                                                tr.batch, self.device)
        self.num_params = sum(p.numel() for p in self.state["params"])
        step_fn = steps_lib.make_train_step(self.mcfg, self.tcfg)
        rows: List[Dict[str, Any]] = []
        t_start = time.perf_counter()
        for step in range(tr.steps):
            batch = self._to_device(self.data.batch_at(step))
            t0 = time.perf_counter()
            self.state, metrics = step_fn(self.state, batch)
            self._sync()
            metrics["step_time_s"] = time.perf_counter() - t0
            rows.append(metrics)
            if tr.log_every and (step % tr.log_every == 0 or step == tr.steps - 1):
                print(f"[train] step {step} loss {_scalar(metrics['loss']):.5f} "
                      f"rank {_scalar(metrics.get('rank', -1))} "
                      f"{metrics['step_time_s'] * 1e3:.1f} ms", flush=True)
        wall = time.perf_counter() - t_start
        history = [{k: _scalar(v) for k, v in r.items()} for r in rows]
        return {
            "final_loss": history[-1]["loss"] if history else None,
            "history": history,
            "config_hash": cfg.config_hash(),
            "steps": len(history),
            "wall_s": wall,
            "device": str(self.device),
            "num_params": self.num_params,
        }
