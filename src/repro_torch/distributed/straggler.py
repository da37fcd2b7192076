"""Straggler detection + mitigation hooks (host-only; a copy of the JAX
package's `distributed/straggler.py`).

On a real multi-host pod, per-step wall time is the max over hosts — one
slow host (thermal throttle, faulty HBM, noisy neighbor) drags the fleet.
The monitor keeps a robust EMA of step times and flags outliers; the
GRAFT-specific mitigation (DESIGN.md §5) is to shrink the subset rank R on
flagged steps — selection gives the framework a *compute-elastic* knob that
plain training lacks: the coordinator broadcasts a reduced rank index and
every host deterministically trains on the first R' MaxVol pivots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    ema_decay: float = 0.9
    threshold: float = 1.5          # step flagged if > threshold × EMA
    min_history: int = 5
    rank_backoff: float = 0.5       # shrink GRAFT rank to this fraction


class StragglerMonitor:
    def __init__(self, cfg: Optional[StragglerConfig] = None,
                 process_index: int = 0):
        self.cfg = cfg if cfg is not None else StragglerConfig()
        self.process_index = process_index
        self.ema: Optional[float] = None
        self.count = 0
        self.flagged: List[int] = []
        self._history: List[float] = []

    def record(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self._history.append(step_time_s)
        is_straggler = False
        if self.ema is not None and self.count >= self.cfg.min_history:
            is_straggler = step_time_s > self.cfg.threshold * self.ema
        if is_straggler:
            self.flagged.append(self.count)
        else:
            # stragglers don't poison the EMA
            self.ema = (step_time_s if self.ema is None else
                        self.cfg.ema_decay * self.ema +
                        (1 - self.cfg.ema_decay) * step_time_s)
        self.count += 1
        return is_straggler

    def suggested_rank(self, current_rank: int, is_straggler: bool) -> int:
        """GRAFT mitigation: cut the subset size while degraded."""
        if not is_straggler:
            return current_rank
        return max(1, int(current_rank * self.cfg.rank_backoff))

    def summary(self) -> Dict[str, float]:
        return {
            "process_index": self.process_index,
            "steps": self.count,
            "flagged": len(self.flagged),
            "ema_s": self.ema or 0.0,
            "p50_s": (sorted(self._history)[len(self._history) // 2]
                      if self._history else 0.0),
            "max_s": max(self._history) if self._history else 0.0,
        }


def merge_summaries(summaries: List[Dict[str, float]]) -> Dict[str, float]:
    """Fleet view from per-process monitor summaries: the coordinator's
    mitigation decision keys on the WORST host, so attribute it."""
    if not summaries:
        return {"processes": 0, "flagged_total": 0, "worst_process": -1,
                "worst_ema_s": 0.0, "max_s": 0.0}
    worst = max(summaries, key=lambda s: s.get("ema_s", 0.0))
    return {
        "processes": len(summaries),
        "flagged_total": int(sum(s.get("flagged", 0) for s in summaries)),
        "worst_process": int(worst.get("process_index", 0)),
        "worst_ema_s": float(worst.get("ema_s", 0.0)),
        "max_s": float(max(s.get("max_s", 0.0) for s in summaries)),
    }
