"""Optimizers (AdamW, SGD + momentum, Lion, Adafactor) and learning-rate
schedules."""
from repro_torch.optim.optimizers import (ClippedGrads, Optimizer, OptimizerConfig,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import SCHEDULES

__all__ = ["ClippedGrads", "Optimizer", "OptimizerConfig", "make_optimizer",
           "clip_by_global_norm", "global_norm", "SCHEDULES"]
