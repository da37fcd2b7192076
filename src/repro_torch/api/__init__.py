"""Experiment API of the port — the public entry point for training runs.

    from repro_torch.api import ExperimentConfig, Trainer

    cfg = ExperimentConfig().apply_overrides(["train.steps=40"])
    report = Trainer(cfg).fit()          # on the GPU; device="cpu" on purpose

CLI::

    python -m repro_torch.api --train.steps=5 --graft.use_pallas=true
    python -m repro_torch.api --resume /ckpts/run1
"""
from repro_torch.api.callbacks import (Callback, CheckpointCallback, ConsoleCallback,
                                       EvalCallback, HookRecorder, MetricsCallback,
                                       PreemptionCallback, StragglerCallback,
                                       default_callbacks)
from repro_torch.api.config import (DataConfig, ExperimentConfig, GraftConfig,
                                    ModelConfig, OptimizerConfig, TrainConfig,
                                    apply_overrides)
from repro_torch.api.trainer import Trainer

__all__ = ["ExperimentConfig", "ModelConfig", "TrainConfig", "GraftConfig",
           "DataConfig", "OptimizerConfig", "apply_overrides", "Trainer",
           "Callback", "default_callbacks", "PreemptionCallback", "EvalCallback",
           "MetricsCallback", "StragglerCallback", "ConsoleCallback",
           "CheckpointCallback", "HookRecorder"]
