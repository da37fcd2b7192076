"""Learning-rate schedules: cosine, WSD (MiniCPM's warmup-stable-decay),
linear, constant. Each is ``f(step: int) -> float``, evaluated on the host
(the port's step counter is a Python int) in float32 arithmetic, as the
JAX package evaluates them on the device."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    def f(step):
        return float(_F(lr))
    return f


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           min_ratio: float = 0.1):
    def f(step):
        step = _F(step)
        warm = step / _F(max(warmup_steps, 1))
        progress = np.clip((step - _F(warmup_steps)) /
                           _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        cos = _F(min_ratio) + _F(1 - min_ratio) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * progress))
        return float(_F(lr) * (warm if step < warmup_steps else cos))
    return f


def wsd(lr: float, total_steps: int, warmup_steps: int = 0,
        decay_fraction: float = 0.1, min_ratio: float = 0.01):
    """Warmup → Stable → Decay: a constant plateau, then a linear-in-log
    decay over the final fraction."""
    decay_steps = max(int(total_steps * decay_fraction), 1)
    decay_start = total_steps - decay_steps

    def f(step):
        step = _F(step)
        warm = step / _F(max(warmup_steps, 1))
        decay_progress = np.clip((step - _F(decay_start)) / _F(decay_steps),
                                 _F(0), _F(1))
        decay = np.exp(np.log(_F(max(min_ratio, 1e-6))) * decay_progress)
        scale = warm if step < warmup_steps else (
            _F(1) if step < decay_start else decay)
        return float(_F(lr) * scale)
    return f


def linear(lr: float, total_steps: int, warmup_steps: int = 0,
           min_ratio: float = 0.0):
    def f(step):
        step = _F(step)
        warm = step / _F(max(warmup_steps, 1))
        progress = np.clip((step - _F(warmup_steps)) /
                           _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))
        lin = _F(1) - _F(1 - min_ratio) * progress
        return float(_F(lr) * (warm if step < warmup_steps else lin))
    return f


SCHEDULES = {"constant": constant, "cosine": cosine, "wsd": wsd, "linear": linear}
