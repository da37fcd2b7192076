"""Architecture registry: one module per architecture.

``get_config(arch_id)`` returns the exact published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
Ported: ``minicpm-2b``, ``stablelm-12b``, ``gemma2-27b`` and
``qwen1.5-32b`` (the dense family), ``qwen3-moe-235b-a22b`` and
``kimi-k2-1t-a32b`` (moe), ``rwkv6-7b`` (ssm) and ``hymba-1.5b`` (hybrid);
the JAX package's other two architectures raise ``NotImplementedError``
pointing to ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.model import ModelConfig

ARCHS = ("minicpm_2b", "stablelm_12b", "gemma2_27b", "qwen15_32b",
         "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b", "rwkv6_7b", "hymba_1_5b")

# the JAX package's architectures that the port does not have yet (A6)
_NOT_PORTED = ("musicgen_medium", "internvl2_26b")

# canonical CLI ids (dashes) → module names
_ALIASES: Dict[str, str] = {
    "stablelm-12b": "stablelm_12b",
    "gemma2-27b": "gemma2_27b",
    "qwen1.5-32b": "qwen15_32b",
    "qwen15-32b": "qwen15_32b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-7b": "rwkv6_7b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-26b": "internvl2_26b",
    "hymba-1.5b": "hymba_1_5b",
    "hymba-1-5b": "hymba_1_5b",
}


def _module(arch: str):
    name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture '{arch}' is not ported to repro_torch yet "
            f"(see ROADMAP.md, A6); available: {list(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{arch}'; available: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
