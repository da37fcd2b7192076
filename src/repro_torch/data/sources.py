"""Task/data-source registry: named training workloads behind one protocol.

A registered :class:`SourceEntry` pairs a config dataclass (the ``data``
section of an ``ExperimentConfig``), a function that builds the source, and a task adapter.
The port registers ``synthetic_lm`` only; the classification and vision
sources of the JAX package raise ``NotImplementedError`` pointing to
``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.data.pipeline import DataConfig, DataSourceBase, SyntheticLM
from repro_torch.registry import Registry


@dataclasses.dataclass(frozen=True)
class TaskAdapter:
    """How a data source plugs into the model: ``kind`` (``lm``), the model
    fields it pins, how a default config derives from model/train, and the
    mismatch check."""
    kind: str
    model_overrides: Callable[[Any], Dict[str, Any]]
    derive: Callable[..., Any]
    validate: Callable[[Any, Any, int, int], List[str]]
    finalize: Optional[Callable[..., Any]] = None


@dataclasses.dataclass(frozen=True)
class SourceEntry:
    """One registered workload: config type + source constructor + task hookup."""
    name: str
    config_cls: type
    build: Callable[[Any], DataSourceBase]
    task: TaskAdapter


_SOURCES: Registry = Registry(
    "data source", not_ported=("synthetic_classification", "synthetic_vision"))


def register_source(entry: SourceEntry, *, overwrite: bool = False) -> SourceEntry:
    for other in _SOURCES.values():
        if other.name != entry.name and other.config_cls is entry.config_cls:
            raise ValueError(
                f"config class {entry.config_cls.__name__} already tags "
                f"source '{other.name}' — one config class per source")
    return _SOURCES.register(entry.name, entry, overwrite=overwrite)


def get_source(name: str) -> SourceEntry:
    return _SOURCES.get(name)


def available_sources() -> Tuple[str, ...]:
    return _SOURCES.available()


def entry_for_config(dcfg: Any) -> SourceEntry:
    for entry in _SOURCES.values():
        if type(dcfg) is entry.config_cls:
            return entry
    raise KeyError(f"no registered data source owns config type "
                   f"{type(dcfg).__name__} (available: {available_sources()})")


def source_name_of(dcfg: Any) -> str:
    return entry_for_config(dcfg).name


def derive_config(name: str, mcfg: Any, *, batch: int, seq: int, seed: int) -> Any:
    return get_source(name).task.derive(mcfg, batch=batch, seq=seq, seed=seed)


def finalize_config(dcfg: Any, mcfg: Any, *, batch: int, seq: int, seed: int) -> Any:
    entry = entry_for_config(dcfg)
    if entry.task.finalize is None:
        return dcfg
    return entry.task.finalize(dcfg, mcfg, batch=batch, seq=seq, seed=seed)


def _lm_derive(mcfg, *, batch: int, seq: int, seed: int) -> DataConfig:
    return DataConfig(vocab_size=mcfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed)


def _lm_validate(dcfg: DataConfig, mcfg, batch: int, seq: int) -> List[str]:
    return [
        f"data.{k}={got} != {want} ({src})"
        for k, got, want, src in [
            ("global_batch", dcfg.global_batch, batch, "train.batch"),
            ("seq_len", dcfg.seq_len, seq, "train.seq"),
            ("vocab_size", dcfg.vocab_size, mcfg.vocab_size, "model vocab"),
        ] if got != want]


SYNTHETIC_LM = register_source(SourceEntry(
    "synthetic_lm", DataConfig, SyntheticLM,
    TaskAdapter(kind="lm", model_overrides=lambda dcfg: {},
                derive=_lm_derive, validate=_lm_validate)))
