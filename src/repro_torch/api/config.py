"""Declarative experiment configuration — the same schema, overrides and
``config_hash`` as the JAX package's ``ExperimentConfig``, so one
experiment has one name in both packages.

Sections: ``model`` (architecture id, smoke vs full, field overrides),
``train`` (loop knobs), ``graft`` (selection, or ``None`` for the
full-batch baseline), ``data`` (a registry-tagged section; ``None`` derives
``synthetic_lm`` from model + train), ``optimizer`` (``total_steps``/
``warmup_steps`` of 0 derive from ``train.steps``) and ``backend`` (only
``local`` is ported; the section is hash-neutral).

The device a run uses is not part of the config: ``Trainer(cfg, device=)``
picks it, so a CPU run and a GPU run of one config share a hash.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, Optional

from repro_torch.data import DataConfig
from repro_torch.data import sources as data_sources
from repro_torch.optim import OptimizerConfig
from repro_torch.selection.base import GraftConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Declarative model selection: an architecture-registry id plus
    optional field overrides, resolved through ``repro_torch.configs``."""
    arch: str = "minicpm-2b"
    smoke: bool = True                  # smoke (CPU-sized) vs published config
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, extra_overrides: Optional[Dict[str, Any]] = None):
        from repro_torch import configs as config_lib
        ov = dict(self.overrides)
        if extra_overrides:
            ov.update(extra_overrides)
        return (config_lib.get_smoke_config(self.arch, **ov) if self.smoke
                else config_lib.get_config(self.arch, **ov))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Loop-level training knobs — the JAX package's fields, so configs
    round-trip and hash alike. The run-environment knobs below ``microbatches``
    are excluded from ``config_hash``; the port's ``Trainer`` refuses the
    ones whose machinery is not ported yet."""
    steps: int = 100
    batch: int = 16
    seq: int = 64
    seed: int = 0
    sampler: str = "graft"
    probe_positions: int = 0            # 0 = derive min(64, seq)
    microbatches: int = 1
    # --- run environment (excluded from config_hash) ---
    log_every: int = 10
    eval_every: int = 0
    sync_eval: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    metrics_path: Optional[str] = None
    metrics_flush_every: int = 20
    history_cap: int = 0
    stop_after: Optional[int] = None
    device_timing: bool = True
    audit: bool = False
    sentinel: bool = True               # divergence sentinel (bit-neutral
                                        # on healthy steps)
    spike_z: float = 6.0
    bad_step_patience: int = 10
    device_timeout_s: float = 60.0
    fault_plan: Optional[str] = None


_NONSEMANTIC_TRAIN_FIELDS = ("log_every", "eval_every", "sync_eval",
                             "checkpoint_dir", "checkpoint_every",
                             "metrics_path", "metrics_flush_every",
                             "history_cap", "stop_after", "device_timing",
                             "audit", "sentinel", "spike_z",
                             "bad_step_patience", "device_timeout_s",
                             "fault_plan")


@dataclasses.dataclass(frozen=True)
class LocalBackendConfig:
    """Single-process execution (the only backend the port has)."""


_SECTION_TYPES = {
    "model": ModelConfig,
    "train": TrainConfig,
    "graft": GraftConfig,
    "data": DataConfig,      # the DEFAULT source; actual class is registry-tagged
    "optimizer": OptimizerConfig,
    "backend": LocalBackendConfig,
}
_OPTIONAL_SECTIONS = ("graft", "data", "backend")


def _backend_config(kind: str) -> LocalBackendConfig:
    if kind != "local":
        raise NotImplementedError(
            f"backend '{kind}' is not ported to repro_torch yet; only 'local' "
            "is (see ROADMAP.md)")
    return LocalBackendConfig()


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    graft: Optional[GraftConfig] = GraftConfig(
        rset=(2, 4, 8), eps=0.25, refresh_every=5, grad_mode="probe")
    data: Optional[Any] = None
    optimizer: OptimizerConfig = OptimizerConfig(
        name="adamw", learning_rate=3e-4, schedule="cosine",
        total_steps=0, warmup_steps=0)
    backend: Optional[Any] = None

    # ------------------------------------------------------------------
    def finalized(self) -> "ExperimentConfig":
        """Materialize every derived field. Idempotent."""
        train = self.train
        if train.probe_positions <= 0:
            train = dataclasses.replace(train, probe_positions=min(64, train.seq))
        opt = self.optimizer
        if opt.total_steps <= 0:
            opt = dataclasses.replace(opt, total_steps=train.steps)
        if opt.warmup_steps <= 0:
            opt = dataclasses.replace(opt, warmup_steps=max(train.steps // 20, 1))
        data = self.data
        if data is None:
            data = data_sources.derive_config(
                "synthetic_lm", self.model.build(), batch=train.batch,
                seq=train.seq, seed=train.seed)
        elif data_sources.entry_for_config(data).task.finalize is not None:
            data = data_sources.finalize_config(
                data, self.model.build(), batch=train.batch, seq=train.seq,
                seed=train.seed)
        return dataclasses.replace(self, train=train, optimizer=opt, data=data)

    def build(self):
        """→ (model config, step-level TrainConfig, data source)."""
        from repro_torch.launch import steps as steps_lib
        cfg = self.finalized()
        tr, d = cfg.train, cfg.data
        entry = data_sources.entry_for_config(d)
        mcfg = cfg.model.build(extra_overrides=entry.task.model_overrides(d))
        mismatches = entry.task.validate(d, mcfg, tr.batch, tr.seq)
        if mismatches:
            raise ValueError(
                f"data section ({entry.name}) disagrees with model/train: "
                + "; ".join(mismatches)
                + " — fix the fields, or re-derive by putting model/train "
                f"overrides BEFORE data.source={entry.name}")
        sampler = tr.sampler
        if cfg.graft is not None and cfg.graft.streaming and sampler == "graft":
            sampler = "streaming_graft"
        tcfg = steps_lib.TrainConfig(
            optimizer=cfg.optimizer, graft=cfg.graft, sampler=sampler,
            probe_positions=tr.probe_positions, microbatches=tr.microbatches,
            sentinel=tr.sentinel, spike_z=tr.spike_z)
        return mcfg, tcfg, entry.build(d)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in _SECTION_TYPES:
            section = getattr(self, name)
            out[name] = None if section is None else _section_to_dict(section)
        if out["data"] is not None:
            name = data_sources.source_name_of(self.data)
            if name != "synthetic_lm":
                out["data"]["source"] = name
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        kwargs: Dict[str, Any] = {}
        for name, typ in _SECTION_TYPES.items():
            raw = d.get(name)
            if raw is None:
                if name in _OPTIONAL_SECTIONS:
                    kwargs[name] = None
                    continue
                raise KeyError(f"experiment dict missing section '{name}'")
            if name == "data":
                kwargs[name] = _data_section_from_dict(raw)
            elif name == "backend":
                kwargs[name] = _backend_section_from_dict(raw)
            else:
                kwargs[name] = _section_from_dict(typ, raw)
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1) + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------------------
    def config_hash(self) -> str:
        """Stable 12-hex digest over the trajectory-shaping fields of the
        finalized config — equal to the JAX package's for the same config."""
        d = self.finalized().to_dict()
        for f in _NONSEMANTIC_TRAIN_FIELDS:
            d["train"].pop(f, None)
        d.pop("backend", None)
        if d.get("graft"):
            d["graft"].pop("overlap", None)
            streaming_on = (d["graft"].get("streaming")
                            or d["train"].get("sampler") == "streaming_graft")
            if not streaming_on:
                for f in ("streaming", "sketch_rows", "sketch_decay", "stream_mix"):
                    d["graft"].pop(f, None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def apply_overrides(self, pairs: Iterable[str]) -> "ExperimentConfig":
        """Apply flat ``section.field=value`` overrides (values parsed as
        JSON, falling back to string). ``graft=none`` / ``data=none`` clear
        an optional section; a ``graft.*`` override on a disabled section
        re-enables it from defaults first."""
        cfg = self
        for pair in pairs:
            if "=" not in pair:
                raise ValueError(f"override '{pair}' is not key=value")
            key, raw = pair.split("=", 1)
            cfg = _apply_one(cfg, key.strip(), raw.strip())
        return cfg


# ---------------------------------------------------------------------------
# (de)serialization helpers
# ---------------------------------------------------------------------------

def _section_to_dict(section) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(section):
        v = getattr(section, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def _data_section_from_dict(raw: Dict[str, Any]):
    raw = dict(raw)
    name = raw.pop("source", "synthetic_lm")
    return _section_from_dict(data_sources.get_source(name).config_cls, raw)


def _backend_section_from_dict(raw: Dict[str, Any]):
    raw = dict(raw)
    return _section_from_dict(type(_backend_config(raw.pop("kind", "local"))), raw)


def _section_from_dict(typ, raw: Dict[str, Any]):
    defaults = typ()
    names = {f.name for f in dataclasses.fields(typ)}
    unknown = set(raw) - names
    if unknown:
        raise KeyError(f"unknown {typ.__name__} field(s): {sorted(unknown)}")
    kwargs = {}
    for name, v in raw.items():
        if isinstance(v, list) and isinstance(getattr(defaults, name), tuple):
            v = tuple(v)
        kwargs[name] = v
    return typ(**kwargs)


def _parse_value(raw: str) -> Any:
    if raw.lower() in ("none", "null"):
        return None
    try:
        return json.loads(raw)
    except (ValueError, json.JSONDecodeError):
        return raw


def _coerce(value: Any, current: Any) -> Any:
    if isinstance(current, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(current, tuple) and isinstance(value, str):
        return tuple(_parse_value(v) for v in value.split(",") if v)
    if isinstance(current, bool) and isinstance(value, int) \
            and not isinstance(value, bool):
        return bool(value)
    if isinstance(current, float) and isinstance(value, int) \
            and not isinstance(value, bool):
        return float(value)
    return value


def _derive_data(cfg: ExperimentConfig, source: str):
    return data_sources.derive_config(
        source, cfg.model.build(), batch=cfg.train.batch, seq=cfg.train.seq,
        seed=cfg.train.seed)


def _apply_one(cfg: ExperimentConfig, key: str, raw: str) -> ExperimentConfig:
    value = _parse_value(raw)
    if "." not in key:                       # whole-section assignment
        if key not in _SECTION_TYPES:
            raise KeyError(f"unknown config section '{key}' "
                           f"(have {sorted(_SECTION_TYPES)})")
        if value is None:
            if key not in _OPTIONAL_SECTIONS:
                raise ValueError(f"section '{key}' cannot be disabled")
            return dataclasses.replace(cfg, **{key: None})
        if isinstance(value, dict):
            if key == "data":
                section = _data_section_from_dict(value)
            elif key == "backend":
                section = _backend_section_from_dict(value)
            else:
                section = _section_from_dict(_SECTION_TYPES[key], value)
            return dataclasses.replace(cfg, **{key: section})
        raise ValueError(f"override '{key}={raw}': expected none or a dict")

    section_name, field = key.split(".", 1)
    if section_name not in _SECTION_TYPES:
        raise KeyError(f"unknown config section '{section_name}' "
                       f"(have {sorted(_SECTION_TYPES)})")
    if (section_name, field) == ("data", "source"):
        if not isinstance(value, str):
            raise ValueError(f"data.source expects a registry name "
                             f"(have {data_sources.available_sources()})")
        if cfg.data is not None and data_sources.source_name_of(cfg.data) == value:
            return cfg
        return dataclasses.replace(cfg, data=_derive_data(cfg, value))
    if (section_name, field) == ("backend", "kind"):
        _backend_config(str(value))          # raises for anything but local
        return cfg
    section = getattr(cfg, section_name)
    if section is None:                      # re-enable optional section
        if section_name == "graft":
            section = ExperimentConfig().graft
        elif section_name == "backend":
            section = LocalBackendConfig()
        else:
            section = cfg.finalized().data
    typ = type(section) if section_name in ("data", "backend") \
        else _SECTION_TYPES[section_name]
    names = {f.name for f in dataclasses.fields(typ)}
    if field not in names:
        raise KeyError(f"unknown field '{field}' in section "
                       f"'{section_name}' (have {sorted(names)})")
    value = _coerce(value, getattr(section, field))
    new_section = dataclasses.replace(section, **{field: value})
    new_cfg = dataclasses.replace(cfg, **{section_name: new_section})
    return _refresh_derived(cfg, new_cfg, section_name, field)


def _refresh_derived(old: ExperimentConfig, new: ExperimentConfig,
                     section_name: str, field: str) -> ExperimentConfig:
    """Reset fields that were DERIVED on a finalized config (they still
    equal the old derivation) so ``finalized()`` re-derives them against
    the new values; explicitly-set fields are untouched."""
    if section_name != "optimizer":
        opt, repl = new.optimizer, {}
        if opt.total_steps in (0, old.train.steps):
            repl["total_steps"] = 0
        if opt.warmup_steps in (0, max(old.train.steps // 20, 1)):
            repl["warmup_steps"] = 0
        if repl:
            new = dataclasses.replace(new, optimizer=dataclasses.replace(opt, **repl))
    if (section_name, field) != ("train", "probe_positions") \
            and new.train.probe_positions in (0, min(64, old.train.seq)):
        new = dataclasses.replace(new, train=dataclasses.replace(
            new.train, probe_positions=0))
    if section_name != "data" and new.data is not None:
        source = data_sources.source_name_of(new.data)
        if new.data == _derive_data(old, source):
            new = dataclasses.replace(
                new, data=None if source == "synthetic_lm"
                else _derive_data(new, source))
    return new


def apply_overrides(cfg: ExperimentConfig, pairs: Iterable[str]) -> ExperimentConfig:
    return cfg.apply_overrides(pairs)
