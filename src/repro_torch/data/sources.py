"""Task/data-source registry: named training workloads behind one protocol.

A registered :class:`SourceEntry` pairs a config dataclass (the ``data``
section of an ``ExperimentConfig``), a function that builds the source, and
a task adapter. The three workloads of the JAX package, in its order, each
``batch_at(step)`` byte-identical to the JAX source's:

  * ``synthetic_lm``             — Markov-over-clusters token stream
  * ``synthetic_classification`` — Gaussian-mixture features with Zipf class
                                   imbalance and label noise, spread over
                                   ``frames`` positions (``frame_embeds``,
                                   the ``audio_frames`` frontend)
  * ``synthetic_vision``         — class-conditioned gratings, patchified
                                   (``patch_embeds`` plus a class-query
                                   token, the ``vision_patches`` frontend)

Every source emits a layout the model consumes (``tokens`` |
``frame_embeds`` | ``patch_embeds`` + ``labels``); the adapters of the two
classification sources pin the model's vocabulary to the class count and
its frontend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.pipeline import (ArraySpec, DataConfig, DataSourceBase, SyntheticLM,
                                       zipf_class_probs)
from repro_torch.registry import Registry


@dataclasses.dataclass(frozen=True)
class TaskAdapter:
    """How a data source plugs into the model: ``kind`` (``lm`` → perplexity,
    ``classification`` → accuracy), the model fields it pins, how a default
    config derives from model/train, how an explicit config's sentinel
    fields are filled (``finalize``), and the mismatch check."""
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


_SOURCES: Registry = Registry("data source")


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


def shard_for_backend(dcfg: Any, backend: Any) -> Any:
    """This process's host-shard view of a rank-agnostic ``data`` section.

    Every source config carries ``num_hosts``/``host_index``; the backend's
    ``data_shard()`` (process count, process index) fills them at build
    time only, so that the stored section stays rank-agnostic: every process
    hashes alike and checkpoints restore on any topology. Per-global-example
    seeding makes the union of the shards byte-identical to one host's."""
    num_hosts, host_index = backend.data_shard()
    if (num_hosts, host_index) == (dcfg.num_hosts, dcfg.host_index):
        return dcfg
    if dcfg.global_batch % num_hosts != 0:
        raise ValueError(
            f"global batch {dcfg.global_batch} does not divide over "
            f"{num_hosts} processes — pick train.batch divisible by the "
            "process count")
    return dataclasses.replace(dcfg, num_hosts=num_hosts, host_index=host_index)


def _local_batch(cfg) -> int:
    if cfg.global_batch % cfg.num_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not divide "
                         f"over {cfg.num_hosts} hosts")
    return cfg.global_batch // cfg.num_hosts


# ---------------------------------------------------------------------------
# synthetic_lm
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# shared plumbing of the classification-style sources (``embed_dim`` and
# ``global_batch`` sentinels, a head pinned to the class count)
# ---------------------------------------------------------------------------

def _finalize_embed_batch(dcfg, mcfg, *, batch: int, seq: int, seed: int):
    """Fill the ``embed_dim``/``global_batch`` = 0 sentinels from
    model/train; identity when both are explicit."""
    repl: Dict[str, Any] = {}
    if dcfg.embed_dim <= 0:
        repl["embed_dim"] = mcfg.d_model
    if dcfg.global_batch <= 0:
        repl["global_batch"] = batch
    return dataclasses.replace(dcfg, **repl) if repl else dcfg


def _validate_embed_batch(dcfg, mcfg, batch: int) -> List[str]:
    return [
        f"data.{k}={got} != {want} ({src})"
        for k, got, want, src in [
            ("global_batch", dcfg.global_batch, batch, "train.batch"),
            ("embed_dim", dcfg.embed_dim, mcfg.d_model, "model d_model"),
            ("num_classes", dcfg.num_classes, mcfg.vocab_size,
             "model vocab (task-pinned)"),
        ] if got != want]


# ---------------------------------------------------------------------------
# synthetic_classification
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClassificationConfig:
    """Gaussian-mixture classification stream (the paper's CIFAR/IMDB analog
    as an infinite per-example-seeded stream). ``imbalance`` is a Zipf skew
    over classes and ``label_noise`` the fraction of flipped labels. The
    features are spread over ``frames`` sequence positions, each a
    zero-padded chunk of the feature vector. ``embed_dim``/``global_batch``
    of 0 mean "derive from model/train"."""
    num_classes: int = 10
    feature_dim: int = 64
    frames: int = 4                 # sequence positions the features span
    embed_dim: int = 0              # model d_model; 0 = derive
    class_sep: float = 2.0          # center scale (separability)
    noise: float = 0.8              # within-cluster std, × per-class scale
    label_noise: float = 0.02       # fraction of labels flipped
    imbalance: float = 0.0          # Zipf exponent over classes (0 = uniform)
    global_batch: int = 0           # 0 = derive from train.batch
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def local_batch(self) -> int:
        return _local_batch(self)

    @property
    def chunk(self) -> int:
        return math.ceil(self.feature_dim / self.frames)


class SyntheticClassificationSource(DataSourceBase):
    """Per-example-seeded Gaussian-mixture stream → model batches
    (``frame_embeds`` (B, frames, embed_dim) float32, ``labels`` (B, frames)
    int32)."""

    _STREAM = 0xC1A55

    def __init__(self, cfg: ClassificationConfig):
        if cfg.chunk > cfg.embed_dim:
            raise ValueError(
                f"feature chunk {cfg.chunk} (feature_dim {cfg.feature_dim} "
                f"over {cfg.frames} frames) exceeds embed_dim {cfg.embed_dim}")
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        C, D = cfg.num_classes, cfg.feature_dim
        self.centers = root.normal(size=(C, D)) * cfg.class_sep
        self.scales = 0.5 + 1.5 * root.random(C)      # per-class difficulty
        self._class_cdf = np.cumsum(zipf_class_probs(C, cfg.imbalance))

    def spec(self) -> Dict[str, ArraySpec]:
        cfg = self.cfg
        B = cfg.local_batch
        return {"frame_embeds": ArraySpec((B, cfg.frames, cfg.embed_dim), np.dtype(np.float32)),
                "labels": ArraySpec((B, cfg.frames), np.dtype(np.int32))}

    def _example(self, step: int, gidx: int) -> Tuple[np.ndarray, int, int]:
        """(features, clean class, observed label) of one global example: a
        stream per example keeps the batch the same for any host count."""
        cfg = self.cfg
        g = np.random.default_rng((cfg.seed, self._STREAM, step, gidx))
        c = min(int(np.searchsorted(self._class_cdf, g.random())), cfg.num_classes - 1)
        x = self.centers[c] + g.normal(size=cfg.feature_dim) * cfg.noise * self.scales[c]
        y = int(g.integers(cfg.num_classes)) if g.random() < cfg.label_noise else c
        return x.astype(np.float32), c, y

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B = cfg.local_batch
        start = step * cfg.global_batch + cfg.host_index * B
        frames = np.zeros((B, cfg.frames, cfg.embed_dim), np.float32)
        labels = np.empty((B, cfg.frames), np.int32)
        chunk = cfg.chunk
        for i in range(B):
            x, _, y = self._example(step, start + i)
            padded = np.zeros(cfg.frames * chunk, np.float32)
            padded[:cfg.feature_dim] = x
            frames[i, :, :chunk] = padded.reshape(cfg.frames, chunk)
            labels[i, :] = y
        return {"frame_embeds": frames, "labels": labels}

    def classes_at(self, step: int) -> np.ndarray:
        """Clean class ids (before label noise) of the local batch."""
        cfg = self.cfg
        start = step * cfg.global_batch + cfg.host_index * cfg.local_batch
        return np.asarray([self._example(step, start + i)[1]
                           for i in range(cfg.local_batch)], np.int32)


def _classification_derive(mcfg, *, batch: int, seq: int, seed: int) -> ClassificationConfig:
    return _finalize_embed_batch(ClassificationConfig(seed=seed), mcfg,
                                 batch=batch, seq=seq, seed=seed)


def _classification_validate(dcfg: ClassificationConfig, mcfg, batch: int,
                             seq: int) -> List[str]:
    out = _validate_embed_batch(dcfg, mcfg, batch)
    if dcfg.chunk > max(dcfg.embed_dim, 1):
        out.append(f"data.feature_dim={dcfg.feature_dim} over "
                   f"{dcfg.frames} frames needs chunk {dcfg.chunk} "
                   f"> embed_dim {dcfg.embed_dim}")
    return out


SYNTHETIC_CLASSIFICATION = register_source(SourceEntry(
    "synthetic_classification", ClassificationConfig, SyntheticClassificationSource,
    TaskAdapter(kind="classification",
                model_overrides=lambda d: {"vocab_size": d.num_classes,
                                           "frontend": "audio_frames"},
                derive=_classification_derive, validate=_classification_validate,
                finalize=_finalize_embed_batch)))


# ---------------------------------------------------------------------------
# synthetic_vision
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VisionConfig:
    """Procedural vision stream: class-conditioned oriented gratings with
    per-class channel signatures, NHWC (``images_at``), patchified into the
    model's vision frontend (``patch_embeds`` plus one class-query token).
    ``embed_dim``/``global_batch`` of 0 mean "derive from model/train"."""
    num_classes: int = 10
    image_size: int = 16
    channels: int = 3
    patch_size: int = 4
    embed_dim: int = 0              # model d_model; 0 = derive
    noise: float = 0.3              # additive pixel noise std
    label_noise: float = 0.0
    imbalance: float = 0.0
    global_batch: int = 0           # 0 = derive from train.batch
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def local_batch(self) -> int:
        return _local_batch(self)

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is not a multiple of "
                             f"patch_size {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


class SyntheticVisionSource(DataSourceBase):
    """Class-conditioned gratings → NHWC images → patchified batches
    (``patch_embeds`` (B, P, embed_dim) float32, ``tokens`` (B, 1) the class
    query, ``labels`` (B, 1))."""

    _STREAM = 0xF1E1D

    def __init__(self, cfg: VisionConfig):
        if cfg.patch_dim > cfg.embed_dim:
            raise ValueError(f"patch_dim {cfg.patch_dim} exceeds embed_dim {cfg.embed_dim}")
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        C = cfg.num_classes
        # per-class grating signature: orientation, frequency, channel mix
        self.angles = np.pi * np.arange(C) / C
        self.freqs = 1.0 + (np.arange(C) % 4)
        self.channel_mix = 0.25 + 0.75 * root.random((C, cfg.channels))
        self._class_cdf = np.cumsum(zipf_class_probs(C, cfg.imbalance))
        grid = (np.arange(cfg.image_size) + 0.5) / cfg.image_size
        self._yy, self._xx = np.meshgrid(grid, grid, indexing="ij")

    def spec(self) -> Dict[str, ArraySpec]:
        cfg = self.cfg
        B = cfg.local_batch
        return {"patch_embeds": ArraySpec((B, cfg.num_patches, cfg.embed_dim),
                                          np.dtype(np.float32)),
                "tokens": ArraySpec((B, 1), np.dtype(np.int32)),
                "labels": ArraySpec((B, 1), np.dtype(np.int32))}

    def _example(self, step: int, gidx: int) -> Tuple[np.ndarray, int, int]:
        """(image HWC, clean class, observed label) of one global example."""
        cfg = self.cfg
        g = np.random.default_rng((cfg.seed, self._STREAM, step, gidx))
        c = min(int(np.searchsorted(self._class_cdf, g.random())), cfg.num_classes - 1)
        phase = g.random() * 2.0 * np.pi
        wave = np.cos(self.angles[c]) * self._xx + np.sin(self.angles[c]) * self._yy
        base = np.sin(2.0 * np.pi * self.freqs[c] * wave + phase)
        img = base[..., None] * self.channel_mix[c][None, None, :]
        img = img + cfg.noise * g.normal(size=(cfg.image_size, cfg.image_size, cfg.channels))
        y = int(g.integers(cfg.num_classes)) if g.random() < cfg.label_noise else c
        return img.astype(np.float32), c, y

    def _patchify(self, img: np.ndarray) -> np.ndarray:
        """(H, W, C) → (P, patch_size²·C), patches in row-major grid order."""
        p = self.cfg.patch_size
        n = self.cfg.image_size // p
        patches = img.reshape(n, p, n, p, self.cfg.channels)
        return patches.transpose(0, 2, 1, 3, 4).reshape(self.cfg.num_patches,
                                                        self.cfg.patch_dim)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B = cfg.local_batch
        start = step * cfg.global_batch + cfg.host_index * B
        embeds = np.zeros((B, cfg.num_patches, cfg.embed_dim), np.float32)
        labels = np.empty((B, 1), np.int32)
        for i in range(B):
            img, _, y = self._example(step, start + i)
            embeds[i, :, :cfg.patch_dim] = self._patchify(img)
            labels[i, 0] = y
        return {"patch_embeds": embeds,
                "tokens": np.zeros((B, 1), np.int32),          # class-query token
                "labels": labels}

    def images_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Raw (B, H, W, C) images and clean class ids of the local batch."""
        cfg = self.cfg
        start = step * cfg.global_batch + cfg.host_index * cfg.local_batch
        out = [self._example(step, start + i) for i in range(cfg.local_batch)]
        return (np.stack([img for img, _, _ in out]),
                np.asarray([c for _, c, _ in out], np.int32))


def _vision_derive(mcfg, *, batch: int, seq: int, seed: int) -> VisionConfig:
    return _finalize_embed_batch(VisionConfig(seed=seed), mcfg, batch=batch, seq=seq,
                                 seed=seed)


def _vision_validate(dcfg: VisionConfig, mcfg, batch: int, seq: int) -> List[str]:
    out = _validate_embed_batch(dcfg, mcfg, batch)
    if dcfg.patch_dim > max(dcfg.embed_dim, 1):
        out.append(f"data.patch_size={dcfg.patch_size} needs patch_dim "
                   f"{dcfg.patch_dim} > embed_dim {dcfg.embed_dim}")
    return out


SYNTHETIC_VISION = register_source(SourceEntry(
    "synthetic_vision", VisionConfig, SyntheticVisionSource,
    TaskAdapter(kind="classification",
                model_overrides=lambda d: {"vocab_size": d.num_classes,
                                           "frontend": "vision_patches",
                                           "num_patches": d.num_patches},
                derive=_vision_derive, validate=_vision_validate,
                finalize=_finalize_embed_batch)))
