"""The assigned input-shape cells and their abstract inputs — the twin of
the JAX package's ``launch/specs.py``.

Every (arch × shape) cell resolves to the step function it runs and its
arguments as fake tensors (``torch._subclasses.fake_tensor``: shape, dtype
and device, no storage): the train state, the parameters, the decode cache
and the batch. ``launch/dryrun.py`` runs the step on them once.

Abstract arguments live on fake ``cuda:0`` tensors, which need PyTorch
with CUDA (in a CPU-only build the autograd engine has no CUDA device guard
for a fake CUDA tensor). There a request for ``cuda:0`` raises, unless the
caller asks for the CPU stand-in by name (``stand_in=True``): fake CPU
tensors, the step run inside ``kernels/build.py`` ``as_card`` so that it
takes the card's routes. The stand-in differs from the card in what a
CUDA tensor adds by itself (``torch.utils.checkpoint`` saving the CUDA RNG
state of each block; the refresh's rank candidates copied to the device):
a few aten ops and bytes, no FLOPs, no memory.

Under the ``fsdp`` preset a train cell's state is one device's: the
parameters are its shards as ``train_state_logical``'s ``params`` entry
(``models/model.py`` ``params_logical``) places them and the moments
mirror them, on a mesh that stands in for the ranks (``launch/dryrun.py``
``RecordingMesh``); the rest is replicated. A prefill or decode cell's
parameters are one device's shards the same way, and its decode cache is
one device's part of it, each leaf cut by ``cache_logical`` (the twin of
JAX's: ``models/decode.py`` ``CACHE_LOGICAL``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as config_lib
from repro_torch.data import sources as data_sources
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps as steps_lib
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import OptimizerConfig
from repro_torch.selection.base import GraftConfig

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# long_500k requires sub-quadratic sequence handling: only the recurrent /
# bounded-window archs run it
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "hymba-1.5b")

# per-shape logical-rule overrides
SHAPE_RULES: Dict[str, Dict[str, Any]] = {
    "train_4k": {},
    "prefill_32k": {},
    "decode_32k": {"act_kv_seq": "model", "act_kv_heads": None},
    "long_500k": {"act_kv_seq": ("data", "model"), "act_kv_heads": None},
}

# named sharding presets: "fsdp" (pure ZeRO-3: batch over every axis, no
# tensor or sequence parallelism on activations, weights sharded and
# gathered just in time; the port's sharded step runs it) and "head_tp"
# (head-parallel attention, which the port refuses)
RULE_PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    "fsdp": {
        "act_batch": ("pod", "data", "model"),
        "act_res_seq": None, "act_q_seq": None, "act_heads": None,
        "act_kv_heads": None, "act_mlp": None, "act_vocab": None,
        "act_experts": "model",
    },
    "head_tp": {"act_q_seq": None, "act_kv_heads": "model"},
}

# archs whose optimizer must use factored second moments to fit
_ADAFACTOR_ARCHS = ("kimi-k2-1t-a32b",)


class TensorSpec(NamedTuple):
    """Shape and dtype of one input (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cell_is_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("full-attention KV over 524288 positions — "
                       "sub-quadratic archs only (DESIGN.md §4)")
    return True, ""


def all_cells():
    for arch in config_lib.CANONICAL_IDS:
        for shape in SHAPES:
            yield arch, shape


def default_train_config(arch: str, use_graft: bool = True,
                         batch: int = 256, feature_mode: str = "svd",
                         grad_mode: str = "probe") -> steps_lib.TrainConfig:
    opt_name = "adafactor" if arch in _ADAFACTOR_ARCHS else "adamw"
    schedule = "wsd" if arch == "minicpm-2b" else "cosine"
    rset = tuple(r for r in (16, 32, 64, 128) if r <= batch // 2)
    if not rset:
        rset = (max(1, batch // 4), max(2, batch // 2))
    graft = GraftConfig(rset=rset, eps=0.25, refresh_every=1,
                        feature_mode=feature_mode,
                        grad_mode=grad_mode) if use_graft else None
    return steps_lib.TrainConfig(
        optimizer=OptimizerConfig(name=opt_name, schedule=schedule,
                                  total_steps=10_000, warmup_steps=200,
                                  learning_rate=3e-4),
        graft=graft)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

_NP_TO_TORCH = {"float32": torch.float32, "int32": torch.int32, "int64": torch.int64,
                "bfloat16": torch.bfloat16, "float16": torch.float16}


def source_batch_specs(source) -> Dict[str, TensorSpec]:
    """The batch layout straight from a data source's ``spec()``."""
    return {k: TensorSpec(tuple(s.shape), _NP_TO_TORCH[str(s.dtype)])
            for k, s in source.spec().items()}


def batch_specs(mcfg: model_lib.ModelConfig, batch: int, seq: int) -> Dict[str, TensorSpec]:
    """A batch of the model's input (``models/model.py`` ``embed_inputs``):
    frames (audio, or the ``audio_frames`` frontend), patches then tokens
    (vlm, or ``vision_patches``), or tokens; labels."""
    i32 = torch.int32
    kind = model_lib.input_kind(mcfg)
    if kind == "frames":
        return {"frame_embeds": TensorSpec((batch, seq, mcfg.d_model), mcfg.dtype),
                "labels": TensorSpec((batch, seq), i32)}
    if kind == "patches":
        s_text = seq - mcfg.num_patches
        return {"patch_embeds": TensorSpec((batch, mcfg.num_patches, mcfg.d_model), mcfg.dtype),
                "tokens": TensorSpec((batch, s_text), i32),
                "labels": TensorSpec((batch, s_text), i32)}
    return {"tokens": TensorSpec((batch, seq), i32),
            "labels": TensorSpec((batch, seq), i32)}


def abstract_device(device="cuda:0", stand_in: bool = False) -> Tuple[torch.device, bool]:
    """(the device fake tensors take, whether they are the CPU stand-in for
    the card). ``stand_in``: fake CPU tensors taking the card's routes, for
    a ``cuda`` request only. Without it a ``cuda`` request where PyTorch has
    no CUDA raises."""
    device = torch.device(device)
    if stand_in:
        if device.type != "cuda":
            raise ValueError(f"the CPU stand-in takes the card's routes: it stands for a "
                             f"cuda device, not {device}")
        return torch.device("cpu"), True
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fake cuda tensors need PyTorch with CUDA; ask for the CPU "
                           "stand-in (stand_in=True, the dry run's --cpu-stand-in) to take "
                           "the card's routes on fake CPU tensors")
    if device.type == "cuda":
        return torch.device("cuda", device.index or 0), False
    return device, False


def cache_logical(cache) -> Dict[str, Any]:
    """The logical-axis tree of a decode cache (``models/decode.py``): JAX's
    ``cache_logical``, each layer of the port's list with the tuple of the
    JAX leaf stacked on ``layers`` without that axis, ``index`` ``()``; the
    port's ``layout`` is no array and has none."""
    def leaf(name, x):
        if isinstance(x, dict):
            return {k: leaf(k, v) for k, v in x.items()}
        if isinstance(x, list):
            return [leaf(name, v) for v in x]
        return decode_lib.CACHE_LOGICAL.get(name, tuple(None for _ in x.shape))
    return {k: () if k == "index" else leaf(k, v) for k, v in cache.items() if k != "layout"}


def fake_batch(specs: Dict[str, TensorSpec], device) -> Dict[str, torch.Tensor]:
    """Fake tensors of the specs (inside a ``FakeTensorMode``)."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device=device) for k, s in specs.items()}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode
    mcfg: model_lib.ModelConfig
    step_fn: Any                   # the step over abstract_args
    abstract_args: Tuple[Any, ...]
    fake_mode: FakeTensorMode      # the mode that owns abstract_args
    device: torch.device           # the device of the fake args
    as_card: bool                  # the CPU stand-in: fake CPU tensors on the card's routes
    batch: int                     # this device's rows
    tcfg: Optional[steps_lib.TrainConfig] = None


def _dry_run_config(tcfg: steps_lib.TrainConfig) -> steps_lib.TrainConfig:
    """The train config a dry run steps: the divergence sentinel off (a host
    read of two scalars, with no device memory)."""
    return dataclasses.replace(tcfg, sentinel=False)


def build_cell(arch: str, shape: str, *, variant: str = "graft",
               smoke: bool = False, feature_mode: str = "svd",
               grad_mode: str = "probe", data_source: Optional[str] = None,
               batch_shards: int = 1, backend=None, device="cuda:0",
               stand_in: bool = False, mesh=None, rules=None) -> Cell:
    """The abstract arguments and step of one cell.

    ``variant``: 'graft' | 'baseline' | 'subset' | 'select' (train cells).
    ``smoke``: the reduced config at ``B // 64`` (at least 4) rows and at
    most 64 positions. ``batch_shards``: the devices the batch splits over
    (the state is replicated on each); the args are one device's, and
    ``backend`` (the dry run's recording backend) carries the step's
    collectives. The global batch sizes the GRAFT state and ``rset``, as
    in JAX. ``stand_in``: see ``abstract_device``. ``mesh`` and
    ``rules`` (a sharded cell): the state is one device's shards on
    ``mesh`` (whose collectives the step calls), built and stepped under
    ``sharding_rules(mesh, rules)``; a serve cell's cache is the device's
    part of it (``serve_cell``).
    ``data_source``: a registered source, whose task pins the model's
    fields (a frontend: a serve cell's prompts are then its frames, or its
    patches and tokens) and, for a train cell, whose ``spec()`` gives the
    batch. The train step runs
    without the sentinel. Not smoke, attention runs in chunks of 1024 and
    the loss in 512, JAX's production defaults."""
    ok, why = cell_is_supported(arch, shape)
    if not ok:
        raise ValueError(f"cell {arch}×{shape} unsupported: {why}")
    info = SHAPES[shape]
    overrides: Dict[str, Any] = {}
    if not smoke:
        overrides["attn_chunk"] = 1024
        overrides["loss_chunk"] = 512
    mcfg = (config_lib.get_smoke_config(arch, **overrides) if smoke
            else config_lib.get_config(arch, **overrides))

    B, S = info["batch"], info["seq"]
    if smoke:
        B, S = max(4, B // 64), min(S, 64)
    if B % batch_shards:
        raise ValueError(f"batch {B} does not split over {batch_shards} devices")
    local = B // batch_shards
    entry = None
    if data_source is not None and data_source != "synthetic_lm":
        entry = data_sources.get_source(data_source)
        dcfg = entry.task.derive(mcfg, batch=local, seq=S, seed=0)
        mcfg = dataclasses.replace(mcfg, **entry.task.model_overrides(dcfg))
    dev, as_card = abstract_device(device, stand_in)
    fake_mode = FakeTensorMode()
    common = dict(fake_mode=fake_mode, device=dev, as_card=as_card, batch=local)

    if info["kind"] == "train":
        use_graft = variant in ("graft", "subset", "select")
        tcfg = _dry_run_config(default_train_config(
            arch, use_graft=use_graft, batch=B, feature_mode=feature_mode, grad_mode=grad_mode))
        specs = (batch_specs(mcfg, local, S) if entry is None
                 else source_batch_specs(entry.build(dcfg)))
        sharded = sh.sharding_rules(mesh, rules) if mesh is not None else contextlib.nullcontext()
        kind = variant if variant in ("graft", "baseline", "subset", "select") else None
        with fake_mode, sharded:
            state = steps_lib.state_for_model(mcfg, tcfg, model_lib.Model(mcfg, dev), B)
            batch = fake_batch(specs, dev)
            step = steps_lib.make_train_step(mcfg, tcfg, kind=kind, backend=backend)
        return Cell(arch, shape, "train", mcfg, step, (state, batch), tcfg=tcfg, **common)

    if mesh is None:
        with fake_mode:
            params = model_lib.Model(mcfg, dev)
        return serve_cell(mcfg, info["kind"], local, S, params, arch=arch, shape=shape,
                          **common)
    with fake_mode, sh.sharding_rules(mesh, rules):
        params = model_lib.shard_model(model_lib.Model(mcfg, dev), mesh, rules)
    return serve_cell(mcfg, info["kind"], B, S, params, mesh=mesh, rules=rules, arch=arch,
                      shape=shape, **common)


def serve_cell(mcfg, kind: str, rows: int, max_seq: int, params, *, fake_mode, device,
               as_card: bool, batch: int, seq: Optional[int] = None, mesh=None,
               rules=None, arch: Optional[str] = None, shape: str = "serve") -> Cell:
    """A prefill (``kind`` "prefill": ``rows`` prompts of ``seq`` positions,
    ``max_seq`` by default, into a cache of ``max_seq``) or decode ("decode":
    one token a row against a cache of ``max_seq`` at index 0) step over
    ``params`` (fake tensors of ``fake_mode``). ``rows`` is the whole batch
    and ``batch`` the device's rows of it: the prompts and the tokens are
    its rows'. With ``mesh`` and ``rules`` the step runs under
    ``sharding_rules(mesh, rules)``: ``params`` are one device's shards and
    the cache is the device's part (``sharding.cache_layout``)."""
    sharded = (lambda: sh.sharding_rules(mesh, rules)) if mesh is not None \
        else contextlib.nullcontext
    common = dict(fake_mode=fake_mode, device=device, as_card=as_card, batch=batch)
    name = arch or mcfg.name
    if kind == "prefill":
        with fake_mode:
            prompts = fake_batch(batch_specs(mcfg, batch, seq or max_seq), device)

        def prefill(params, b):
            with sharded():
                return steps_lib.prefill_step(mcfg, params, b, max_seq,
                                              sh.cache_layout(rows, max_seq))

        return Cell(name, shape, "prefill", mcfg, prefill, (params, prompts), **common)

    with fake_mode, sharded():
        cache = decode_lib.init_cache(mcfg, rows, max_seq, device)
        tokens = torch.empty((batch, 1), dtype=torch.int32, device=device)

    def decode(params, cache, tok):
        with sharded():
            return steps_lib.decode_step(mcfg, params, cache, tok)

    return Cell(name, shape, "decode", mcfg, decode, (params, cache, tokens), **common)


def experiment_cell(cfg, *, device="cuda:0", stand_in: bool = False, mesh=None,
                    rules=None, backend=None,
                    batch: Optional[Dict[str, TensorSpec]] = None) -> Cell:
    """One step of an ``api.ExperimentConfig`` (its model, train config and
    data source's batch) on fake tensors: the step ``Trainer.fit`` runs
    first, a refresh step under GRAFT, without the sentinel. With ``mesh``
    and ``rules`` (a preset's): one device's step of a sharded fleet,
    its rows the global batch's share, its collectives on ``mesh`` and
    ``backend``. ``batch``: the global batch's specs where the data
    source's are not the model's input (a frontend's frames, or its
    patches and tokens: ``batch_specs``)."""
    mcfg, tcfg, data = cfg.build()
    tcfg = _dry_run_config(tcfg)
    dev, as_card = abstract_device(device, stand_in)
    fake_mode = FakeTensorMode()
    specs = source_batch_specs(data) if batch is None else dict(batch)
    rows = cfg.train.batch
    sharded = contextlib.nullcontext()
    if mesh is not None:
        sharded = sh.sharding_rules(mesh, rules)
        n = mesh.size(sh.split_axes("act_batch", rows, mesh, rules))
        specs = {k: TensorSpec((s.shape[0] // n,) + tuple(s.shape[1:]), s.dtype)
                 for k, s in specs.items()}
    with fake_mode, sharded:
        state = steps_lib.state_for_model(mcfg, tcfg, model_lib.Model(mcfg, dev),
                                          cfg.train.batch)
        batch = fake_batch(specs, dev)
        step = steps_lib.make_run_step(mcfg, tcfg, backend=backend)
    return Cell(mcfg.name, f"{cfg.train.batch}x{cfg.train.seq}", "train", mcfg,
                step, (state, batch), fake_mode=fake_mode,
                device=dev, as_card=as_card, batch=next(iter(specs.values())).shape[0],
                tcfg=tcfg)


def input_specs(arch: str, shape: str = "train_4k"):
    """The model inputs of a cell: the batch's specs for the train and
    prefill shapes, the (params, cache, tokens) fake tensors of
    ``build_cell`` for the decode shapes."""
    info = SHAPES[shape]
    mcfg = config_lib.get_config(arch)
    if info["kind"] in ("train", "prefill"):
        return batch_specs(mcfg, info["batch"], info["seq"])
    return build_cell(arch, shape, variant="serve").abstract_args
