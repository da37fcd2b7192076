"""The dry run: every (arch × input-shape) cell's step once on fake tensors
— the twin of the JAX package's ``launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k

Where the JAX dry run lowers and compiles each cell for a TPU mesh and asks
XLA's memory and cost analyses, eager PyTorch runs the step itself on fake
tensors (``torch._subclasses.fake_tensor``: shapes, dtypes and a device, no
storage, nothing computed), on one device of the mesh:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops
  (``aten_flops``), and each hand-written kernel's cost function, called by
  its wrapper's abstract launch (``kernels/build.py`` ``abstract``:
  ``kernel_flops``); ``flops`` is their sum.
* **Bytes**: every aten op's tensor inputs and outputs (views and
  allocations move none), plus the kernels' own reckoning.
* **Memory**: the storages alive while the step runs, each rounded up to
  the 512 bytes of the CUDA caching allocator's blocks and freed when the
  last tensor holding it goes (saved tensors and ``remat`` recompute behave
  as on the card): JAX's ``argument_size_in_bytes``,
  ``output_size_in_bytes`` (``alias_size_in_bytes`` of it shared with the
  arguments), ``temp_size_in_bytes`` (the peak beyond the arguments), and
  ``peak_bytes`` with ``fits`` against the H100's 80 GB. On the card's
  routes the peak adds cuBLAS's workspaces (``workspace_bytes``: 32 MiB
  for each of the forward's and the backward's threads that calls it).
* **Collectives**: a cell whose state stays replicated on every device
  (data parallel) splits the batch over the mesh axes that ``act_batch``
  maps to. A recording backend stands in for the processes:
  ``all_gather_rows`` and ``reduce_grads`` return fake tensors of the real
  shapes and add their operands' bytes under JAX's op names. Under
  ``fsdp`` (every arch; a MoE arch's train cells only) and under
  ``default`` (every cell but a MoE arch's serve cells) the state is one
  device's shards (``"state": "sharded"``) and a recording mesh stands in
  for the ranks: each weight's just-in-time gather, its gradient's
  reduce-scatter, the norm's psum and, under ``default``, the sequence's
  gathers and reduce-scatters and the vocabulary-parallel loss's pmax and
  psums, the RWKV mixes' and the SSM heads' heads and ``d_ff`` slices
  (and their decode states' heads), and a MoE layer's
  gathered rows and its combine's reduce-scatter
  return fake tensors of the real shapes and add their operands' bytes the
  same way. A prefill or
  decode cell's cache is one device's part of it (``specs.cache_logical``
  under the shape's ``SHAPE_RULES``: decode_32k's positions over
  ``"model"``), and the split-KV combine's pmax and psum and the gathered
  logits count too. Under
  ``remat="none"`` the gathered weights are saved for the backward, under
  ``full`` only the shards: the peak shows which. The other ``default``
  cells keep the state replicated and say why (``replicated_why``).

The cells take the card's routes: attention ``auto`` runs flash wherever
``analysis/smem.py`` ``flash_feasible`` admits the shape (the JAX dry run
compiles XLA's chunked path instead), and the refresh takes the
plain-PyTorch chain unless the train config sets ``use_pallas``. The
divergence sentinel is off (a host read, no device memory). Eager PyTorch
runs every layer, so the JAX run's L = p / 2p delta is not needed:
``--no-deltas`` is accepted and ``scaled`` equals ``full``. ``fsdp`` on a
MoE arch's serve cells (A14s), a MoE's chunk-major groups (A14c) and
``head_tp`` (head-parallel attention) raise ``ValueError`` with the
reason.

Fake tensors are ``cuda:0``'s, which needs PyTorch with CUDA. Where it has
none, ``--cpu-stand-in`` traces fake CPU tensors on the card's routes
(``specs.abstract_device``). Results go to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>__<variant>.json``, the
stand-in's to ``experiments/dryrun_torch/cpu_stand_in/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as config_lib
from repro_torch.backend.base import Backend
from repro_torch.data import sources as data_sources
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import build
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import AbstractMesh, make_mesh, make_production_mesh
from repro_torch.models.model import ShardedModel

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
STAND_IN_DIR = os.path.join(OUT_DIR, "cpu_stand_in")

DEVICE_BYTES = 80e9             # one H100's memory, the card a cell must fit
BLOCK_BYTES = 512               # the CUDA caching allocator rounds every block up to it
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_DEVICE = torch.ops.prim.device.default

# allocations: they move no bytes
_ALLOCATING = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"))
# PyTorch's cuBLAS workspace on sm_90 (``CUBLAS_WORKSPACE_CONFIG`` unset),
# one a thread that calls cuBLAS, held from its first call on: the
# forward's matmuls run on the caller's thread, the backward's (and a
# recompute's) on autograd's device thread
CUBLAS_WORKSPACE_BYTES = 32 << 20
_CUBLAS = frozenset(("mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
                     "_scaled_mm"))


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of nested dicts, lists, tuples, NamedTuples, modules and
    sharded models (their shards)."""
    if isinstance(tree, ShardedModel):
        tree = tree.model
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters()) + list(tree.buffers())
    leaves, _ = tree_flatten(tree)
    out: List[torch.Tensor] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, (torch.nn.Module, ShardedModel)):
            out += _tensors(leaf)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Tracker(TorchDispatchMode):
    """Bytes every aten op moves, and the storages alive: ``live`` now,
    ``peak`` the most at once, in allocator blocks."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        # the threads that called cuBLAS: the forward's (False), the backward's (True)
        self.blas_threads: set = set()

    def see(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage from now until it is freed (once)."""
        storage = t.untyped_storage()
        key = id(storage)
        if key in self.live or storage.nbytes() == 0:
            return
        size = -(-storage.nbytes() // BLOCK_BYTES) * BLOCK_BYTES
        self.live[key] = size
        self.current += size
        self.peak = max(self.peak, self.current)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def storages(self, tree) -> Dict[int, int]:
        """id → size of the live storages that ``tree`` holds."""
        out = {}
        for t in _tensors(tree):
            key = id(t.untyped_storage())
            if key in self.live:
                out[key] = self.live[key]
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is _DEVICE:             # a fake tensor's ``.device``, no op
            return out
        self.ops += 1
        if func.overloadpacket.__name__ in _CUBLAS:
            self.blas_threads.add(torch._C._current_graph_task_id() != -1)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if func.overloadpacket.__name__ not in _ALLOCATING and not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self.see(t)
        return out


class KernelCosts:
    """The open cost record of ``kernels/build.py``: launches, operations and
    bytes by kernel name."""

    def __init__(self):
        self.by_kernel: Dict[str, Dict[str, float]] = {}

    def __call__(self, name: str, flops: float, nbytes: float) -> None:
        row = self.by_kernel.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def total(self, key: str) -> float:
        return sum(row[key] for row in self.by_kernel.values())


@contextlib.contextmanager
def recording_costs():
    record = KernelCosts()
    build.COSTS.append(record)
    try:
        yield record
    finally:
        build.COSTS.remove(record)


class RecordingBackend(Backend):
    """The step's collectives over ``shards`` data-parallel devices, this
    device being the first: fake results of the real shapes, and each
    collective's operand bytes under JAX's op names."""

    name = "dryrun"

    def __init__(self, shards: int):
        super().__init__(None)
        self.shards = shards
        self.bytes_by_op = {c: 0 for c in COLLECTIVES}
        self.count_by_op = {c: 0 for c in COLLECTIVES}

    @property
    def process_count(self) -> int:
        return self.shards

    def _record(self, op: str, nbytes: int) -> None:
        self.bytes_by_op[op] += nbytes
        self.count_by_op[op] += 1

    def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        self._record("all-gather", _nbytes(tensor))
        return tensor.new_empty((self.shards * tensor.shape[0],) + tuple(tensor.shape[1:]))

    def reduce_tensors(self, tensors: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """One all-reduce per dtype group over a flat copy of the group, the
        results views of it (``backend/multiprocess.py``'s layout, without
        the 64-byte padding)."""
        out: List[Any] = [None] * len(tensors)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        for idx in groups.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            self._record("all-reduce", _nbytes(flat))
            if op == "mean":
                flat.div_(self.shards)
            start = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[start:start + n].view(tensors[i].shape)
                start += n
        return out

    def collectives(self) -> Dict[str, Any]:
        """JAX's ``parse_collective_bytes`` layout."""
        return {"bytes_by_op": dict(self.bytes_by_op), "count_by_op": dict(self.count_by_op),
                "total_bytes": sum(self.bytes_by_op.values()),
                "total_count": sum(self.count_by_op.values())}


class RecordingMesh:
    """One device of ``mesh`` (coordinate 0 on every axis) with the
    collectives a sharded step calls on a port ``Mesh``: fake results of the
    real shapes, each collective's operand bytes recorded on ``backend``
    under JAX's op name (all-gather, reduce-scatter, all-reduce), as
    ``RecordingBackend`` records its own."""

    def __init__(self, mesh: AbstractMesh, backend: "RecordingBackend"):
        self.axis_names = tuple(mesh.axis_names)
        self.shape = dict(mesh.shape)
        self.coords = {a: 0 for a in self.axis_names}
        self.backend = backend

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def axis_index(self, axes) -> int:
        return 0

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        x = x.reshape(1) if x.dim() == 0 else x
        n = self.size(axes)
        if n == 1:
            return x
        self.backend._record("all-gather", _nbytes(x))
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)

    def psum_scatter(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        n = self.size(axes)
        if n == 1:
            return x
        self.backend._record("reduce-scatter", _nbytes(x))
        shape = list(x.shape)
        shape[dim] //= n
        return x.new_empty(shape)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        if self.size(axes) == 1:
            return x
        self.backend._record("all-reduce", _nbytes(x))
        return x.new_empty(x.shape)

    pmax = psum


def batch_shards(mesh: AbstractMesh, batch: int, rules: Dict[str, Any]) -> int:
    """The devices ``act_batch`` splits a batch of ``batch`` rows over (the
    axes whose sizes divide it, as ``drop_indivisible`` cuts them)."""
    return mesh.axes_size(sh.split_axes("act_batch", batch, mesh,
                                         dict(sh.DEFAULT_RULES, **rules)))


def trace(cell: specs_lib.Cell, backend: RecordingBackend = None) -> Dict[str, Any]:
    """Run ``cell``'s step once on its fake arguments: FLOPs, bytes, memory,
    kernel work and collectives."""
    tracker = Tracker()
    card = build.as_card() if cell.as_card else contextlib.nullcontext()
    with cell.fake_mode, card:
        for t in _tensors(cell.abstract_args):
            tracker.see(t)
        args_bytes = tracker.current
        arg_keys = set(tracker.live)
        t0 = time.perf_counter()
        with recording_costs() as costs, FlopCounterMode(display=False) as flop_counter, tracker:
            out = cell.step_fn(*cell.abstract_args)
        trace_s = time.perf_counter() - t0
        outputs = tracker.storages(out)
    aten_flops = float(flop_counter.get_total_flops())
    kernel_flops, kernel_bytes = costs.total("flops"), costs.total("bytes")
    alias = sum(size for key, size in outputs.items() if key in arg_keys)
    on_card = cell.as_card or torch.device(cell.device).type == "cuda"
    workspace = CUBLAS_WORKSPACE_BYTES * len(tracker.blas_threads) if on_card else 0
    peak = tracker.peak + workspace
    memory = {
        "argument_size_in_bytes": args_bytes,
        "output_size_in_bytes": sum(outputs.values()),
        "alias_size_in_bytes": alias,
        "temp_size_in_bytes": peak - args_bytes,
        "workspace_bytes": workspace,
        "peak_bytes": peak,
        "device_bytes": DEVICE_BYTES,
        "fits": peak <= DEVICE_BYTES,
    }
    collectives = (backend or RecordingBackend(1)).collectives()
    return {
        "flops": aten_flops + kernel_flops,
        "aten_flops": aten_flops,
        "kernel_flops": kernel_flops,
        "bytes_accessed": float(tracker.bytes) + kernel_bytes,
        "aten_bytes": float(tracker.bytes),
        "kernel_bytes": kernel_bytes,
        "kernels": costs.by_kernel,
        "collectives": collectives,
        "memory": memory,
        "trace_s": round(trace_s, 3),
        "aten_ops": tracker.ops,
    }


def _check_preset(cfg, rules_preset: str, kind: str = "train") -> str:
    """Raise ``ValueError`` for a preset the port does not run on this cell
    (a cell of ``kind`` train, prefill or decode); else return why the
    cell's state stays replicated (``""``: it is sharded)."""
    if rules_preset not in specs_lib.RULE_PRESETS:
        raise ValueError(f"unknown rules preset '{rules_preset}' "
                         f"(have {sorted(specs_lib.RULE_PRESETS)})")
    if rules_preset == "head_tp":
        raise ValueError("rules preset 'head_tp' shards attention heads over the model axis "
                         "(tensor parallelism of activations), which the port's eager layers "
                         "do not have (ROADMAP.md A13)")
    if cfg.family == "moe" and cfg.moe_local_groups:
        raise ValueError(f"rules preset '{rules_preset}' on {cfg.name} with moe_local_groups: "
                         "its chunk-major groups need an all-to-all (ROADMAP.md A14c)")
    if cfg.family == "moe" and kind != "train":
        if rules_preset == "fsdp":
            raise ValueError(f"rules preset 'fsdp' on {cfg.name}'s {kind} cell: sharded "
                             "serving of the moe family has no expert parallelism laid out "
                             "(ROADMAP.md A14s)")
        return "sharded serving of the moe family has no expert parallelism (ROADMAP.md A14s)"
    return ""


def run_cell(arch: str, shape: str, mesh_kind: str, variant: str,
             with_deltas: bool = True, smoke: bool = False,
             mesh_override=None, rules_preset: str = "default",
             feature_mode: str = "svd", grad_mode: str = "probe",
             data_source: str = "synthetic_lm", device="cuda:0",
             stand_in: bool = False) -> Dict[str, Any]:
    """One cell on one device of ``mesh_override`` or of ``mesh_kind``'s
    mesh: "single" the production pod (16, 16), "multi" two pods, "one" a
    single device. ``with_deltas`` is accepted: every layer runs, so
    ``scaled`` is ``full``. ``device``: what the fake tensors are (``cpu``
    takes the CPU's own routes, to hold a trace to a real CPU step);
    ``stand_in``: the CPU stand-in for the card (``specs.abstract_device``).
    ``rules_preset``: "fsdp" (a cell's state sharded, ``"state":
    "sharded"``; a MoE arch's serve cells refuse, A14s) or "default" (every
    cell sharded as well, with the batch over ``("pod", "data")`` and the
    sequence, the MLP hidden, the RWKV and SSM heads, the experts and the
    vocabulary over ``"model"``, but a MoE arch's serve cells, which keep
    the state replicated on each device, and ``replicated_why`` says why).
    The shape's ``SHAPE_RULES`` come under the preset's. ``data_source``'s
    task pins the model's fields (a dense arch given a frontend) on every
    cell, a serve cell's prompts its input."""
    cfg = config_lib.get_config(arch)
    info = specs_lib.SHAPES[shape]
    if data_source != "synthetic_lm":                                 # the task pins fields
        task = data_sources.get_source(data_source).task
        cfg = dataclasses.replace(cfg, **task.model_overrides(
            task.derive(cfg, batch=info["batch"], seq=info["seq"], seed=0)))
    replicated_why = _check_preset(cfg, rules_preset, info["kind"])
    if mesh_override is not None:
        mesh = mesh_override
    elif mesh_kind == "one":
        mesh = make_mesh((1, 1), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    sel_modes: Dict[str, Any] = {"feature_mode": feature_mode, "grad_mode": grad_mode,
                                 "data_source": data_source}
    rows = max(4, info["batch"] // 64) if smoke else info["batch"]
    rules = dict(specs_lib.SHAPE_RULES[shape], **specs_lib.RULE_PRESETS[rules_preset])
    shards = batch_shards(mesh, rows, rules)
    if rules_preset == "default" and not replicated_why and mesh.size == 1:
        replicated_why = "one device: nothing to shard"
    sharding: Dict[str, Any] = {}
    if not replicated_why:
        backend = RecordingBackend(mesh.size)
        sharding = dict(mesh=RecordingMesh(mesh, backend), rules=dict(sh.DEFAULT_RULES, **rules))
    else:
        backend = RecordingBackend(shards) if shards > 1 else None
    cell = specs_lib.build_cell(arch, shape, variant=variant, smoke=smoke,
                                batch_shards=shards, backend=backend, device=device,
                                stand_in=stand_in, **sharding, **sel_modes)
    full = trace(cell, backend)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "mesh_shape": mesh.shape, "variant": variant, "smoke": smoke,
        "rules_preset": rules_preset, "num_layers": cfg.num_layers, **sel_modes,
        "device": str(cell.device),
        "traced_on": ("the CPU stand-in: fake cpu tensors on the card's routes" if cell.as_card
                      else f"fake {cell.device} tensors"),
        "state": "sharded" if sharding else "replicated", "batch_shards": shards,
        **({"replicated_why": replicated_why} if replicated_why else {}),
        "local_batch": cell.batch,
        "argument_bytes_per_device": full["memory"]["argument_size_in_bytes"],
        "full": full,
        "scaled": {"flops": full["flops"], "bytes_accessed": full["bytes_accessed"],
                   "collective_bytes": full["collectives"]["total_bytes"]},
    }


def result_path(arch: str, shape: str, mesh_kind: str, variant: str,
                stand_in: bool = False, rules_preset: str = "default") -> str:
    """The cell's JSON: the card's, or the CPU stand-in's apart from it; a
    preset other than the default names itself last."""
    out_dir = STAND_IN_DIR if stand_in else OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    tail = "" if rules_preset == "default" else f"__{rules_preset}"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__{variant}{tail}.json")


def cells(arch=None, shape=None, variant=None, listing: bool = False):
    """(arch, shape, variant) of every supported cell the filters keep;
    with ``listing`` the SKIP lines of unsupported ones are printed."""
    out = []
    for a, s in specs_lib.all_cells():
        if (arch and a != arch) or (shape and s != shape):
            continue
        ok, why = specs_lib.cell_is_supported(a, s)
        if not ok:
            if listing:
                print(f"SKIP {a:24s} {s:12s} — {why}")
            continue
        variants = ([variant] if variant else ["graft", "baseline"]) if s == "train_4k" \
            else ["serve"]
        out += [(a, s, v) for v in variants]
    return out


def sweep_order(todo, longest_first: bool = False):
    """``todo`` (tuples starting (arch, shape, ...)) cheapest first: by kind
    (train, decode, prefill) and depth, with the cells whose step loops over
    tokens in Python last (the RWKV time mix's prefill; Hymba's SSM heads,
    two ops a token, outside decode). ``longest_first`` reverses it, for a
    sweep that is to finish every cell."""
    kinds = {"train": 0, "decode": 1, "prefill": 2}

    def key(cell):
        cfg = config_lib.get_config(cell[0])
        info = specs_lib.SHAPES[cell[1]]
        loops = (cfg.family == "hybrid" and info["kind"] != "decode") or \
            (cfg.family == "ssm" and info["kind"] == "prefill")
        return loops, kinds[info["kind"]], cfg.num_layers
    return sorted(todo, key=key, reverse=longest_first)


def summary(res: Dict[str, Any]) -> str:
    """A result's one line: fits, per-device peak, TFLOPs and trace seconds."""
    full = res.get("full", {})
    mem = full.get("memory", {})
    preset = res.get("rules_preset", "default")
    return (f"{res['arch']} {res['shape']} {res['mesh']} {res['variant']}"
            f"{'' if preset == 'default' else ' ' + preset}: "
            f"{'OK' if res.get('ok') else 'FAIL'} fits={mem.get('fits')} "
            f"peak={mem.get('peak_bytes', 0) / 1e9:.2f}GB "
            f"args={mem.get('argument_size_in_bytes', 0) / 1e9:.2f}GB "
            f"tflops={full.get('flops', 0) / 1e12:.1f} "
            f"collective={full.get('collectives', {}).get('total_bytes', 0) / 1e9:.3f}GB "
            f"shards={res.get('batch_shards')} trace={full.get('trace_s')}s "
            f"wall={res.get('wall_s')}s")


def one_cell(arch: str, shape: str, variant: str, mesh_kind: str, **kw) -> Dict[str, Any]:
    """``run_cell`` with its failure recorded, written to ``result_path``."""
    t0 = time.perf_counter()
    try:
        res = dict(run_cell(arch, shape, mesh_kind, variant, **kw), ok=True)
    except Exception:                                  # noqa: BLE001 — recorded, go on
        res = {"arch": arch, "shape": shape, "mesh": mesh_kind, "variant": variant,
               "ok": False, "error": traceback.format_exc()}
    res["wall_s"] = round(time.perf_counter() - t0, 1)
    with open(result_path(arch, shape, mesh_kind, variant, kw.get("stand_in", False),
                          kw.get("rules_preset", "default")), "w") as f:
        json.dump(res, f, indent=1)
    return res


def _pool_cell(cell, kw):
    arch, shape, variant, mesh_kind, *preset = cell
    return one_cell(arch, shape, variant, mesh_kind, **dict(kw, **(
        {"rules_preset": preset[0]} if preset else {})))


def sweep(todo, jobs: int, deadline_s: float = None, **kw):
    """Each (arch, shape, variant, mesh kind[, rules preset]) of ``todo``
    through ``one_cell`` (``run_cell``'s keywords in ``kw``; a cell's preset
    comes over ``kw``'s) in a pool of ``jobs``
    worker processes, in order; at ``deadline_s`` after the start the
    workers are killed. Returns (results of the cells that finished, cells
    left out). The workers are spawned: they import the caller's
    ``__main__``, so a script that calls this keeps its own work under
    ``if __name__ == "__main__"``."""
    import multiprocessing
    t0 = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(jobs)
    try:
        waiting = {cell: pool.apply_async(_pool_cell, (cell, kw)) for cell in todo}
        done = []
        while waiting:
            for cell, job in list(waiting.items()):
                if job.ready():
                    done.append(job.get())
                    del waiting[cell]
            if deadline_s is not None and time.perf_counter() - t0 > deadline_s:
                break
            time.sleep(0.2)
        return done, [cell for cell in todo if cell in waiting]
    finally:
        pool.terminate()
        pool.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of every cell on fake tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(specs_lib.SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "one"],
                    help="the production pod, two pods, or one device")
    ap.add_argument("--variant", default=None,
                    help="train cells: graft|baseline (default: both)")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--no-deltas", action="store_true",
                    help="accepted: every layer runs, so scaled equals full")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--feature-mode", default="svd",
                    help="selection feature extractor for graft cells")
    ap.add_argument("--grad-mode", default="probe",
                    help="selection gradient source for graft cells")
    ap.add_argument("--rules-preset", default="default", choices=list(specs_lib.RULE_PRESETS),
                    help="fsdp: every arch's state sharded (MoE serve cells refused); default: "
                         "every train state but hymba's sharded, and the dense serve cells")
    ap.add_argument("--data-source", default="synthetic_lm",
                    help="task/data-source registry name for train cells")
    ap.add_argument("--cpu-stand-in", action="store_true",
                    help="where PyTorch has no CUDA: trace fake CPU tensors on the card's "
                         "routes (results under experiments/dryrun_torch/cpu_stand_in/)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    ap.add_argument("--deadline", type=float, default=None,
                    help="with --jobs: seconds after which unfinished cells are left out")
    ap.add_argument("--experiment", nargs="+", default=None, metavar="KEY=VALUE",
                    help="trace the first step of an api.ExperimentConfig with these "
                         "overrides (the CLI's --section.field=value, without the dashes)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if not args.list and not args.cpu_stand_in and not torch.cuda.is_available():
        print("PyTorch has no CUDA here: the dry run traces fake cuda:0 tensors; pass "
              "--cpu-stand-in to trace the card's routes on fake CPU tensors", file=sys.stderr)
        return 2
    if args.experiment:
        from repro_torch.api import ExperimentConfig
        cfg = ExperimentConfig().apply_overrides(args.experiment)
        res = trace(specs_lib.experiment_cell(cfg, stand_in=args.cpu_stand_in))
        mem = res["memory"]
        print(f"experiment {' '.join(args.experiment)}: fits={mem['fits']} "
              f"peak={mem['peak_bytes'] / 1e9:.3f}GB args={mem['argument_size_in_bytes'] / 1e9:.3f}GB "
              f"aten_tflops={res['aten_flops'] / 1e12:.3f} kernel_tflops="
              f"{res['kernel_flops'] / 1e12:.3f} launches="
              f"{ {k: row['launches'] for k, row in res['kernels'].items()} } "
              f"trace={res['trace_s']}s")
        return 0

    todo = cells(args.arch, args.shape, args.variant, listing=args.list)
    if args.list:
        for arch, shape, v in todo:
            print(f"CELL {arch:24s} {shape:12s} {v}")
        return 0
    if not todo:
        print("nothing to do")
        return 1

    kw = dict(with_deltas=not args.no_deltas, smoke=args.smoke,
              rules_preset=args.rules_preset, feature_mode=args.feature_mode,
              grad_mode=args.grad_mode, data_source=args.data_source,
              stand_in=args.cpu_stand_in)
    if args.skip_existing:
        cached = [c for c in todo if os.path.exists(
            result_path(c[0], c[1], args.mesh, c[2], args.cpu_stand_in, args.rules_preset))]
        for arch, shape, v in cached:
            print(f"[cached] {arch} {shape} {args.mesh} {v}")
        todo = [c for c in todo if c not in cached]
    if args.jobs > 1:
        results, left = sweep(sweep_order([c + (args.mesh,) for c in todo], longest_first=True),
                              args.jobs, args.deadline, **kw)
        for res in results:
            print(summary(res), flush=True)
        for arch, shape, v, mesh_kind in left:
            print(f"LEFT OUT {arch} {shape} {mesh_kind} {v}: past the {args.deadline} s deadline")
        failures = sum(not r.get("ok") for r in results) + len(left)
        return 1 if failures else 0
    failures = 0
    for arch, shape, v in todo:
        print(f"[dryrun] {arch} {shape} {args.mesh} {v} ...", flush=True)
        res = one_cell(arch, shape, v, args.mesh, **kw)
        if not res["ok"]:
            failures += 1
            print(res["error"], file=sys.stderr)
        print(f"  -> {summary(res)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
