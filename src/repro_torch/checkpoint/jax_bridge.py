"""Weights carried across from the JAX package, without importing JAX.

* ``params_from_numpy(tree, model)`` loads the JAX param pytree — nested
  dicts of numpy arrays, with the blocks stacked on a leading L axis as the
  JAX ``init_params`` builds them, and ``first_blocks`` a list of unstacked
  blocks — into a port ``Model``.
* ``params_to_numpy(model)`` is the inverse (blocks re-stacked), for
  comparing the port's tensors with the JAX package's.
* ``load_jax_checkpoint(directory)`` reads the ``.npy`` + ``manifest.json``
  format the JAX ``CheckpointManager`` writes. bfloat16 leaves are stored
  there as their raw ``uint16`` bits with the logical dtype in the manifest;
  they are rebuilt as ``torch.bfloat16`` by viewing the bits, never by
  rounding through float. Every leaf's adler32 checksum is verified.
* ``train_state_to_host(state)`` / ``load_train_state(state, flat)`` map the
  port's train state to and from the JAX train state's flat leaf paths
  (``repro.launch.steps.init_train_state`` flattened as the JAX
  checkpointer flattens it): ``params/…`` and the optimizer state
  ``opt/m/…``, ``opt/v/…`` (Adafactor: ``opt/v/…/vr``, ``…/vc`` or
  ``…/v``) with the blocks stacked on L, ``step`` (int32), ``graft/.<field>``
  (the ``SelectionState`` fields), ``sampler_carry/…`` and ``health/…``
  (float32 EMA, int32 counts). ``first_blocks`` leaves are one path per
  block (``params/first_blocks/<i>/…``), unstacked, as the JAX checkpointer
  writes a list. Leaves keep their dtypes, so a checkpoint crosses between
  the packages bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model, stacked_leaves


def _to_tensor(value) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, by its bits) or tensor → tensor."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.ascontiguousarray(value)
    if not arr.flags.writeable:          # e.g. np.asarray of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _assign(param: torch.nn.Parameter, value, where: str) -> None:
    t = _to_tensor(value)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)} != port {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t.to(device=param.device, dtype=param.dtype))


def _item(seq, i: int):
    """Element ``i`` of a list, or of a dict keyed by the index as a string
    (how ``load_jax_checkpoint`` nests a list's leaves)."""
    return seq[i] if isinstance(seq, (list, tuple)) else seq[str(i)]


def params_from_numpy(tree: Dict[str, Any], model: Model) -> Model:
    """Load a JAX-layout param tree (blocks stacked on axis 0) into
    ``model``, in place; raises on a missing leaf or a shape mismatch."""
    _assign(model.embed, tree["embed"], "embed")
    _assign(model.final_norm, tree["final_norm"], "final_norm")
    if not model.cfg.tie_embeddings:
        _assign(model.lm_head, tree["lm_head"], "lm_head")
    for i, blk in enumerate(getattr(model, "first_blocks", [])):
        src = _item(tree["first_blocks"], i)
        for name, sub in blk.tree().items():
            if isinstance(sub, dict):
                for leaf, p in sub.items():
                    _assign(p, src[name][leaf], f"first_blocks/{i}/{name}/{leaf}")
            else:
                _assign(sub, src[name], f"first_blocks/{i}/{name}")
    blocks = tree["blocks"]
    for i, blk in enumerate(model.blocks):
        for name, sub in blk.tree().items():
            if isinstance(sub, dict):
                for leaf, p in sub.items():
                    _assign(p, blocks[name][leaf][i], f"blocks/{name}/{leaf}[{i}]")
            else:
                _assign(sub, blocks[name][i], f"blocks/{name}[{i}]")
    return model


def params_to_numpy(model_or_tree) -> Dict[str, Any]:
    """The port's parameters (or any tensors in the same tree shape, such
    as gradients) as a JAX-layout tree of float32/int numpy arrays with the
    blocks stacked on axis 0 and ``first_blocks`` a list."""
    tree = model_or_tree.tree() if isinstance(model_or_tree, Model) else model_or_tree

    def np_(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def block_np(b):
        return {name: ({leaf: np_(t) for leaf, t in sub.items()} if isinstance(sub, dict)
                       else np_(sub)) for name, sub in b.items()}

    out = {k: np_(v) for k, v in tree.items() if k not in ("blocks", "first_blocks")}
    if "first_blocks" in tree:
        out["first_blocks"] = [block_np(b) for b in tree["first_blocks"]]
    blocks = tree["blocks"]
    out["blocks"] = {}
    for name, sub in blocks[0].items():
        if isinstance(sub, dict):
            out["blocks"][name] = {leaf: np.stack([np_(b[name][leaf]) for b in blocks])
                                   for leaf in sub}
        else:
            out["blocks"][name] = np.stack([np_(b[name]) for b in blocks])
    return out


def _step_dir(directory: str) -> str:
    """``directory`` itself if it holds a manifest, else its newest
    ``step_XXXXXXXX`` checkpoint."""
    if os.path.exists(os.path.join(directory, "manifest.json")):
        return directory
    steps = sorted(n for n in os.listdir(directory)
                   if re.fullmatch(r"step_\d{8}", n)
                   and os.path.exists(os.path.join(directory, n, "manifest.json")))
    if not steps:
        raise FileNotFoundError(f"no checkpoint manifest under {directory}")
    return os.path.join(directory, steps[-1])


def load_jax_checkpoint(directory: str) -> Dict[str, Any]:
    """A JAX checkpoint as a nested dict of CPU tensors, keyed by the
    manifest's ``/``-separated leaf paths (list indices stay string keys)."""
    d = _step_dir(directory)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        if zlib.adler32(np.ascontiguousarray(arr).view(np.uint8).tobytes()) != meta["adler32"]:
            raise ValueError(f"checksum mismatch for leaf '{key}' in {d}")
        if meta["dtype"] == "bfloat16":
            if arr.dtype != np.uint16:
                raise ValueError(f"bf16 leaf '{key}' stored as {arr.dtype}, expected uint16")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = _to_tensor(arr)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


# ---------------------------------------------------------------------------
# the train state ↔ the JAX train state's flat leaves
# ---------------------------------------------------------------------------

# state sections a checkpoint may lack (added to the JAX state after some
# checkpoints were written): restore keeps the fresh value, as JAX does
OPTIONAL_SECTIONS = ("health", "sampler_carry")


def _param_leaves(state) -> List[Tuple[str, List[int]]]:
    """(JAX leaf path under ``params/``, indices into ``state["params"]``)
    for every JAX param leaf, blocks stacked in block order."""
    index = {id(p): i for i, p in enumerate(state["params"])}
    return [(path, [index[id(t)] for t in ts]) for path, ts in stacked_leaves(state["model"])]


def _stack_to_host(tensors: List[torch.Tensor], stacked: bool) -> torch.Tensor:
    """A copy on the host that has finished when this returns (the port
    updates its tensors in place)."""
    if not stacked:
        return tensors[0].detach().to("cpu", copy=True)
    out = torch.empty((len(tensors),) + tuple(tensors[0].shape), dtype=tensors[0].dtype)
    for i, t in enumerate(tensors):
        out[i].copy_(t.detach())
    return out


def _state_leaves(state) -> Dict[str, Tuple[List[torch.Tensor], bool]]:
    """path → (the port tensors that make the leaf, stacked on a new axis 0
    or not), for params and optimizer state."""
    out: Dict[str, Tuple[List[torch.Tensor], bool]] = {}
    params, opt = state["params"], state["opt"]
    leaves = _param_leaves(state)
    stacked = {path: path.startswith("blocks/") for path, idx in leaves}
    for path, idx in leaves:
        out[f"params/{path}"] = ([params[i] for i in idx], stacked[path])
    if "groups" in opt:                         # Adafactor: one entry per JAX leaf
        for (path, idx), g, entry in zip(leaves, opt["groups"], opt["v"], strict=True):
            if (g if isinstance(g, list) else [g]) != idx:
                raise ValueError(f"Adafactor group {g} is not the JAX leaf {path} ({idx})")
            for k, t in entry.items():
                out[f"opt/v/{path}/{k}"] = ([t], False)
    else:
        for name, ts in opt.items():
            for path, idx in leaves:
                out[f"opt/{name}/{path}"] = ([ts[i] for i in idx], stacked[path])
    return out


def _scalar(value, dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def _carry_items(carry) -> List[Tuple[str, torch.Tensor]]:
    """The sampler carry's leaves under their JAX path below
    ``sampler_carry/``: a NamedTuple's fields as ``.{field}`` (the JAX
    checkpointer's ``GetAttrKey``), a dict's keys as they are."""
    if not carry:
        return []
    if hasattr(carry, "_fields"):
        return [(f".{f}", getattr(carry, f)) for f in carry._fields]
    return list(carry.items())


def train_state_to_host(state) -> Dict[str, torch.Tensor]:
    """The train state as CPU tensors keyed by the JAX checkpoint's leaf
    paths. Every device→host copy has finished when this returns."""
    flat = {path: _stack_to_host(ts, st) for path, (ts, st) in _state_leaves(state).items()}
    flat["step"] = _scalar(state["step"], torch.int32)
    if "graft" in state:
        for field, t in state["graft"]._asdict().items():
            flat[f"graft/.{field}"] = t.detach().to("cpu", copy=True)
    for k, t in _carry_items(state.get("sampler_carry")):
        flat[f"sampler_carry/{k}"] = t.detach().to("cpu", copy=True)
    if "health" in state:
        h = state["health"]
        flat.update({"health/ema_mean": _scalar(float(h["ema_mean"]), torch.float32),
                     "health/ema_var": _scalar(float(h["ema_var"]), torch.float32),
                     "health/count": _scalar(int(h["count"]), torch.int32),
                     "health/bad_streak": _scalar(int(h["bad_streak"]), torch.int32)})
    return flat


def train_state_spec(state) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """path → (shape, dtype) of every leaf ``train_state_to_host`` writes,
    without copying anything."""
    spec = {}
    for path, (ts, st) in _state_leaves(state).items():
        shape = ((len(ts),) if st else ()) + tuple(ts[0].shape)
        spec[path] = (shape, ts[0].dtype)
    spec["step"] = ((), torch.int32)
    if "graft" in state:
        for field, t in state["graft"]._asdict().items():
            spec[f"graft/.{field}"] = (tuple(t.shape), t.dtype)
    for k, t in _carry_items(state.get("sampler_carry")):
        spec[f"sampler_carry/{k}"] = (tuple(t.shape), t.dtype)
    if "health" in state:
        spec.update({"health/ema_mean": ((), torch.float32), "health/ema_var": ((), torch.float32),
                     "health/count": ((), torch.int32), "health/bad_streak": ((), torch.int32)})
    return spec


def check_against_spec(flat: Dict[str, torch.Tensor], spec) -> None:
    """Raise ``KeyError`` for a leaf the state needs that ``flat`` lacks
    (outside the optional sections) and ``ValueError`` for a shape or dtype
    that differs."""
    for path, (shape, dtype) in spec.items():
        if path not in flat:
            if path.split("/", 1)[0] in OPTIONAL_SECTIONS:
                continue
            raise KeyError(f"checkpoint missing leaf '{path}'")
        got = flat[path]
        if tuple(got.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for '{path}': ckpt {tuple(got.shape)} "
                             f"vs target {tuple(shape)}")
        if got.dtype != dtype:
            raise ValueError(f"dtype mismatch for '{path}': ckpt {got.dtype} vs target {dtype}")


@torch.no_grad()
def load_train_state(state, flat: Dict[str, torch.Tensor]):
    """Load a flat checkpoint (``train_state_to_host``'s or the JAX
    checkpointer's layout) into ``state``: parameters and optimizer state
    in place, the rest replaced. Raises as ``check_against_spec``."""
    check_against_spec(flat, train_state_spec(state))
    for path, (ts, st) in _state_leaves(state).items():
        src = flat[path]
        for i, t in enumerate(ts):
            t.copy_(src[i] if st else src)
    state["step"] = int(flat["step"])
    if "graft" in state:
        g = state["graft"]
        dev = g.pivots.device
        state["graft"] = g._replace(**{f: flat[f"graft/.{f}"].to(dev) for f in g._fields})
    carry = state.get("sampler_carry")
    if carry:
        loaded = {k: flat[f"sampler_carry/{k}"].to(v.device)
                  if f"sampler_carry/{k}" in flat else v for k, v in _carry_items(carry)}
        state["sampler_carry"] = (carry._replace(**{k[1:]: v for k, v in loaded.items()})
                                  if hasattr(carry, "_fields") else loaded)
    if "health" in state and "health/count" in flat:
        state["health"] = {"ema_mean": np.float32(flat["health/ema_mean"].item()),
                           "ema_var": np.float32(flat["health/ema_var"].item()),
                           "count": int(flat["health/count"]),
                           "bad_streak": int(flat["health/bad_streak"])}
    return state
