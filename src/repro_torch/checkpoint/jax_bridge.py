"""Weights carried across from the JAX package, without importing JAX.

* ``params_from_numpy(tree, model)`` loads the JAX param pytree — nested
  dicts of numpy arrays, with the blocks stacked on a leading L axis as the
  JAX ``init_params`` builds them — into a port ``Model``.
* ``params_to_numpy(model)`` is the inverse (blocks re-stacked), for
  comparing the port's tensors with the JAX package's.
* ``load_jax_checkpoint(directory)`` reads the ``.npy`` + ``manifest.json``
  format the JAX ``CheckpointManager`` writes. bfloat16 leaves are stored
  there as their raw ``uint16`` bits with the logical dtype in the manifest;
  they are rebuilt as ``torch.bfloat16`` by viewing the bits, never by
  rounding through float. Every leaf's adler32 checksum is verified.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.model import Model


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


def params_from_numpy(tree: Dict[str, Any], model: Model) -> Model:
    """Load a JAX-layout param tree (blocks stacked on axis 0) into
    ``model``, in place; raises on a missing leaf or a shape mismatch."""
    _assign(model.embed, tree["embed"], "embed")
    _assign(model.final_norm, tree["final_norm"], "final_norm")
    if not model.cfg.tie_embeddings:
        _assign(model.lm_head, tree["lm_head"], "lm_head")
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
    blocks stacked on axis 0."""
    tree = model_or_tree.tree() if isinstance(model_or_tree, Model) else model_or_tree

    def np_(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    out = {k: np_(v) for k, v in tree.items() if k != "blocks"}
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
