"""Signature drift of the step function's arguments across training steps —
the port of the JAX package's ``analysis/recompile.py``.

In the JAX package a drifting call signature (a batch shape changed, a
dtype widened, a static argument took a new value) re-traces and recompiles
the jitted step. The eager port compiles nothing, but the same drift still
means a different step: other kernel plans and allocations every step, and
a batch the data pipeline was not meant to produce. :meth:`RecompileWatcher
.observe` snapshots the (shape, dtype) spec of every argument leaf per call
and diffs it against the previous call, emitting RC001 naming exactly the
key path that changed (``batch['x']: float32[8,16] → float32[8,32]``). Key
paths and specs are JAX's: ``['key']`` for a dict entry, ``[i]`` for a list
or tuple item, ``.name`` for a NamedTuple field, dtypes by their numpy
names — so the same numpy batch gives the same signature in both packages.

The JAX watcher's second check, ``watch``/``check_caches``, reads the
compile-cache size of a jitted function. Eager PyTorch keeps no compile
cache, so it has no twin here (``ROADMAP.md`` A11).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding, Report


def _dtype_name(dtype: Any) -> str:
    """numpy's name for a dtype (``torch.float32`` → ``float32``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def leaf_spec(leaf: Any) -> str:
    """Stable signature of one argument leaf: ``dtype[shape]`` for arrays
    and tensors, ``repr`` for plain python values."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        weak = "~" if getattr(leaf, "weak_type", False) else ""
        return f"{_dtype_name(dtype)}[{','.join(map(str, shape))}]{weak}"
    if isinstance(leaf, (bool, int, float, str, bytes, type(None))):
        r = repr(leaf)
        return r if len(r) <= 64 else r[:61] + "..."
    # exotic leaf: type identity only — repr could walk device tensors
    return f"<{type(leaf).__name__}>"


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and ``keystr``'s notation: dicts by sorted key, lists and tuples
    by index, NamedTuples by field; ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    else:
        yield path, tree


def signature_of(**named_args) -> Dict[str, str]:
    """Key path → leaf spec over every named argument tree."""
    out: Dict[str, str] = {}
    for name, tree in named_args.items():
        leaves = list(_leaves(tree))
        if not leaves:
            out[name] = repr(tree)
        for path, leaf in leaves:
            out[name + path] = leaf_spec(leaf)
    return out


class RecompileWatcher:
    """Accumulates RC001 findings over a sequence of step calls."""

    def __init__(self, label: str = "step"):
        self.label = label
        self.findings: List[Finding] = []
        self._prev: Optional[Dict[str, str]] = None

    def observe(self, step: Optional[int] = None, **named_args) -> List[Finding]:
        """Snapshot this call's argument signature; diff vs the previous
        call. Returns the NEW findings from this observation."""
        sig = signature_of(**named_args)
        new: List[Finding] = []
        if self._prev is not None:
            at = f"{self.label}" + (f" step {step}" if step is not None else "")
            for key in sorted(set(self._prev) | set(sig)):
                before, after = self._prev.get(key), sig.get(key)
                if before == after:
                    continue
                if before is None:
                    msg = f"argument '{key}' appeared ({after})"
                elif after is None:
                    msg = f"argument '{key}' disappeared (was {before})"
                else:
                    msg = f"argument '{key}' changed: {before} → {after}"
                new.append(Finding(
                    rule="RC001", location=at,
                    message=msg + " — the step runs on a new signature from this call",
                    fix_hint="pin the shape/dtype (pad the batch, cast at "
                             "the loader) or fix the value once at "
                             "construction"))
        self._prev = sig
        self.findings.extend(new)
        return new

    def report(self) -> Report:
        return Report(self.findings)

    @property
    def ok(self) -> bool:
        return not self.findings
