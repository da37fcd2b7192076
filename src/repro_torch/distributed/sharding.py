"""Logical-axis sharding rules — the rule table and mapping of the JAX
package's ``distributed/sharding.py``, in plain Python.

Code names the LOGICAL axes of its arrays (``act_batch``, ``heads``, ...);
a rule table maps each to mesh axes, and ``logical_to_spec`` resolves the
names against a mesh's axes. The port's sharded selection engine asks it
which mesh axes the batch runs over (``act_batch`` → ``("pod", "data")``,
filtered to the axes the mesh has). Any object with ``axis_names`` and a
``shape`` mapping works as the mesh: a port ``Mesh``, or a JAX mesh's names
and sizes.

A spec is a tuple with one entry per logical axis, as a ``PartitionSpec``
lists them: a mesh axis name, a tuple of two or more names, or ``None``
(replicated).

The partitioner half of the JAX module (``constrain``, ``named_sharding``,
``param_sharding_tree``, ``param_shardings``) annotates arrays for XLA and
has no counterpart in eager PyTorch (``ROADMAP.md``, A11).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# the production meshes' axes: ("data", "model") on one pod, ("pod", "data",
# "model") on several; "pod" appears in a batch rule only where the mesh has it
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # --- activation axes ---
    "act_batch": ("pod", "data"),       # data parallel over pod + data
    "act_seq": None,
    "act_res_seq": "model",             # sequence parallelism on the residual stream
    "act_q_seq": "model",               # seq-sharded attention queries
    "act_kv_seq": None,
    "act_heads": "model",
    "act_kv_heads": None,
    "act_embed": None,
    "act_mlp": "model",
    "act_experts": "model",
    "act_mlp_inner": None,
    "act_moe_groups": ("model", "pod", "data"),
    "act_moe_dispatch": ("pod", "data"),
    "act_vocab": "model",
    # --- parameter axes ---
    "embed": "data",                    # FSDP over the d_model dim of weights
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "layers": None,
    "ssm_inner": "model",
    "unsharded": None,
}


class _State(threading.local):
    def __init__(self):
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)
        self.mesh = None
        self.enabled: bool = False


_STATE = _State()


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[Dict[str, MeshAxes]] = None):
    """Make ``mesh`` and the default rules with ``overrides`` the ones that
    ``logical_to_spec`` uses when it is given none (per thread)."""
    prev = (_STATE.rules, _STATE.mesh, _STATE.enabled)
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    _STATE.rules, _STATE.mesh, _STATE.enabled = rules, mesh, True
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh, _STATE.enabled = prev


def logical_to_spec(logical: Sequence[Optional[str]], mesh=None,
                    rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Map logical axis names to a spec valid for ``mesh``: each rule's
    target filtered to the mesh's axes, ``None`` where nothing is left."""
    mesh = mesh if mesh is not None else _STATE.mesh
    rules = rules or _STATE.rules
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    spec = []
    for name in logical:
        if name is None:
            spec.append(None)
            continue
        target = rules.get(name)
        if target is None:
            spec.append(None)
        elif isinstance(target, str):
            spec.append(target if target in mesh_axes else None)
        else:
            filtered = tuple(a for a in target if a in mesh_axes)
            # one axis is listed by its name, as a PartitionSpec lists it
            spec.append(filtered[0] if len(filtered) == 1 else (filtered or None))
    return tuple(spec)


def _axis_size(mesh, target: MeshAxes) -> int:
    if target is None:
        return 1
    if isinstance(target, str):
        return mesh.shape[target]
    size = 1
    for a in target:
        size *= mesh.shape[a]
    return size


def drop_indivisible(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """A spec sanitized against concrete dims: each entry cut to the longest
    prefix of its axes whose size divides the dim (``None`` when none
    does), and a mesh axis used by an earlier dim dropped (the first use
    wins)."""
    used: set = set()
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if a not in used)
        while axes and (dim % _axis_size(mesh, axes) != 0):
            axes = axes[:-1]
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


__all__ = ["DEFAULT_RULES", "MeshAxes", "Spec", "sharding_rules", "logical_to_spec",
           "drop_indivisible"]
