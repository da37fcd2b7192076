"""The optimizer step's two passes: hand-written Hopper kernels and their
plain PyTorch versions.

The JAX package has no TPU kernel here: XLA fuses its jitted optimizer
(``repro/optim/optimizers.py``). The port's eager per-leaf loop launched
about two dozen elementwise kernels a leaf, so the step is two kernels of
``csrc/fused_optim.cu`` instead:

* ``grad_norm(grads, clip_norm)`` → ``(norm, scale)``, 0-d float32 tensors:
  √Σ g² in float32 over every leaf (bf16 or float32) and the clip factor
  ``min(1, clip_norm / (norm + 1e-9))`` (1 when ``clip_norm`` is None) —
  kernel A, one launch (a sum-of-squares pass writing a partial per block,
  then a one-block pass adding them in order), counted in
  ``grad_norm.launches``. With ``reduce`` (a state sharded over ranks) A
  runs split: its pass writes this rank's Σ g² over the leaves it counts,
  ``reduce`` adds the ranks' sums (a ``psum``), and its finish takes the
  root and the clip factor of the total — still one launch of A, counted at
  the finish, which every rank runs once.
* ``optimizer_update(rule, params, grads, m, v, hyper, scale)`` updates
  ``params``, ``m`` (and ``v``) in place by ``adamw``, ``sgd`` or ``lion``,
  with each gradient first clipped by ``scale`` (a device scalar, or None)
  and rounded to its dtype, as JAX's ``(g.f32 * scale).astype(g.dtype)`` —
  kernel B, one launch for each (parameter dtype, state dtype) group of
  leaves, each counted in ``optimizer_update.launches``.

For CUDA tensors the wrappers build a leaf table (addresses, lengths, chunk
starts; int64 rows) in pinned memory, copy it to the card on the current
stream without a host sync, and launch. A build or launch failure raises.
For CPU tensors they run the plain versions, ``grad_norm_reference`` and
``update_reference``: the port's per-leaf PyTorch code. On the card kernel B
is bit-equal to ``update_reference`` given the same scale, and kernel A's
norm agrees with ``grad_norm_reference``'s to float32 summation order.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

RULES = ("adamw", "sgd", "lion")
_F = np.float32
_DTYPES = (torch.bfloat16, torch.float32)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """One step's scalars as Python floats, the values the plain version
    uses: ``bc1``/``bc2`` are AdamW's bias corrections ``1 - β^(t)`` (float32
    arithmetic)."""
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    momentum: float
    bc1: float = 1.0
    bc2: float = 1.0

    def kernel_args(self) -> Tuple[float, ...]:
        """The float32 scalars PyTorch's CUDA ops use for the plain code's
        Python floats: each as float32, and a division by ``bc1``/``bc2`` as
        a multiply by the float32 reciprocal (PyTorch's CUDA ``div`` by a
        scalar does that)."""
        return tuple(float(x) for x in (
            _F(self.lr), _F(self.beta1), _F(1 - self.beta1), _F(self.beta2),
            _F(1 - self.beta2), _F(1.0) / _F(self.bc1), _F(1.0) / _F(self.bc2),
            _F(self.eps), _F(self.weight_decay), _F(self.momentum)))


# float32 operations an element of each update rule: AdamW's as the kernels
# line has counted them since kernel B was written; SGD's clip (1), momentum
# (2) and decayed step (4); Lion's clip (1), interpolation and sign (4),
# moment (3) and decayed step (4)
UPDATE_OPS = {"adamw": 16, "sgd": 7, "lion": 12}


def norm_cost(leaves: Sequence[Tuple[int, torch.dtype]]) -> Tuple[int, int]:
    """(operations, bytes) of kernel A over gradients given as (numel,
    dtype): a multiply-add an element; each gradient read once, the norm
    and the clip factor written once."""
    n = sum(numel for numel, _ in leaves)
    return 2 * n, sum(numel * dt.itemsize for numel, dt in leaves) + 8


def update_cost(rule: str, leaves: Sequence[Tuple[int, torch.dtype, torch.dtype]],
                scaled: bool = True) -> Tuple[int, int]:
    """(operations, bytes) of kernel B over leaves given as (numel, param
    dtype, state dtype): each param read and written, its gradient read, and
    each moment (two for AdamW, one else) read and written once, plus the
    clip factor when ``scaled``."""
    moments = 2 if rule == "adamw" else 1
    nbytes = sum(numel * (3 * p.itemsize + 2 * moments * s.itemsize) for numel, p, s in leaves)
    ops = UPDATE_OPS[rule] * sum(numel for numel, _, _ in leaves)
    return ops, nbytes + (4 if scaled else 0)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def sumsq_reference(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ over every tensor of Σ x², in float32, on the device (kernel A's
    pass)."""
    return sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors)


def global_norm_reference(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over every tensor of Σ x²), in float32, on the device."""
    return torch.sqrt(sumsq_reference(tensors))


def clip_scale_reference(norm: torch.Tensor, max_norm: Optional[float]) -> torch.Tensor:
    if max_norm is None:
        return torch.ones_like(norm)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def norm_finish_reference(total: torch.Tensor, max_norm: Optional[float]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(√total, the clip factor): kernel A's finish on a sum of squares."""
    norm = torch.sqrt(total)
    return norm, clip_scale_reference(norm, max_norm)


def grad_norm_reference(grads: Sequence[torch.Tensor], max_norm: Optional[float],
                        reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``grad_norm``'s plain version; with ``reduce`` the split: this
    rank's sum of squares (0 over no leaf, on ``device``), reduced, then
    the finish."""
    if reduce is None:
        norm = global_norm_reference(grads)
        return norm, clip_scale_reference(norm, max_norm)
    partial = sumsq_reference(grads) if grads else torch.zeros(
        (), dtype=torch.float32, device=device)
    return norm_finish_reference(reduce(partial), max_norm)


def scale_grads(grads: Sequence[torch.Tensor], scale: torch.Tensor) -> List[torch.Tensor]:
    """JAX's clip: ``(g.f32 * scale).astype(g.dtype)`` for every leaf."""
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads]


@torch.no_grad()
def update_reference(rule: str, params, grads, m, v, hp: Hyper,
                     scale: Optional[torch.Tensor] = None) -> None:
    """The per-leaf update in float32, cast back to each parameter's and
    moment's dtype, in place; ``grads`` are clipped by ``scale`` first
    when it is given."""
    if scale is not None:
        grads = scale_grads(grads, scale)
    f32 = torch.float32
    if rule == "adamw":
        for p, g, mi, vi in zip(params, grads, m, v):
            gf = g.to(f32)
            m_new = hp.beta1 * mi.to(f32) + (1 - hp.beta1) * gf
            v_new = hp.beta2 * vi.to(f32) + (1 - hp.beta2) * gf * gf
            upd = (m_new / hp.bc1) / (torch.sqrt(v_new / hp.bc2) + hp.eps)
            upd = upd + hp.weight_decay * p.to(f32)
            p.copy_((p.to(f32) - hp.lr * upd).to(p.dtype))
            mi.copy_(m_new.to(mi.dtype))
            vi.copy_(v_new.to(vi.dtype))
    elif rule == "sgd":
        for p, g, mi in zip(params, grads, m):
            m_new = hp.momentum * mi.to(f32) + g.to(f32)
            p.copy_((p.to(f32) - hp.lr * (m_new + hp.weight_decay * p.to(f32))).to(p.dtype))
            mi.copy_(m_new.to(mi.dtype))
    elif rule == "lion":
        for p, g, mi in zip(params, grads, m):
            gf, mf = g.to(f32), mi.to(f32)
            upd = torch.sign(hp.beta1 * mf + (1 - hp.beta1) * gf)
            m_new = hp.beta2 * mf + (1 - hp.beta2) * gf
            p.copy_((p.to(f32) - hp.lr * (upd + hp.weight_decay * p.to(f32))).to(p.dtype))
            mi.copy_(m_new.to(mi.dtype))
    else:
        raise ValueError(f"unknown update rule '{rule}' (have {RULES})")


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of ``csrc/fused_optim.cu``, built at first use."""
    lib = build.load("fused_optim").lib
    lib.fused_optim_chunk_elems.argtypes = []
    lib.fused_optim_chunk_elems.restype = ctypes.c_int
    lib.fused_optim_blocks_per_sm.argtypes = []
    lib.fused_optim_blocks_per_sm.restype = ctypes.c_int
    lib.fused_optim_norm_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_optim_norm_launch.restype = ctypes.c_int
    lib.fused_optim_sumsq_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.fused_optim_sumsq_launch.restype = ctypes.c_int
    lib.fused_optim_finish_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_optim_finish_launch.restype = ctypes.c_int
    lib.fused_optim_update_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_float] * 10 + [ctypes.c_void_p])
    lib.fused_optim_update_launch.restype = ctypes.c_int
    return lib


def _grid(lib, chunks: int, device) -> int:
    """Blocks for a launch over ``chunks`` chunks on ``device``'s card: at
    most the library's blocks per SM for each of its SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(chunks, sms * lib.fused_optim_blocks_per_sm())


def _addr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _leaf_table(rows: List[Tuple[Optional[torch.Tensor], ...]], flags: List[int],
                chunk: int, device) -> Tuple[torch.Tensor, int]:
    """The device leaf table: per row ``(p, g, m, v)`` tensors (None where
    absent) → int64 ``[p, g, m, v, numel, first chunk, flags]``, with bit 0
    of the flags set when every address is 16-byte aligned. Built in pinned
    memory and copied on the current stream (no host sync). Returns the
    table and the launch's chunk count."""
    table = np.empty((len(rows), 7), dtype=np.int64)
    chunks = 0
    for i, (tensors, flag) in enumerate(zip(rows, flags)):
        addrs = [_addr(t) for t in tensors]
        n = next(t for t in tensors if t is not None).numel()
        aligned = all(a % 16 == 0 for a in addrs)
        table[i] = (*addrs, n, chunks, flag | int(aligned))
        chunks += -(-n // chunk)
    host = torch.from_numpy(table).pin_memory()
    return host.to(device, non_blocking=True), chunks


def _check_leaves(what: str, **lists) -> None:
    for arg, tensors in lists.items():
        for i, t in enumerate(tensors):
            if t.dtype not in _DTYPES:
                raise TypeError(f"{what}: {arg}[{i}] must be bfloat16 or float32 (got {t.dtype})")
            if not t.is_contiguous():
                raise ValueError(f"{what}: {arg}[{i}] must be contiguous")


def grad_norm(grads: Sequence[torch.Tensor], max_norm: Optional[float],
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(norm, scale)``: kernel A on CUDA tensors, the plain version on CPU
    tensors. With ``reduce`` (0-d float32 → its sum over the ranks) the
    norm is global: ``grads`` are the leaves this rank counts (none is
    allowed; then ``device`` places the rank's zero), their sum of squares
    is reduced between A's pass and its finish."""
    grads = [g for g in grads if g.numel()]
    if not grads and reduce is None:
        raise ValueError("grad_norm needs at least one non-empty gradient")
    dev = grads[0].device if grads else torch.device(device)
    # a rank that counts no leaf routes on its (empty) output
    operands = grads or [torch.empty(2, dtype=torch.float32, device=dev)]
    if not build.route("grad_norm", *operands):
        return grad_norm_reference(grads, max_norm, reduce, dev)
    _check_leaves("grad_norm", grads=grads)
    has_clip, clip = int(max_norm is not None), 0.0 if max_norm is None else float(max_norm)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if build.abstract("grad_norm", lambda: norm_cost([(g.numel(), g.dtype) for g in grads]),
                      operands[0]):
        if reduce is not None:
            reduce(out[:1])
        return out[0], out[1]
    lib = _lib()
    if grads:
        table, chunks = _leaf_table([(None, g, None, None) for g in grads],
                                    [2 if g.dtype == torch.bfloat16 else 0 for g in grads],
                                    lib.fused_optim_chunk_elems(), dev)
        grid = _grid(lib, chunks, dev)
        partials = torch.empty(grid, dtype=torch.float32, device=dev)
    if reduce is None:
        build.call(lib.fused_optim_norm_launch, "grad_norm", dev, (table, partials, out),
                   (len(grads), chunks, grid, clip, has_clip))
    else:
        if grads:
            build.call(lib.fused_optim_sumsq_launch, "grad_norm (sum of squares)", dev,
                       (table, partials, out), (len(grads), chunks, grid))
        else:
            out[0].zero_()
        total = reduce(out[:1]).contiguous()
        build.call(lib.fused_optim_finish_launch, "grad_norm (finish)", dev, (total, out),
                   (clip, has_clip))
    grad_norm.launches += 1
    return out[0], out[1]


def optimizer_update(rule: str, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     m: Sequence[torch.Tensor], v: Optional[Sequence[torch.Tensor]],
                     hp: Hyper, scale: Optional[torch.Tensor] = None) -> None:
    """One step of ``rule`` in place: kernel B on CUDA tensors (one launch
    per (param dtype, state dtype) group), the plain version on CPU tensors
    (one call per group, leaf by leaf). ``v`` is AdamW's second moment
    (None for SGD and Lion)."""
    if rule not in RULES:
        raise ValueError(f"unknown update rule '{rule}' (have {RULES})")
    if (v is None) != (rule != "adamw"):
        raise ValueError(f"{rule}: v must be {'given' if rule == 'adamw' else 'None'}")
    vs = list(v) if v is not None else [None] * len(params)
    lists = [list(params), list(grads), list(m), vs]
    if len({len(x) for x in lists}) != 1:
        raise ValueError(f"{rule}: params, grads and state differ in length")
    flat = [t for x in lists for t in x if t is not None]
    if scale is not None:
        flat.append(scale)
    if build.placement("optimizer_update", *flat):
        tensors = dict(params=lists[0], grads=lists[1], m=lists[2])
        if v is not None:
            tensors["v"] = vs
        _check_leaves(rule, **tensors)
        for i, (p, g, mi, vi) in enumerate(zip(*lists)):
            if g.dtype != p.dtype or g.shape != p.shape or mi.shape != p.shape or \
                    (vi is not None and (vi.shape != p.shape or vi.dtype != mi.dtype)):
                raise ValueError(f"{rule}: leaf {i}: grad, m and v must match the param's "
                                 f"shape (grad also its dtype, v m's dtype)")
        if scale is not None and (scale.dtype != torch.float32 or scale.numel() != 1):
            raise ValueError("scale must be a float32 device scalar")
    groups: Dict[Tuple[torch.dtype, torch.dtype], List[Tuple[torch.Tensor, ...]]] = {}
    for row in zip(*lists):
        if row[0].numel():
            groups.setdefault((row[0].dtype, row[2].dtype), []).append(row)
    for (pdt, sdt), rows in groups.items():
        group = [t for row in rows for t in row if t is not None]
        if not build.route("optimizer_update", *group, *([] if scale is None else [scale])):
            p_, g_, m_, v_ = (list(x) for x in zip(*rows))
            update_reference(rule, p_, g_, m_, v_ if v is not None else None, hp, scale)
            continue
        if build.abstract("optimizer_update", lambda: update_cost(
                rule, [(row[0].numel(), pdt, sdt) for row in rows], scale is not None),
                rows[0][0]):
            continue
        lib, dev = _lib(), rows[0][0].device
        table, chunks = _leaf_table(rows, [0] * len(rows), lib.fused_optim_chunk_elems(), dev)
        build.call(lib.fused_optim_update_launch, f"optimizer_update ({rule})", dev,
                   (table, scale),
                   (RULES.index(rule), int(pdt == torch.bfloat16), int(sdt == torch.bfloat16),
                    len(rows), chunks, _grid(lib, chunks, dev), *hp.kernel_args()))
        optimizer_update.launches += 1


# kernel launches, counted where they happen
grad_norm.launches = 0
optimizer_update.launches = 0
