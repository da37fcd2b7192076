"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions.

The port of the JAX package's ``repro/kernels/flash_attention.py``: causal
(or bidirectional) online-softmax attention with a sliding window ``w``
(keys with ``k > q - w`` stay; ``w >= T`` is a no-op), an optional logit
softcap, GQA by reading kv stream ``bh // group``, and the masked-row guard
(a row whose whole horizon is masked gets output 0 and ``lse = +inf``).
Layouts are the JAX function's: q (B·H, Sq, Dh), k/v (B·Hkv, T, Dh),
head-major, so q stream ``i`` reads kv stream ``i // group``. Beyond the
JAX function, ``q_offset`` places local q row ``i`` at key position
``q_offset + i`` (causal ``k <= q_offset + i``, window ``k > q_offset + i -
w``): a sequence-parallel rank's query slice against the whole K/V. At 0 it
is the JAX mask.

* ``flash_forward`` → ``(o, lse)`` (TPU kernel ``_forward``),
  ``flash_dq`` → ``dq`` and ``flash_dkv`` → ``(dk, dv)`` (the two kernels of
  ``_backward``). CUDA tensors launch ``csrc/flash_attention.cu`` and count
  the launch in ``flash_attention.forward_launches`` / ``.dq_launches`` /
  ``.dkv_launches``; a refused shape or a failed launch raises, nothing falls
  back to the plain version. CPU tensors run ``flash_forward_reference``,
  ``flash_dq_reference`` and ``flash_dkv_reference``.
* Which kernel a CUDA launch takes is fixed by the input type, with no
  fallback between them: bf16 runs the tensor-core kernels
  (``flash_fwd_mma_kernel``, ``flash_dq_mma_kernel``,
  ``flash_dkv_mma_kernel``: ``mma.sync`` on bf16 tiles staged by
  ``cp.async``; the forward and dK/dV round P to bf16 once before its
  products, dQ and dK feed dS·K and dSᵀ·Q with dS as a bf16 hi + lo
  pair); float32
  runs the float32 CUDA-core kernels. Both count under the same launch
  counters.
* The CUDA source owns the kernels' tile plans and sizes each launch's
  shared memory itself (``plan_smem_bytes`` asks it, on the card).
  ``analysis/smem.py`` (``flash_smem``, ``flash_feasible``) sums the same
  plans for the router without the library.
* ``flash_attention`` is the differentiable function (``_FlashAttention``,
  the port of ``_make_flash_fn``'s ``custom_vjp``): the forward saves q, k,
  v, o and lse; the backward computes ``delta = Σ o·do`` in float32 and runs
  dQ, then dK/dV. The window gets no gradient.

Unlike the TPU kernel, which keeps the whole K/V stream in VMEM under a
12 MB guard, the Hopper kernels tile KV, so T is not limited; what they
refuse is a head dim above ``MAX_HEAD_DIM`` or a type other than bf16/f32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import smem
from repro_torch.kernels import build

_MASK = -1e30
_MASK_GUARD = -0.5e30
MAX_HEAD_DIM = smem.FLASH_MAX_HEAD_DIM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = smem.FLASH_KINDS              # the C source's Kind: 0, 1, 2


def plan_smem_bytes(kind: str, head_dim: int, dtype) -> int:
    """Dynamic shared memory of one block of ``kind`` for inputs of
    ``dtype``, as the CUDA source plans it (``flash_smem_bytes``; builds the
    library at first use, so it needs ``nvcc``). ``analysis/smem.py``
    ``flash_smem`` mirrors it."""
    if kind not in _KINDS or dtype not in _DTYPE_CODES:
        raise ValueError(f"no flash kernel for kind {kind!r} in {dtype}")
    n = _launchers()["smem"](_KINDS.index(kind), _DTYPE_CODES[dtype], int(head_dim))
    if n < 0:
        raise ValueError(f"no flash plan at head_dim {head_dim}")
    return n


def unmasked_pairs(Sq: int, T: int, causal: bool, window, q_offset: int = 0) -> int:
    """The (q, k) pairs of one stream that the mask keeps: the work the
    inputs need (a fully masked pair needs none). Local q row i sits at
    position ``q_offset + i``."""
    q = np.arange(Sq, dtype=np.int64) + int(q_offset)
    hi = np.minimum(q, T - 1) if causal else np.full(Sq, T - 1)
    lo = np.maximum(0, q - int(window) + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(kind: str, BH: int, BHkv: int, Sq: int, T: int, Dh: int, dtype,
         causal: bool = True, window=None, q_offset: int = 0) -> Tuple[int, int]:
    """(operations, bytes) of one launch of ``kind`` (``fwd``, ``dq`` or
    ``dkv``), whatever computes it: on the unmasked pairs QKᵀ and PV forward,
    + dO·Vᵀ and dS·K for dQ, QKᵀ, dO·Vᵀ, Pᵀ·dO and dSᵀ·Q for dK/dV (2·Dh
    each a pair); each input read and each output written once: q, k, v →
    o, lse; q, do, k, v, lse, delta → dq; the same → dk, dv."""
    el = dtype.itemsize
    q_b, kv_b, row_b = BH * Sq * Dh * el, BHkv * T * Dh * el, BH * Sq * 4
    pairs = unmasked_pairs(Sq, T, causal, window, q_offset)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * Dh * BH * pairs
    nbytes = {"fwd": 2 * q_b + 2 * kv_b + row_b,
              "dq": 3 * q_b + 2 * kv_b + 2 * row_b,
              "dkv": 2 * q_b + 4 * kv_b + 2 * row_b}[kind]
    return flops, nbytes


# ---------------------------------------------------------------------------
# plain PyTorch versions (dense, float32)
# ---------------------------------------------------------------------------

def _mask(Sq: int, T: int, causal: bool, window: Optional[int], device,
          q_offset: int = 0) -> torch.Tensor:
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((Sq, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - int(window)
    return mask


def _scores(q, k, *, causal, window, softcap, group, scale, q_offset=0):
    """Scaled q (BH,Sq,Dh) f32, k repeated over the group (BH,T,Dh) f32, the
    masked (softcapped) scores (BH,Sq,T) and the mask (Sq,T)."""
    qs = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=0)
    s = qs @ kf.transpose(1, 2)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device, q_offset)
    return qs, kf, torch.where(mask, s, _MASK), mask


def _defaults(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_forward_reference(q, k, v, *, causal: bool = True, window=None,
                            softcap: Optional[float] = None, group: int = 1,
                            scale: Optional[float] = None, q_offset: int = 0):
    """Dense masked softmax in float32 → ``(o in q's type, lse f32)``.
    A fully masked row has ``lse = +inf`` and ``o = 0``."""
    scale = _defaults(q, scale)
    _, _, s, _ = _scores(q, k, causal=causal, window=window, softcap=softcap,
                         group=group, scale=scale, q_offset=q_offset)
    m = s.amax(dim=-1)
    p = torch.where(m[..., None] > _MASK_GUARD, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=0)
    o = (p @ vf) / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, math.inf))
    return o.to(q.dtype), lse


def _dscores(q, k, v, do, lse, delta, opts):
    qs, kf, s, mask = _scores(q, k, **opts)
    p = torch.exp(s - lse[..., None])                       # 0 where masked
    vf = v.to(torch.float32).repeat_interleave(opts["group"], dim=0)
    dp = do.to(torch.float32) @ vf.transpose(1, 2)
    ds = p * (dp - delta[..., None])
    if opts["softcap"] is not None:
        t = s / opts["softcap"]                             # tanh(s_raw / cap)
        ds = ds * torch.where(mask, 1.0 - t * t, 0.0)
    return qs, kf, p, ds


def flash_dq_reference(q, k, v, do, lse, delta, *, causal: bool = True,
                       window=None, softcap: Optional[float] = None,
                       group: int = 1, scale: Optional[float] = None, q_offset: int = 0):
    """dQ by recompute: ``p = exp(s - lse)``, ``ds = p (do vᵀ - delta)``
    (times ``1 - t²`` under a softcap), ``dq = ds k · scale``."""
    scale = _defaults(q, scale)
    _, kf, _, ds = _dscores(q, k, v, do, lse, delta, dict(
        causal=causal, window=window, softcap=softcap, group=group, scale=scale,
        q_offset=q_offset))
    return ((ds @ kf) * scale).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal: bool = True,
                        window=None, softcap: Optional[float] = None,
                        group: int = 1, scale: Optional[float] = None, q_offset: int = 0):
    """dK/dV by recompute: ``dk = dsᵀ q·scale``, ``dv = pᵀ do``, summed over
    the ``group`` q heads that share each kv stream."""
    scale = _defaults(q, scale)
    qs, _, p, ds = _dscores(q, k, v, do, lse, delta, dict(
        causal=causal, window=window, softcap=softcap, group=group, scale=scale,
        q_offset=q_offset))
    BHkv, T, Dh = k.shape
    dk = (ds.transpose(1, 2) @ qs).view(BHkv, group, T, Dh).sum(dim=1)
    dv = (p.transpose(1, 2) @ do.to(torch.float32)).view(BHkv, group, T, Dh).sum(dim=1)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points of ``csrc/flash_attention.cu``, built at first use,
    with their signatures: pointers and the stream ``c_void_p`` (a plain int
    would cut them to 32 bits), the softcap and scale ``c_float``."""
    lib = build.load("flash_attention").lib
    ints = [ctypes.c_int] * 9       # dtype, BH, BHkv, Sq, T, Dh, causal, window, q_start
    tail = [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fns = {"fwd": (lib.flash_fwd_launch, 5), "dq": (lib.flash_dq_launch, 7),
           "dkv": (lib.flash_dkv_launch, 8)}
    for fn, n_ptrs in fns.values():
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + ints + tail
        fn.restype = ctypes.c_int
    lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3      # kind, dtype, Dh
    lib.flash_smem_bytes.restype = ctypes.c_int
    return dict({name: fn for name, (fn, _) in fns.items()}, smem=lib.flash_smem_bytes)


def _check(q, k, v, group: int) -> Tuple[int, int, int, int, int]:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (BH,Sq,Dh), k/v (BHkv,T,Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, Dh = q.shape
    BHkv, T = k.shape[0], k.shape[1]
    if BHkv * group != BH or k.shape[2] != Dh:
        raise ValueError(f"GQA shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"group={group}")
    if min(BH, Sq, T, Dh) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    return BH, BHkv, Sq, T, Dh


def _kernel_args(tensors, names, shapes, causal, window, softcap, scale,
                 bound_loop, q_offset: int = 0) -> list:
    """The wrapper's checks before a launch, then the C arguments after the
    pointers. Raises on what the kernel does not take; the C entry point
    refuses a grid or a tile plan past the card's limits."""
    BH, BHkv, Sq, T, Dh = shapes
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take bfloat16 or float32, got {dtype}")
    for name, t in zip(names, tensors):
        if t.dtype != (torch.float32 if name in ("lse", "delta") else dtype):
            raise TypeError(f"{name} is {t.dtype}; expected "
                            f"{'float32' if name in ('lse', 'delta') else dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} > {MAX_HEAD_DIM}: the Hopper flash kernels "
                         "keep their output accumulators in registers")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if not 0 <= q_offset < 2 ** 30:
        raise ValueError(f"q_offset must be in [0, 2^30), got {q_offset}")
    # a window past q_offset + Sq + T masks nothing, so clamping keeps the
    # int32 exact
    no_window = q_offset + Sq + T
    w = no_window if window is None else max(-no_window, min(int(window), no_window))
    return [_DTYPE_CODES[dtype], BH, BHkv, Sq, T, Dh, int(bool(causal)), w, int(q_offset),
            0.0 if softcap is None else float(softcap), float(scale),
            int(bool(bound_loop))]


def _launch(kind: str, ptrs, args, device) -> None:
    build.call(_launchers()[kind], f"flash {kind}", device, ptrs, args)


def flash_forward(q, k, v, *, causal: bool = True, window=None,
                  softcap: Optional[float] = None, group: int = 1,
                  scale: Optional[float] = None, bound_loop: bool = True,
                  q_offset: int = 0):
    """``(o, lse)``: the forward kernel on CUDA tensors, the plain version
    on CPU tensors. ``q_offset``: the key position of the first query."""
    shapes = _check(q, k, v, group)
    scale = _defaults(q, scale)
    if not build.route("flash_forward", q, k, v):
        return flash_forward_reference(q, k, v, causal=causal, window=window,
                                       softcap=softcap, group=group, scale=scale,
                                       q_offset=q_offset)
    args = _kernel_args((q, k, v), ("q", "k", "v"), shapes, causal, window,
                        softcap, scale, bound_loop, q_offset)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if build.abstract("flash_forward",
                      lambda: cost("fwd", *shapes, q.dtype, causal, window, q_offset), q):
        return o, lse
    _launch("fwd", (q, k, v, o, lse), args, q.device)
    flash_attention.forward_launches += 1
    return o, lse


def _check_grads_in(q, do, lse, delta):
    if do.shape != q.shape or lse.shape != q.shape[:2] or delta.shape != q.shape[:2]:
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)} do not match q {tuple(q.shape)}")


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True, window=None,
             softcap: Optional[float] = None, group: int = 1,
             scale: Optional[float] = None, bound_loop: bool = True, q_offset: int = 0):
    """dQ: the dQ kernel on CUDA tensors, the plain version on CPU tensors."""
    shapes = _check(q, k, v, group)
    _check_grads_in(q, do, lse, delta)
    scale = _defaults(q, scale)
    if not build.route("flash_dq", q, k, v, do, lse, delta):
        return flash_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                  window=window, softcap=softcap, group=group,
                                  scale=scale, q_offset=q_offset)
    args = _kernel_args((q, k, v, do, lse, delta),
                        ("q", "k", "v", "do", "lse", "delta"), shapes, causal,
                        window, softcap, scale, bound_loop, q_offset)
    dq = torch.empty_like(q)
    if build.abstract("flash_dq",
                      lambda: cost("dq", *shapes, q.dtype, causal, window, q_offset), q):
        return dq
    _launch("dq", (q, k, v, do, lse, delta, dq), args, q.device)
    flash_attention.dq_launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True, window=None,
              softcap: Optional[float] = None, group: int = 1,
              scale: Optional[float] = None, bound_loop: bool = True, q_offset: int = 0):
    """``(dk, dv)``: the dK/dV kernel on CUDA tensors, the plain version on
    CPU tensors."""
    shapes = _check(q, k, v, group)
    _check_grads_in(q, do, lse, delta)
    scale = _defaults(q, scale)
    if not build.route("flash_dkv", q, k, v, do, lse, delta):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal=causal,
                                   window=window, softcap=softcap, group=group,
                                   scale=scale, q_offset=q_offset)
    args = _kernel_args((q, k, v, do, lse, delta),
                        ("q", "k", "v", "do", "lse", "delta"), shapes, causal,
                        window, softcap, scale, bound_loop, q_offset)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if build.abstract("flash_dkv",
                      lambda: cost("dkv", *shapes, q.dtype, causal, window, q_offset), q):
        return dk, dv
    _launch("dkv", (q, k, v, do, lse, delta, dk, dv), args, q.device)
    flash_attention.dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """``custom_vjp`` of ``_make_flash_fn``: forward saves q, k, v, o, lse;
    backward recomputes through dQ then dK/dV. No gradient for the options
    (the window included)."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        o, lse = flash_forward(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.sum(o.to(torch.float32) * do.to(torch.float32), dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, **ctx.opts)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **ctx.opts)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap: Optional[float] = None, group: int = 1,
                    scale: Optional[float] = None, bound_loop: bool = True,
                    q_offset: int = 0):
    """Attention over q (B·H, Sq, Dh) and k/v (B·Hkv, T, Dh) with
    ``B·Hkv·group == B·H``; returns (B·H, Sq, Dh) in q's type.
    Differentiable. ``scale`` defaults to 1/sqrt(Dh) (pass 1.0 for
    pre-scaled queries); ``window`` is an int or None; ``q_offset`` is the
    key position of the first query (a sequence-parallel rank's slice)."""
    opts = dict(causal=bool(causal), window=None if window is None else int(window),
                softcap=None if softcap is None else float(softcap), group=int(group),
                scale=_defaults(q, scale), bound_loop=bool(bound_loop),
                q_offset=int(q_offset))
    return _FlashAttention.apply(q, k, v, opts)


# kernel launches, counted where they happen
flash_attention.forward_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
