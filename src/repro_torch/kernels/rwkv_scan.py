"""The RWKV6 WKV recurrence and its gradient: two hand-written Hopper
kernels and their plain PyTorch versions.

The port of the JAX package's ``rwkv_scan_pallas``
(``repro/kernels/rwkv_scan.py``, ``_rwkv_kernel``). Per stream (one batch
row and head), with the state ``S`` (D, D) indexed ``[k-dim i, v-dim j]``
and ``S₀ = 0``::

    o_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Layouts are the JAX function's: r, k, v, w (BH, T, D) float32, u (BH, D)
float32, o (BH, T, D) float32.

* ``rwkv_scan_forward`` → ``(o, states)`` launches ``rwkv_fwd_kernel`` of
  ``csrc/rwkv_scan.cu`` for CUDA tensors and counts it in
  ``rwkv_scan.launches``. With ``save_states`` the kernel also writes the
  state at the start of every ``TIME_TILE`` steps, ``states (BH,
  n_tiles(T), D, D)``, which the backward kernel recomputes from; without
  it (the no-grad selection forward) it writes none.
* ``rwkv_scan_backward`` → ``(dr, dk, dv, dw, du)`` launches
  ``rwkv_bwd_kernel`` (one launch for all five; ``du`` per stream) and
  counts it in ``rwkv_scan_backward.launches``. The JAX package has no
  backward kernel: it differentiates ``lax.scan``.
* ``rwkv_scan`` is the differentiable function (``_RwkvScan``): the
  forward saves the inputs and the tile states, the backward runs the
  backward kernel.

The kernels walk T one step at a time, a block per stream (and per 64
columns of S): the forward in 4 warps, a thread holding 8 rows × 4 columns
of the state, with the bonus ``Σ r u k`` summed once per step; the backward
in 8 warps, a thread holding 2 rows × 8 columns of S and dS, recomputing 8
steps' states at a time from the tile state into registers (never dividing
by w). Both sum across lanes and warps in a fixed order, without atomics,
so reruns are bit-equal. ``csrc/rwkv_scan.cu`` says what bounds each.

CPU tensors run the plain versions, ``rwkv_scan_reference`` (the per-step
loop of ``ref.rwkv_chunk_ref``) and ``rwkv_scan_backward_reference`` (the
explicit reverse loop); anything else raises. The kernels take any T and
D; the wrappers refuse only a D whose block the JAX kernel's own VMEM
estimate (``analysis/smem.py`` ``rwkv_forward_vmem``) puts above the
package's 12 MB budget.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.analysis import smem
from repro_torch.kernels import build

# time steps per tile: the forward saves the state at the start of each
# tile and the backward stages this many steps in shared memory (kTile in
# csrc/rwkv_scan.cu)
TIME_TILE = smem.RWKV_TIME_TILE


def n_tiles(T: int) -> int:
    return -(-T // TIME_TILE)


def library_smem_bytes() -> int:
    """The C library's own sum for one backward block (``BwdSmem``);
    ``analysis/smem.py`` ``rwkv_backward_smem`` mirrors it."""
    return _launchers()["backward_smem_bytes"]()


def cost(kind: str, BH: int, T: int, D: int) -> Tuple[int, int]:
    """(operations, bytes) of the function, whatever computes it, on ``BH``
    streams (a head-parallel time mix's rank: its rows × its heads). Bytes:
    each input read and each output written once — forward r, k, v, w, u →
    o; backward r, k, v, w, u, do → dr, dk, dv, dw, du (the tile states the
    kernels save and reload are a design's intermediate). Float32
    operations per state element per step: forward 5 (r·S 2, the decay
    update and k·vᵀ 3) plus 5 per step and k-row for the bonus (Σ r u k,
    then its multiple of v); backward 14 (one recompute of S, the dS
    update, and the dr, dk, dv, dw sums) plus 16 per step and row for c,
    the u terms, du and Σ r u k."""
    stream, vec = BH * T * D * 4, BH * D * 4
    if kind == "fwd":
        return BH * T * (5 * D * D + 5 * D), 5 * stream + vec
    return BH * T * (14 * D * D + 16 * D), 9 * stream + 2 * vec


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def rwkv_scan_reference(r, k, v, w, u) -> torch.Tensor:
    """The recurrence step by step, every stream at once (the twin of
    ``ref.rwkv_chunk_ref``)."""
    BH, T, D = r.shape
    S = r.new_zeros((BH, D, D))
    outs = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bi,bij->bj", r[:, t], S + u[:, :, None] * kv))
        S = S * w[:, t, :, None] + kv
    return torch.stack(outs, dim=1) if outs else r.new_zeros((BH, 0, D))


def rwkv_scan_backward_reference(r, k, v, w, u, do):
    """The gradient by the explicit reverse loop, with ``dS`` the adjoint of
    ``S_t`` (0 after the last step) and ``c = v_t·do_t``::

        dr_t = S_{t-1} do_t + u ⊙ k_t c      dw_t = rowsum(dS ⊙ S_{t-1})
        dk_t = dS v_t + u ⊙ r_t c             du  += r_t ⊙ k_t c
        dv_t = dSᵀ k_t + (Σ_i r_t u k_t) do_t
        dS   ← diag(w_t) dS + r_t do_tᵀ

    Returns ``(dr, dk, dv, dw, du)``, ``du`` (BH, D) per stream."""
    BH, T, D = r.shape
    prev = []                                   # S_{t-1} for every t
    S = r.new_zeros((BH, D, D))
    for t in range(T):
        prev.append(S)
        S = S * w[:, t, :, None] + k[:, t, :, None] * v[:, t, None, :]
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    dS = r.new_zeros((BH, D, D))
    for t in reversed(range(T)):
        rt, kt, vt, wt, dot = r[:, t], k[:, t], v[:, t], w[:, t], do[:, t]
        c = torch.sum(vt * dot, dim=-1, keepdim=True)
        dr[:, t] = torch.einsum("bij,bj->bi", prev[t], dot) + u * kt * c
        du += rt * kt * c
        dw[:, t] = torch.sum(dS * prev[t], dim=-1)
        dk[:, t] = torch.einsum("bij,bj->bi", dS, vt) + u * rt * c
        dv[:, t] = torch.einsum("bij,bi->bj", dS, kt) + \
            torch.sum(rt * u * kt, dim=-1, keepdim=True) * dot
        dS = dS * wt[:, :, None] + rt[:, :, None] * dot[:, None, :]
    return dr, dk, dv, dw, du


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(r, k, v, w, u, do=None) -> Tuple[int, int, int]:
    if r.ndim != 3 or u.ndim != 2:
        raise ValueError(f"expected r/k/v/w (BH, T, D) and u (BH, D); got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w), ("do", r if do is None else do)):
        if t.shape != r.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != r {tuple(r.shape)}")
    BH, T, D = r.shape
    if u.shape != (BH, D):
        raise ValueError(f"u shape {tuple(u.shape)} != ({BH}, {D})")
    est = smem.rwkv_forward_vmem(D)
    if not est.fits:
        raise ValueError(
            f"rwkv_scan blocks at D={D} ({est.total / 2**20:.1f} MB: four "
            f"(32, D) streams, the (D, D) state and the output) exceed the "
            f"{est.budget / 2**20:.0f} MB VMEM budget of the JAX kernel")
    return BH, T, D


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points of ``csrc/rwkv_scan.cu``, built at first use;
    every pointer and the stream as ``c_void_p``."""
    lib = build.load("rwkv_scan").lib
    sigs = {"forward": (lib.rwkv_scan_forward_launch, 7),
            "backward": (lib.rwkv_scan_backward_launch, 12)}
    for fn, n_ptrs in sigs.values():
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rwkv_scan_backward_smem_bytes.argtypes = []
    lib.rwkv_scan_backward_smem_bytes.restype = ctypes.c_int
    launchers = {name: fn for name, (fn, _) in sigs.items()}
    launchers["backward_smem_bytes"] = lib.rwkv_scan_backward_smem_bytes
    return launchers


def rwkv_scan_forward(r, k, v, w, u, *, save_states: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(o, states)``: the forward kernel on CUDA tensors (float32,
    contiguous, else it raises), with the tile states when ``save_states``;
    the plain version on CPU tensors (``states`` is then None)."""
    BH, T, D = _check(r, k, v, w, u)
    if not build.route("rwkv_scan", r, k, v, w, u):
        return rwkv_scan_reference(r, k, v, w, u), None
    build.check_kernel_operands(r=r, k=k, v=v, w=w, u=u)
    o = torch.empty_like(r)
    states = torch.empty((BH, n_tiles(T), D, D), dtype=torch.float32,
                         device=r.device) if save_states else None
    if build.abstract("rwkv_scan", lambda: cost("fwd", BH, T, D), r):
        return o, states
    if BH and T:
        build.call(_launchers()["forward"], "rwkv_scan forward", r.device,
                   (r, k, v, w, u, o, states), (BH, T, D))
        rwkv_scan.launches += 1
    return o, states


def rwkv_scan_backward(r, k, v, w, u, do, states: Optional[torch.Tensor] = None):
    """``(dr, dk, dv, dw, du)``: the backward kernel on CUDA tensors, which
    needs the forward's ``states``; the plain version on CPU tensors."""
    BH, T, D = _check(r, k, v, w, u, do)
    if not build.route("rwkv_scan_backward", r, k, v, w, u, do):
        return rwkv_scan_backward_reference(r, k, v, w, u, do)
    if states is None or states.shape != (BH, n_tiles(T), D, D) or states.device != r.device:
        raise ValueError(f"the backward kernel needs the forward's tile states "
                         f"({BH}, {n_tiles(T)}, {D}, {D}) on {r.device}; got "
                         f"{None if states is None else (tuple(states.shape), states.device)}")
    build.check_kernel_operands(r=r, k=k, v=v, w=w, u=u, do=do, states=states)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    if build.abstract("rwkv_scan_backward", lambda: cost("bwd", BH, T, D), r):
        return dr, dk, dv, dw, du
    if BH and T:
        build.call(_launchers()["backward"], "rwkv_scan backward", r.device,
                   (r, k, v, w, u, do, states, dr, dk, dv, dw, du), (BH, T, D))
        rwkv_scan_backward.launches += 1
    else:
        du.zero_()
    return dr, dk, dv, dw, du


class _RwkvScan(torch.autograd.Function):
    """The forward saves r, k, v, w, u and (on the card) the tile states,
    but only when a gradient is wanted; the backward is one kernel launch
    and returns ``du`` per stream (the caller's expand sums it)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        o, states = rwkv_scan_forward(r, k, v, w, u,
                                      save_states=any(ctx.needs_input_grad))
        ctx.save_for_backward(r, k, v, w, u, states)
        return o

    @staticmethod
    def backward(ctx, do):
        r, k, v, w, u, states = ctx.saved_tensors
        return rwkv_scan_backward(r, k, v, w, u, do.contiguous(), states)


def rwkv_scan(r, k, v, w, u) -> torch.Tensor:
    """The recurrence over r, k, v, w (BH, T, D) and u (BH, D) → o (BH, T,
    D) float32. Differentiable in all five inputs."""
    return _RwkvScan.apply(r, k, v, w, u)


# kernel launches, counted where they happen
rwkv_scan.launches = 0
rwkv_scan_backward.launches = 0
