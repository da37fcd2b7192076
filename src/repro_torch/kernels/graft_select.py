"""One whole GRAFT selection refresh, single and batched: the hand-written
Hopper kernel and its plain PyTorch version.

``graft_select(V, G, g_bar, rank)`` is the port of the JAX package's
``fused_graft_select_pallas`` (``repro/kernels/graft_select.py``): Fast
MaxVol pivots over ``V (K, R)``, the exact gather ``G_sel = G[:, pivots]``
and the CGS2 prefix projection errors of ``G_sel`` against ``ĝ``, plus the
log-volume. Returns ``(pivots (rank,) int32, errors (rank,) f32, logvol ()
f32, G_sel (d, rank) f32)``. ``graft_select_batched`` is the port of
``fused_graft_select_batched_pallas``: the same refresh for every row of a
``(B, K, R)`` stack in one launch, with a leading ``B`` on every output.

* For CUDA tensors they launch ``graft_select_kernel`` of
  ``csrc/graft_select.cu`` (one thread block per refresh, one launch for
  the whole stack) and count the launch in ``graft_select.launches`` or
  ``graft_select_batched.launches``. A build or launch failure raises;
  nothing falls back to the plain version.
* For CPU tensors they run ``graft_select_reference``, the same function as
  plain torch ops built from ``core.maxvol`` and ``core.projection``.

Both refuse what the JAX kernel refuses: the 12 MB VMEM estimate of
``fused_select_vmem`` (``K·R + d·K + 2·d·rank + K·rank`` float32 words).
Below it, two plans put the refresh's state in shared memory where it fits
one block and in a global scratch where it does not, each the same kernel
on another pointer with bit-equal results: MaxVol's working copy of V (the
W plan, ``choose_plan``) and the Gram-Schmidt basis ``Qᵀ (rank, d)`` with
``ĝ`` (the basis plan, ``choose_basis``, beside the W plan's choice).
The plans take the block's shared-memory sum from ``analysis/smem.py``
(``graft_select_smem``), which the C library's ``graft_select_smem_bytes``
computes too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.analysis import smem
from repro_torch.core import maxvol as maxvol_lib
from repro_torch.core import projection as proj_lib
from repro_torch.kernels import build

PLANS = smem.PLANS
choose_plan = smem.choose_plan
choose_basis = smem.choose_basis


def _check_budget(K: int, R: int, d: int, rank: int) -> None:
    est = smem.fused_select_vmem(K, R, d, rank)
    if not est.fits:
        raise ValueError(
            f"fused selection blocks ({est.total / 2**20:.1f} MB) exceed the "
            f"VMEM budget; shrink K={K}, d={d} or rank={rank}")


def maxvol_flops(K: int, R: int, rank: int) -> int:
    """Fast MaxVol's float32 operations: per pivot step a division per row
    and a multiply-subtract on every row of the columns still to pivot on."""
    return sum(K + 2 * K * (R - j - 1) for j in range(rank))


def sweep_flops(d: int, n: int) -> int:
    """The CGS2 sweep over n columns: two passes of coefficients + update
    per column, and its norm, normalisation and dot with ĝ."""
    return sum(2 * 4 * d * j + 6 * d for j in range(n))


def cost(K: int, R: int, d: int, rank: int, B: int = 1) -> Tuple[int, int]:
    """(operations, bytes) of B refreshes, whatever computes them: MaxVol
    and the sweep; V, G and ḡ read once and pivots, errors, logvol and
    G_sel written once, all 4-byte words."""
    nbytes = B * 4 * (K * R + d * K + d + rank + rank + 1 + d * rank)
    return B * (maxvol_flops(K, R, rank) + sweep_flops(d, rank)), nbytes


def graft_select_reference(V: torch.Tensor, G: torch.Tensor,
                           g_bar: torch.Tensor, rank: int):
    """The plain version: the fused function as torch ops on any device."""
    pivots, logvol = maxvol_lib.fast_maxvol(V, rank)
    G_sel = G.to(torch.float32).index_select(1, pivots)
    errors = proj_lib.prefix_projection_errors(G_sel, g_bar)
    return pivots, errors, logvol, G_sel


def graft_select_batched_reference(V: torch.Tensor, G: torch.Tensor,
                                   g_bar: torch.Tensor, rank: int):
    """The plain batched version: ``graft_select_reference`` per row,
    stacked."""
    rows = [graft_select_reference(V[b], G[b], g_bar[b], rank)
            for b in range(V.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*rows))


def _check(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
           rank: int) -> Tuple[int, int, int]:
    if V.ndim != 2 or G.ndim != 2 or g_bar.ndim != 1:
        raise ValueError(f"expected V (K,R), G (d,K), g_bar (d,); got "
                         f"{tuple(V.shape)}, {tuple(G.shape)}, {tuple(g_bar.shape)}")
    K, R = V.shape
    d, Kg = G.shape
    if Kg != K:
        raise ValueError(f"V rows {K} != G columns {Kg}")
    if g_bar.shape != (d,):
        raise ValueError(f"g_bar shape {tuple(g_bar.shape)} != ({d},)")
    if not 1 <= rank <= min(K, R):
        raise ValueError(f"rank {rank} not in [1, min{tuple(V.shape)}]")
    _check_budget(K, R, d, rank)
    return K, R, d


def _check_batched(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
                   rank: int) -> Tuple[int, int, int, int]:
    if V.ndim != 3 or G.ndim != 3 or g_bar.ndim != 2:
        raise ValueError(f"expected V (B,K,R), G (B,d,K), g_bar (B,d); got "
                         f"{tuple(V.shape)}, {tuple(G.shape)}, {tuple(g_bar.shape)}")
    B, K, R = V.shape
    _, d, Kg = G.shape
    if G.shape[0] != B or g_bar.shape != (B, d) or Kg != K:
        raise ValueError(f"inconsistent batch shapes V={tuple(V.shape)} "
                         f"G={tuple(G.shape)} g_bar={tuple(g_bar.shape)}")
    if rank > min(K, R):
        raise ValueError(f"rank {rank} > min({K}, {R})")
    if rank < 1 or B < 1:
        raise ValueError(f"rank {rank} and batch {B} must be at least 1")
    _check_budget(K, R, d, rank)
    return B, K, R, d


def resolve_plan(K: int, R: int, rank: int, plan: Optional[str]) -> str:
    """The W plan the shape needs, or the one the caller forces (tests and
    ``chip_smoke.py`` only: the two plans are held bit-equal there)."""
    if plan is None:
        return choose_plan(K, R, rank)
    if plan not in PLANS:
        raise ValueError(f"plan {plan!r} not in {PLANS}")
    est = smem.graft_select_smem(K, R, 0, rank, plan)
    if not est.fits:
        raise ValueError(
            f"the shared plan keeps V (K={K}, R={R}) in shared memory and needs "
            f"{est.total} bytes, above the {est.budget} bytes "
            "(227 KB) one Hopper thread block can use")
    return plan


def resolve_basis(K: int, R: int, d: int, rank: int, plan: str,
                  basis: Optional[str]) -> str:
    """The basis plan the shape needs beside W plan ``plan``, or the one the
    caller forces (tests and ``chip_smoke.py`` only, as ``plan``)."""
    if basis is None:
        return choose_basis(K, R, d, rank, plan)
    if basis not in PLANS:
        raise ValueError(f"basis {basis!r} not in {PLANS}")
    est = smem.graft_select_smem(K, R, d, rank, plan, basis)
    if not est.fits:
        raise ValueError(
            f"the shared basis keeps Qᵀ and ĝ (rank={rank}, d={d}) in shared memory "
            f"and needs {est.total} bytes beside the {plan} W plan, above the "
            f"{est.budget} bytes (227 KB) one Hopper thread block can use")
    return basis


@functools.lru_cache(maxsize=None)
def launchers():
    """The C entry points of ``csrc/graft_select.cu``, built at first use,
    with their signatures: every pointer and the stream as ``c_void_p`` (a
    plain int would cut them to 32 bits)."""
    from repro_torch.kernels import build
    lib = build.load("graft_select").lib
    sigs = {"graft_select": (lib.graft_select_launch, 9, 7),
            "fast_maxvol": (lib.fast_maxvol_launch, 4, 4),
            "projection_sweep": (lib.projection_sweep_launch, 5, 3)}
    for fn, n_ptrs, n_ints in sigs.values():
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    smem_sums = {"smem_bytes": (lib.graft_select_smem_bytes, 6),
                 "fast_maxvol_smem_bytes": (lib.fast_maxvol_smem_bytes, 4),
                 "projection_sweep_smem_bytes": (lib.projection_sweep_smem_bytes, 2)}
    for fn, n_ints in smem_sums.values():
        fn.argtypes = [ctypes.c_int] * n_ints
        fn.restype = ctypes.c_int
    return {**{name: fn for name, (fn, _) in smem_sums.items()},
            **{name: fn for name, (fn, _, _) in sigs.items()}}


def library_smem_bytes(K: int, R: int, d: int, rank: int, plan: str, basis: str) -> int:
    """The C library's own sum for one refresh block under the two plans
    (-1 above 227 KB); ``analysis/smem.py`` ``graft_select_smem`` mirrors it."""
    return launchers()["smem_bytes"](K, R, d, rank, int(plan == "global"),
                                     int(basis == "global"))


def launch(name: str, device: torch.device, pointers, ints) -> None:
    """Call one C entry point on the current stream of ``device``; a
    nonzero cudaError raises."""
    build.call(launchers()[name], name, device, pointers, ints)


def _launch(name: str, V, G, g_bar, rank: int, B: int, K: int, R: int, d: int,
            plan: Optional[str], basis: Optional[str]):
    build.check_kernel_operands(V=V, G=G, g_bar=g_bar)
    if B > 65535:
        raise ValueError(f"batch stack of {B} refreshes exceeds the grid's 65535 blocks")
    plan = resolve_plan(K, R, rank, plan)
    basis = resolve_basis(K, R, d, rank, plan, basis)
    dev = V.device
    pivots = torch.empty((B, rank), dtype=torch.int32, device=dev)
    errors = torch.empty((B, rank), dtype=torch.float32, device=dev)
    logvol = torch.empty(B, dtype=torch.float32, device=dev)
    G_sel = torch.empty((B, d, rank), dtype=torch.float32, device=dev)
    Qt = torch.empty(B * smem.basis_words(d, rank), dtype=torch.float32, device=dev) \
        if basis == "global" else None                                # Qᵀ and ĝ
    work = torch.empty(B * smem.work_words(K, R), dtype=torch.float32, device=dev) \
        if plan == "global" else None
    if build.abstract(name, lambda: cost(K, R, d, rank, B), V):
        return pivots, errors, logvol, G_sel
    launch("graft_select", dev, (V, G, g_bar, pivots, errors, logvol, G_sel, Qt, work),
           (B, K, R, d, rank, int(plan == "global"), int(basis == "global")))
    # the launch counts where it happens: graft_select or graft_select_batched
    {"graft_select": graft_select, "graft_select_batched": graft_select_batched}[name].launches += 1
    return pivots, errors, logvol, G_sel


def graft_select(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
                 rank: int, *, plan: Optional[str] = None,
                 basis: Optional[str] = None):
    """One refresh. V: (K, R); G: (d, K); g_bar: (d,). Returns
    ``(pivots, errors, logvol, G_sel)``. CUDA tensors go to the kernel
    (float32, contiguous, else it raises); CPU tensors to the plain version.
    ``plan`` and ``basis`` force the shared or global W and basis plans;
    leave them ``None``."""
    K, R, d = _check(V, G, g_bar, rank)
    if not build.route("graft_select", V, G, g_bar):
        return graft_select_reference(V, G, g_bar, rank)
    pivots, errors, logvol, G_sel = _launch("graft_select", V, G, g_bar, rank, 1, K, R, d,
                                            plan, basis)
    return pivots[0], errors[0], logvol[0], G_sel[0]


def graft_select_batched(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
                         rank: int):
    """A stack of refreshes in one launch. V: (B, K, R); G: (B, d, K);
    g_bar: (B, d). Returns ``(pivots (B, rank), errors (B, rank), logvol
    (B,), G_sel (B, d, rank))``, row ``b`` equal to ``graft_select`` on row
    ``b``. CUDA tensors go to the kernel; CPU tensors to the plain version."""
    B, K, R, d = _check_batched(V, G, g_bar, rank)
    if not build.route("graft_select_batched", V, G, g_bar):
        return graft_select_batched_reference(V, G, g_bar, rank)
    return _launch("graft_select_batched", V, G, g_bar, rank, B, K, R, d, None, None)


# kernel launches, counted where they happen
graft_select.launches = 0
graft_select_batched.launches = 0
