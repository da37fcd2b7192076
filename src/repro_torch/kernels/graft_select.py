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
Below it, MaxVol's working copy of V runs in shared memory when
``smem_bytes(K, R, rank)`` fits one block (the "shared" plan) and in a
global scratch otherwise (the "global" plan): the same kernel on another
pointer, with bit-equal results.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import maxvol as maxvol_lib
from repro_torch.core import projection as proj_lib
from repro_torch.kernels import build

# what one Hopper thread block can address as shared memory (227 KB)
SMEM_LIMIT_BYTES = 232_448
# the JAX package's per-program VMEM budget (analysis/vmem.py)
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
_WARPS = 8        # csrc/graft_select.cu kThreads / 32
PLANS = ("shared", "global")


def work_words(K: int, R: int) -> int:
    """MaxVol's working set in float32 words: W (K·R), the per-row factor
    and availability (K each) and the pivot row (R) — ``work_words`` in
    ``csrc/graft_select.cu``."""
    return K * R + 2 * K + R


def smem_bytes(K: int, R: int, rank: int, plan: str = "shared") -> int:
    """Dynamic shared memory of one refresh block — the same sum as
    ``smem_words`` in ``csrc/graft_select.cu``: under the shared plan V's
    working copy (K·R floats) dominates; the rest is per-rank and per-warp
    scratch, which stays in shared memory under both plans."""
    rest = (_WARPS + 2) * rank + 2 * _WARPS + 2
    return 4 * ((work_words(K, R) if plan == "shared" else 0) + rest)


def choose_plan(K: int, R: int, rank: int) -> str:
    """``"shared"`` when the working set fits one block's shared memory,
    else ``"global"``."""
    return "shared" if smem_bytes(K, R, rank) <= SMEM_LIMIT_BYTES else "global"


def fused_budget_bytes(K: int, R: int, d: int, rank: int) -> int:
    """The JAX package's ``fused_select_vmem`` total: V, G, G_sel + Q and
    the one-hot, float32."""
    return 4 * (K * R + d * K + 2 * d * rank + K * rank)


def _check_budget(K: int, R: int, d: int, rank: int) -> None:
    total = fused_budget_bytes(K, R, d, rank)
    if total > VMEM_BUDGET_BYTES:
        raise ValueError(
            f"fused selection blocks ({total / 2**20:.1f} MB) exceed the "
            f"VMEM budget; shrink K={K}, d={d} or rank={rank}")


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
    """The plan the shape needs, or the one the caller forces (tests and
    ``chip_smoke.py`` only: the two plans are held bit-equal there)."""
    if plan is None:
        return choose_plan(K, R, rank)
    if plan not in PLANS:
        raise ValueError(f"plan {plan!r} not in {PLANS}")
    if plan == "shared" and smem_bytes(K, R, rank) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"the shared plan keeps V (K={K}, R={R}) in shared memory and needs "
            f"{smem_bytes(K, R, rank)} bytes, above the {SMEM_LIMIT_BYTES} bytes "
            "(227 KB) one Hopper thread block can use")
    return plan


@functools.lru_cache(maxsize=None)
def launchers():
    """The C entry points of ``csrc/graft_select.cu``, built at first use,
    with their signatures: every pointer and the stream as ``c_void_p`` (a
    plain int would cut them to 32 bits)."""
    from repro_torch.kernels import build
    lib = build.load("graft_select").lib
    sigs = {"graft_select": (lib.graft_select_launch, 9, 7),
            "fast_maxvol": (lib.fast_maxvol_launch, 4, 5),
            "projection_sweep": (lib.projection_sweep_launch, 5, 4)}
    for fn, n_ptrs, n_ints in sigs.values():
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return {name: fn for name, (fn, _, _) in sigs.items()}


def launch(name: str, device: torch.device, pointers, ints) -> None:
    """Call one C entry point on the current stream of ``device``; a
    nonzero cudaError raises."""
    build.call(launchers()[name], name, device, pointers, ints)


def _launch(V, G, g_bar, rank: int, B: int, K: int, R: int, d: int,
            plan: Optional[str]):
    build.check_kernel_operands(V=V, G=G, g_bar=g_bar)
    if B > 65535:
        raise ValueError(f"batch stack of {B} refreshes exceeds the grid's 65535 blocks")
    plan = resolve_plan(K, R, rank, plan)
    dev = V.device
    pivots = torch.empty((B, rank), dtype=torch.int32, device=dev)
    errors = torch.empty((B, rank), dtype=torch.float32, device=dev)
    logvol = torch.empty(B, dtype=torch.float32, device=dev)
    G_sel = torch.empty((B, d, rank), dtype=torch.float32, device=dev)
    Qt = torch.empty((B, rank, d), dtype=torch.float32, device=dev)  # Qᵀ scratch
    work = torch.empty(B * work_words(K, R), dtype=torch.float32, device=dev) \
        if plan == "global" else None
    launch("graft_select", dev, (V, G, g_bar, pivots, errors, logvol, G_sel, Qt, work),
           (B, K, R, d, rank, int(plan == "global"), smem_bytes(K, R, rank, plan)))
    return pivots, errors, logvol, G_sel


def graft_select(V: torch.Tensor, G: torch.Tensor, g_bar: torch.Tensor,
                 rank: int, *, plan: Optional[str] = None):
    """One refresh. V: (K, R); G: (d, K); g_bar: (d,). Returns
    ``(pivots, errors, logvol, G_sel)``. CUDA tensors go to the kernel
    (float32, contiguous, else it raises); CPU tensors to the plain version.
    ``plan`` forces the shared or global plan; leave it ``None``."""
    K, R, d = _check(V, G, g_bar, rank)
    if not build.route("graft_select", V, G, g_bar):
        return graft_select_reference(V, G, g_bar, rank)
    pivots, errors, logvol, G_sel = _launch(V, G, g_bar, rank, 1, K, R, d, plan)
    graft_select.launches += 1
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
    out = _launch(V, G, g_bar, rank, B, K, R, d, None)
    graft_select_batched.launches += 1
    return out


# kernel launches, counted where they happen
graft_select.launches = 0
graft_select_batched.launches = 0
