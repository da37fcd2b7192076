"""Per-block shared memory and grid/block feasibility of the port's Hopper
kernels — the twin of the JAX package's ``analysis/vmem.py``.

One audited estimator instead of copies in each wrapper: the flash wrappers
and the attention router (``models/layers.py`` ``_flash_feasible``), the
refresh plans (``kernels/graft_select.py`` ``choose_plan`` /
``choose_basis`` / ``resolve_*``), ``fast_maxvol``, ``projection_sweep``
and the RWKV backward all take their numbers from the formulas here, so the
number a router plans with is the number the kernel launches with. Each sum
is the one the CUDA source computes for its launch; the C libraries export
those sums (``flash_smem_bytes``, ``graft_select_smem_bytes``,
``fast_maxvol_smem_bytes``, ``projection_sweep_smem_bytes``,
``rwkv_scan_backward_smem_bytes``), and ``python -m repro_torch.analysis``
holds the two against each other on the card.

The budget is what one Hopper thread block can address as dynamic shared
memory, 227 KB (``SMEM_LIMIT_BYTES``). The JAX package's own guards, kept
by the wrappers so that the port refuses what the reference refuses, are
VMEM estimates against its 12 MB per-program budget (``VMEM_BUDGET_BYTES``):
``fused_select_vmem`` and ``rwkv_forward_vmem``.

Rules: VM001 when a plan is over its budget (a forced ``shared`` plan that
``resolve_plan`` refuses, a head dim no flash plan serves); VM002 when a
block does not divide its extent (the JAX flash block ladder
``FLASH_BLOCKS``, ``T % chunk`` of the RWKV scan); VM003 an info note on
the headroom.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.analysis.report import Finding, Report

# what one Hopper thread block can address as shared memory (227 KB)
SMEM_LIMIT_BYTES = 232_448
# the JAX package's per-program VMEM budget (its analysis/vmem.py)
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
PLANS = ("shared", "global")


@dataclasses.dataclass(frozen=True)
class SmemEstimate:
    """Shared memory of one thread block of one kernel configuration."""
    kernel: str                     # "flash_dq(Dh=64, bfloat16)"
    parts: Dict[str, int]           # buffer → bytes
    budget: int = SMEM_LIMIT_BYTES

    @property
    def total(self) -> int:
        return sum(self.parts.values())

    @property
    def headroom(self) -> int:
        return self.budget - self.total

    @property
    def fits(self) -> bool:
        return self.total <= self.budget

    def describe(self) -> str:
        parts = ", ".join(f"{k}={v}" for k, v in sorted(self.parts.items()))
        return (f"{self.kernel}: {self.total} B a block ({parts}); headroom "
                f"{self.headroom} B of {self.budget} B")

    def report(self, location: str = "") -> Report:
        """VM001 on overflow, VM003 headroom note otherwise."""
        rep = Report()
        loc = location or self.kernel
        if not self.fits:
            rep.add(Finding(
                rule="VM001", location=loc,
                message=f"{self.total} B exceed the {self.budget} B budget "
                        f"({self.describe()})",
                fix_hint="take the global plan, or a smaller head dim / "
                         "rank / K; a forced shared plan is refused"))
        else:
            rep.add(Finding(rule="VM003", location=loc, message=self.describe()))
        return rep


def check_divisible(extent: int, block: int, axis: str,
                    location: str) -> Optional[Finding]:
    """VM002: a block that does not divide its extent drops or pads rows."""
    if block <= 0 or extent % block:
        return Finding(
            rule="VM002", location=location,
            message=f"block size {block} does not divide {axis}={extent}",
            fix_hint="pick a block from the divisor ladder "
                     "(analysis/smem.py FLASH_BLOCKS) or pad the operand")
    return None


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu plan_smem)
# ---------------------------------------------------------------------------

FLASH_KINDS = ("fwd", "dq", "dkv")          # the C source's Kind: 0, 1, 2
FLASH_DTYPES = ("float32", "bfloat16")      # the C source's dtype codes 0, 1
FLASH_MAX_HEAD_DIM = 256
# the JAX kernel's tile sizes: the router takes flash only where one divides
# the q and one the kv length (the JAX package's block rule)
FLASH_BLOCKS = (128, 64, 32, 16, 8)
_MMA_ROWS = 64                              # kBlockRows


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def flash_blocks(S: int, T: int) -> Tuple[Optional[int], Optional[int]]:
    """Largest block of the ladder dividing the q and kv lengths (None:
    none does)."""
    bq = next((b for b in FLASH_BLOCKS if S % b == 0), None)
    bk = next((b for b in FLASH_BLOCKS if T % b == 0), None)
    return bq, bk


def _f32_tile(head_dim: int) -> int:
    """Rows a tile of the float32-core kernels: 64, or 32 above head dim 160
    (``tile_of(nc_class)``)."""
    return 32 if head_dim > 160 else 64


def _padded(head_dim: int) -> int:
    """The bf16 kernels' padded head dim (``dp_class``)."""
    return next(dp for dp in (16, 32, 64, 128, 160, 256) if head_dim <= dp)


def flash_smem(kind: str, head_dim: int, dtype="bfloat16") -> SmemEstimate:
    """One block of flash kernel ``kind`` (fwd | dq | dkv) at ``head_dim``
    in ``dtype``. float32: tiles of (tile + 4) columns, ``head_dim`` rows a
    staged operand (``fwd_smem``/``dq_smem``/``dkv_smem``). bf16: rows of
    the padded head dim + 8, K and V (Q and dO for dK/dV) double-buffered
    (``fwd_mma_smem``/``dq_mma_smem``/``dkv_mma_smem``)."""
    name = _dtype_name(dtype)
    if kind not in FLASH_KINDS or name not in FLASH_DTYPES:
        raise ValueError(f"no flash kernel for kind {kind!r} in {name}")
    if not 1 <= head_dim <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"no flash plan at head_dim {head_dim} "
                         f"(1..{FLASH_MAX_HEAD_DIM})")
    label = f"flash_{kind}(Dh={head_dim}, {name})"
    if name == "float32":
        t = _f32_tile(head_dim)
        row = 4 * (t + 4)
        if kind == "fwd":
            parts = {"Qt,Kt,Vt": 3 * head_dim * row, "P": t * row}
        elif kind == "dq":
            parts = {"Qt,dOt,Kt,Vt": 4 * head_dim * row, "dS": t * row}
        else:
            parts = {"Kt,Vt,Qt,dOt": 4 * head_dim * row, "P,dS": 2 * t * row,
                     "lse,delta": 4 * 2 * t}
        return SmemEstimate(label, parts)
    dp = _padded(head_dim)
    row = 2 * (dp + 8)
    kv = 32 if dp > 160 else 64             # fwd_kv_rows
    if kind == "fwd":
        parts = {"Q": _MMA_ROWS * row, "K,V x2": 4 * kv * row}
    elif kind == "dq":
        parts = {"Q,dO": 2 * _MMA_ROWS * row, "K,V x2": 4 * kv * row}
    else:
        bq = 32 if dp >= 160 else 64        # dkv_q_rows
        parts = {"K,V": 2 * _MMA_ROWS * row, "Q,dO x2": 4 * bq * row,
                 "lse,delta x2": 4 * 4 * bq}
    return SmemEstimate(label, parts)


def flash_attention_report(S: int, T: int, head_dim: int, dtype="bfloat16") -> Report:
    """Full feasibility check for one flash shape: the JAX block rule
    (VM002 where no block of the ladder divides), a head dim and type some
    plan serves (VM001), and each kind's plan (VM001 / VM003)."""
    rep = Report()
    name = _dtype_name(dtype)
    loc = f"flash_attention(S={S}, T={T}, Dh={head_dim}, {name})"
    pick_q, pick_k = flash_blocks(S, T)
    for extent, block, axis in ((S, pick_q or 0, "Sq"), (T, pick_k or 0, "T")):
        f = check_divisible(extent, block, axis, loc)
        if f:
            rep.add(f)
    if not 1 <= head_dim <= FLASH_MAX_HEAD_DIM or name not in FLASH_DTYPES:
        rep.add(Finding(
            rule="VM001", location=loc,
            message=f"no flash plan serves head_dim {head_dim} in {name} "
                    f"(head dims 1..{FLASH_MAX_HEAD_DIM}, {'/'.join(FLASH_DTYPES)})",
            fix_hint="route this shape to the dense or chunked path"))
        return rep
    for kind in FLASH_KINDS:
        rep.extend(flash_smem(kind, head_dim, dtype).report(f"{loc} {kind}"))
    return rep


def flash_feasible(S: int, T: int, head_dim: int, dtype="bfloat16") -> bool:
    """The router's go/no-go: the blocks divide and every plan fits."""
    return flash_attention_report(S, T, head_dim, dtype).ok


# ---------------------------------------------------------------------------
# the refresh kernels (csrc/graft_select.cu smem_words, sweep_smem_words)
# ---------------------------------------------------------------------------

_SELECT_THREADS = 256                       # kThreads
_SELECT_WARPS = _SELECT_THREADS // 32
SELECT_TILE_COLS = 16                       # kTileCols


def work_words(K: int, R: int) -> int:
    """MaxVol's working set in float32 words: W (K·R), the per-row factor
    and availability (K each) and the pivot row (R)."""
    return K * R + 2 * K + R


def basis_words(d: int, rank: int) -> int:
    """The Gram-Schmidt basis in float32 words: ``Qᵀ (rank, d)`` and ``ĝ``
    as one more row."""
    return (rank + 1) * d


def scratch_words(rank: int) -> int:
    """The refresh's per-rank and per-warp scratch: two reduction slots,
    the coefficients, the pivot search's values and indices."""
    return (2 * _SELECT_WARPS + 2) * rank + 2 * _SELECT_WARPS + 2


def tile_words(cols: int) -> int:
    """The warps' tiles that stage rows of ``cols`` floats of G (32 rows of
    ``cols + 1`` floats a warp, up to ``SELECT_TILE_COLS`` columns)."""
    return _SELECT_THREADS * (cols + 1) if cols <= SELECT_TILE_COLS else 0


def sweep_red_words(R: int) -> int:
    """The sweep's reduction scratch: two slots of per-warp partials and the
    coefficients."""
    return (2 * _SELECT_WARPS + 1) * R


def _check_plan(what: str, plan: str) -> None:
    if plan not in PLANS:
        raise ValueError(f"{what} {plan!r} not in {PLANS}")


def graft_select_smem(K: int, R: int, d: int, rank: int, plan: str = "shared",
                      basis: str = "global") -> SmemEstimate:
    """One refresh block: V's working copy under the shared W plan, the
    basis (d columns) under the shared basis plan, and under every plan the
    scratch and G's staging tiles."""
    _check_plan("plan", plan)
    _check_plan("basis", basis)
    parts = {"scratch": 4 * scratch_words(rank), "tiles": 4 * tile_words(K)}
    if plan == "shared":
        parts["W"] = 4 * work_words(K, R)
    if basis == "shared":
        parts["basis"] = 4 * basis_words(d, rank)
    return SmemEstimate(f"graft_select(K={K}, R={R}, d={d}, rank={rank}, "
                        f"W {plan}, basis {basis})", parts)


def fast_maxvol_smem(K: int, R: int, rank: int, plan: str = "shared") -> SmemEstimate:
    """The standalone MaxVol block: the refresh's sum with no basis (the
    launcher passes d 0 and the global basis plan)."""
    est = graft_select_smem(K, R, 0, rank, plan, "global")
    return dataclasses.replace(est, kernel=f"fast_maxvol(K={K}, R={R}, rank={rank}, {plan})")


def projection_sweep_smem(R: int, plan: str = "shared") -> SmemEstimate:
    """The standalone sweep block: its reduction scratch under the shared
    plan, and G's staging tiles."""
    _check_plan("plan", plan)
    parts = {"tiles": 4 * tile_words(R)}
    if plan == "shared":
        parts["reduction"] = 4 * sweep_red_words(R)
    return SmemEstimate(f"projection_sweep(R={R}, {plan})", parts)


def choose_plan(K: int, R: int, rank: int) -> str:
    """The refresh's W plan: ``"shared"`` when V's working set fits one
    block beside the scratch, else ``"global"``."""
    return "shared" if graft_select_smem(K, R, 0, rank).fits else "global"


def choose_basis(K: int, R: int, d: int, rank: int, plan: str) -> str:
    """The basis plan beside W plan ``plan``: ``"shared"`` when the basis
    fits the block with the rest, else ``"global"``."""
    return "shared" if graft_select_smem(K, R, d, rank, plan, "shared").fits else "global"


def fused_select_vmem(K: int, R: int, d: int, rank: int) -> SmemEstimate:
    """The JAX package's refusal of a refresh (its ``fused_select_vmem``):
    V, G, G_sel + Q and the one-hot in float32 against the 12 MB budget."""
    return SmemEstimate(
        f"graft_select VMEM guard(K={K}, R={R}, d={d}, rank={rank})",
        {"V": 4 * K * R, "G": 4 * d * K, "G_sel+Q": 4 * 2 * d * rank,
         "one_hot": 4 * K * rank}, budget=VMEM_BUDGET_BYTES)


# ---------------------------------------------------------------------------
# the RWKV kernels (csrc/rwkv_scan.cu BwdSmem; the JAX kernel's VMEM guard)
# ---------------------------------------------------------------------------

RWKV_TIME_TILE = 16                         # kTile
_RWKV_ROWS = _RWKV_COLS = 64                # kRows, kCols: a block's patch of S
_RWKV_BWD_WARPS = 8


def rwkv_backward_smem() -> SmemEstimate:
    """One backward block (``BwdSmem``): two buffers of the tile's r, k, w
    (float4 rows), v, do and start state, the per-step c and Σ r u k, u,
    the warps' dv partial sums and the tile's dr, dk, dw. The same for
    every D (64 × 64 patches)."""
    t, rows, cols = RWKV_TIME_TILE, _RWKV_ROWS, _RWKV_COLS
    return SmemEstimate("rwkv_scan_backward", {
        "r,k,w x2": 2 * t * rows * 16, "v,do x2": 2 * 2 * t * cols * 4,
        "state x2": 2 * rows * cols * 4, "c,sum_ruk x2": 2 * t * 8, "u": rows * 4,
        "dv partials": t * _RWKV_BWD_WARPS * cols * 4, "dr,dk,dw": 3 * t * rows * 4})


def rwkv_forward_vmem(D: int, chunk: int = 32) -> SmemEstimate:
    """The JAX kernel's resident blocks per program (its docstring), the
    port's refusal: four (chunk, D) input streams, the (D, D) state and the
    (chunk, D) output, float32, against the 12 MB budget."""
    return SmemEstimate(f"rwkv_scan VMEM guard(D={D}, chunk={chunk})",
                        {"r,k,v,w": 4 * 4 * chunk * D, "state": 4 * D * D,
                         "o": 4 * chunk * D}, budget=VMEM_BUDGET_BYTES)


def rwkv_report(T: int, D: int, chunk: int = 32) -> Report:
    """The RWKV scan at (T, D): ``T % chunk`` (VM002), the JAX guard on D
    (VM001 / VM003) and the backward block (VM003)."""
    rep = Report()
    loc = f"rwkv_scan(T={T}, D={D}, chunk={chunk})"
    f = check_divisible(T, chunk, "T", loc)
    if f:
        rep.add(f)
    rep.extend(rwkv_forward_vmem(D, chunk).report(loc))
    rep.extend(rwkv_backward_smem().report())
    return rep
