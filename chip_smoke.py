#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits nonzero and prints no result line):

  1. device  — the card's name and power limit (``nvidia-smi``), the torch
               and CUDA versions; TF32 off for matmuls and convolutions.
  2. build   — every hand-written kernel of the port, compiled from the
               sources in this checkout (one ``nvcc`` per source, all started
               together), with ``-Xptxas -v``: registers, shared memory,
               spills and build seconds.
  3. kernels — graft_select against its plain PyTorch twin on the card, at
               the training paths' shapes (d 2304 and 4096) and on
               degenerate inputs (exact equality where the arithmetic is the
               same, a stated tolerance where only the summation order
               differs), then timed with CUDA events and by the profiler's
               device time against the twin and its bound; its global-W plan
               at V 1024×64 against the twin; every pair of W plan and basis
               plan (shared or global) that fits bit-equal to the pair the
               wrapper picks; the batched kernel's rows bit-equal to the
               single kernel; fast_maxvol at (K,R,rank) (16,8,8),
               (256,32,32), (1024,64,64), (2048,256,256) and
               projection_sweep at (d,R) (2304,8), (1024,32), (16384,64)
               against their plain versions and bit-equal to the fused
               kernel's pivots and errors; each timed.
  4. flash   — the flash-attention forward, dQ and dK/dV kernels against
               their plain versions at the slice's selection shape (576
               streams) and its subset's at rank 2 and 8 (72 and 288
               streams), minicpm at 4096 tokens, gemma2-27b's attention
               (window 4096, softcap 50, GQA 2, S 8192), stablelm's Dh 160
               with GQA 4, the smoke Dh 12 in f32, window 0, bidirectional
               and Dh 16 in bf16 with GQA 2 (bf16 runs on the tensor cores,
               float32 on the float32 cores); bounded vs exhaustive KV loops
               and two runs on the same inputs bit-equal; each timed against
               its plain version, its bound and, where it computes the same
               function, PyTorch's scaled_dot_product_attention, with the
               ratios to SDPA and to the bound (every row also in
               ``build/chip_smoke_flash.json``).
  5. slice   — the training path through the user entry point
               (``repro_torch.api.Trainer``) on minicpm-2b at full width and
               depth: 6 steps, GRAFT refresh every 2 steps through the
               kernel, attention ``auto``, which must resolve to flash. The
               kernels' launch counts are zeroed just before and read just
               after; each must equal what the path reckons (0 for the
               selection kernels the training path does not run; those are
               counted where phase engine drives them).
  6. engine  — the multi-batch selection engine on the slice's trained
               params: a 4-microbatch stack (16 × 256 each, ``SyntheticLM.
               microbatch_stack``) through ``selection_inputs`` (flash) and
               ``select_multi_batch`` (GRAFT, ``use_pallas``): exactly one
               batched launch, bit-equal to a loop of ``select_batch`` (4
               single launches), pivots and ranks equal to the plain chain;
               the ``kernels/ops`` chain fast_maxvol → gather →
               projection_sweep on the same stack, bit-equal to the fused
               kernel; all three timed, and again at the selection
               benchmark's shape B=8, K=256, R=32, d=1024, rank 32.
  7. profile — where a steady step's time goes: the selection refresh, the
               subset forward/backward, clipping and the AdamW update timed
               apart with CUDA events on the trained state, and the top
               kernels of one whole step by device time (torch.profiler).
  8. depth8  — the same slice with depth cut to 8 layers, dense attention
               beside flash from the same seed, run dense, flash, flash,
               dense: steady step times from one call.
  9. rwkv    — the RWKV6 recurrence's forward and backward kernels against
               their plain versions: the JAX kernel test's four shapes, the
               rwkv6-7b selection forward (BH 1024 = 16 × 64 heads, T 256,
               D 64), the subset's forward and backward at rank 8 (BH 512)
               and at rank 2 (BH 128), again with decays down to 0, a long
               context (BH 64, T 4096), a T that is not a multiple of the
               time tile and D 256, which the model never uses; reruns
               bit-equal, the no-grad forward equal to the one that saves
               states, ``ops.rwkv_scan`` equal for every chunk. Each timed
               against its plain version and its bound (no single PyTorch
               call computes it); the kernels line takes the forward at BH
               1024 and the backward at BH 128.
 10. rwkv_slice — ``Trainer`` on rwkv6-7b at full width with depth cut to
               16 of 32 layers: 6 steps, the slice's GRAFT settings, exact
               launch counts (rwkv_scan 16 × (6·2 + 3), its backward 16 × 6,
               graft_select 3, flash 0), peak memory; then the profile of
               phase 7 on its trained state.
 11. check   — the same path at smoke size on the card against the port's
               CPU run (which the CPU tests hold against the JAX package):
               minicpm and gemma2 (seq 32, so that its window of 16 bites)
               under flash attention, and rwkv6-7b through the RWKV kernels.
               Per-step losses rtol 1e-4, ranks and pivots equal.

It prints a ``{"kernels": [...]}`` line (all nine kernels), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

SLICE_OVERRIDES = [
    "model.smoke=false", 'model.overrides={"attn_backend": "auto"}',
    "graft.use_pallas=true", "graft.rset=[2,4,8]", "graft.eps=0.25",
    "graft.refresh_every=2", "train.batch=16", "train.seq=256",
    "train.steps=6", "train.log_every=1",
]

FLASH_REPLACES = {"flash_forward": "src/repro/kernels/flash_attention.py:210",
                  "flash_dq": "src/repro/kernels/flash_attention.py:232",
                  "flash_dkv": "src/repro/kernels/flash_attention.py:232"}

# (name, B, H, Hkv, S, Dh, dtype, causal, window, softcap). "slice" is the
# selection forward's 16 × 36 streams; "subset" and "subset_r8" the subset's
# forward and backward, r × 36 streams at the ranks phase slice reports (2
# and 8)
FLASH_SHAPES = [
    ("slice", 16, 36, 36, 256, 64, "bfloat16", True, None, None),
    ("subset", 2, 36, 36, 256, 64, "bfloat16", True, None, None),
    ("subset_r8", 8, 36, 36, 256, 64, "bfloat16", True, None, None),
    ("minicpm_4096", 1, 36, 36, 4096, 64, "bfloat16", True, None, None),
    ("gemma2_27b", 1, 32, 16, 8192, 128, "bfloat16", True, 4096, 50.0),
    ("stablelm_12b", 1, 32, 8, 2048, 160, "bfloat16", True, None, None),
    ("smoke_f32", 8, 6, 6, 16, 12, "float32", True, None, None),
    ("window0", 2, 4, 4, 128, 32, "float32", True, 0, None),
    ("bidirectional", 2, 16, 16, 1024, 64, "bfloat16", False, None, None),
    ("dh16_bf16_gqa2", 8, 6, 3, 256, 16, "bfloat16", True, None, None),
]


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(ctx):
    import torch
    ctx["smi"] = nvidia_smi_line()
    print(ctx["smi"])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build(ctx):
    from repro_torch.kernels import build
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(build.load, names))
    print(f"built {names} in {time.perf_counter() - t0:.2f} s (wall, in parallel)")
    for b in built:
        print(f"[{b.name}] nvcc {b.build_s:.2f} s -> {os.path.relpath(b.path, ROOT)}")
        entry = None
        for line in b.ptxas_log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = _kernel_instance(m.group(1))
            elif entry and ("registers" in line or "spill" in line):
                print(f"[{b.name}] {entry}: {line.strip()}")


def _kernel_instance(mangled: str) -> str:
    """A readable name for a flash template instance in the ptxas log: the
    float32-core kernels by (NC, TILE), the tensor-core ones by their padded
    head dim."""
    t = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)ILi(\d+)ELi(\d+)", mangled)
    if t:
        return f"{t.group(1)}<f32, NC={t.group(2)}, TILE={t.group(3)}>"
    t = re.search(r"(flash_(?:fwd|dq|dkv)_mma_kernel)ILi(\d+)EE", mangled)
    return f"{t.group(1)}<bf16, DP={t.group(2)}>" if t else mangled[:60]


def _graft_inputs(kind, K, R, d, rank, dev, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(K, R)).astype(np.float32)
    if kind == "rank_deficient":            # duplicate rows and a zero column
        V[K // 2:] = V[:K - K // 2]
        V[:, R // 2] = 0.0
    elif kind == "ties":
        V = rng.choice([-2.0, -1.0, 1.0, 2.0], size=(K, R)).astype(np.float32)
    G = rng.normal(size=(d, K)).astype(np.float32)
    gb = G.mean(axis=1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (V, G, gb)] + [rank]


def _maxvol_flops(K, R, rank):
    """Fast MaxVol's float32 operations: per pivot step a division per row
    and a multiply-subtract on every row of the columns still to pivot on."""
    return sum(K + 2 * K * (R - j - 1) for j in range(rank))


def _sweep_flops(d, n):
    """The CGS2 sweep: two passes of coefficients + update per column, and
    its norm, normalisation and dot with ĝ."""
    return sum(2 * 4 * d * j + 6 * d for j in range(n))


def _bound(nbytes, flops):
    """Least time on an H100: bytes over HBM bandwidth vs float32 operations
    over the CUDA-core peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def _graft_bound(K, R, d, rank, B=1):
    """The refresh (B of them): its inputs read once and its outputs written
    once, vs its operations."""
    nbytes = B * 4 * (K * R + d * K + d + rank + rank + 1 + d * rank)
    return _bound(nbytes, B * (_maxvol_flops(K, R, rank) + _sweep_flops(d, rank)))


def _entry(name, replaces, launches, err, ms, plain_ms, bound, device_ms=None):
    """A kernels-line entry for a kernel of graft_select.cu: no single
    PyTorch call computes any of them, so there is no library time. The
    refresh's entries also carry the profiler's device time."""
    entry = {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/graft_select.cu",
             "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None}
    if device_ms is not None:
        entry["device_ms"] = device_ms
    return entry


def _device_times(fn, match):
    """(CUDA-event ms, profiler device ms) per call of ``fn``, the device
    time summed over the kernels whose names hold ``match``
    (``tools/flash_ab.py``'s ``times``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from flash_ab import times
    return times(fn, cuda_time_ms, match=match, max_iters=500)


def phase_kernels(ctx):
    import numpy as np
    import torch
    from repro_torch.kernels.graft_select import graft_select, graft_select_reference
    dev = torch.device("cuda")
    cases = [("slice", 16, 8, 2304, 8), ("rwkv", 16, 8, 4096, 8), ("wide", 256, 64, 4096, 64),
             ("square", 16, 16, 2304, 16), ("rank_deficient", 64, 8, 2304, 6),
             ("ties", 12, 6, 512, 6)]
    err_atol, lv_rtol = 1e-5, 1e-5
    for kind, K, R, d, rank in cases:
        args = _graft_inputs(kind, K, R, d, rank, dev)
        got = graft_select(*args)
        torch.cuda.synchronize()
        want = graft_select_reference(*args)
        piv_eq = torch.equal(got[0].long(), want[0].long())
        gsel_eq = torch.equal(got[3], want[3])
        err_d = (got[1] - want[1]).abs().max().item()
        lv_d = abs(got[2].item() - want[2].item())
        lv_ok = lv_d <= lv_rtol * abs(want[2].item()) + 1e-7
        ok = piv_eq and gsel_eq and err_d <= err_atol and lv_ok
        print(f"[graft_select] {kind} K={K} R={R} d={d} rank={rank}: pivots "
              f"{'equal' if piv_eq else 'DIFFER'}, G_sel {'equal' if gsel_eq else 'DIFFERS'}, "
              f"max|errors diff| {err_d:.3g} (atol {err_atol}), |logvol diff| {lv_d:.3g} "
              f"(rtol {lv_rtol}; sums in another order) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"graft_select disagrees with its twin on {kind}")
        if kind == "slice":
            ctx["graft_max_abs_err"] = max(err_d, lv_d)
    # time at the training paths' shapes: minicpm-2b's d 2304 (the kernels
    # line) and rwkv6-7b's d 4096
    for K, R, d, rank in ((16, 8, 2304, 8), (16, 8, 4096, 8)):
        args = _graft_inputs("slice", K, R, d, rank, dev, seed=1)
        ms = cuda_time_ms(lambda: graft_select(*args), iters=500, warmup=20)
        _, device_ms = _device_times(lambda: graft_select(*args), "graft_select")
        plain_ms = cuda_time_ms(lambda: graft_select_reference(*args), iters=50, warmup=5)
        bound_ms, bound_by, nbytes, flops = _graft_bound(K, R, d, rank)
        print(f"[graft_select] K={K} R={R} d={d} rank={rank}: kernel {ms:.4f} ms "
              f"(events), {device_ms:.4f} ms (profiler device time), twin {plain_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} bytes, {flops} flop); "
              f"{device_ms / bound_ms:.0f}x the bound by device time", flush=True)
        if d == 2304:
            ctx["kernels"] = {"graft_select": _entry(
                "graft_select", "src/repro/kernels/graft_select.py:137", None,
                ctx["graft_max_abs_err"], ms, plain_ms, (bound_ms, bound_by), device_ms)}
    _kernels_wide_and_global(dev)
    _kernels_standalone(ctx, dev)


def _random_refresh(K, R, d, dev, B=None, seed=0):
    """Seeded V, G, ḡ on the card, with a leading B when given."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    V = rng.normal(size=lead + (K, R)).astype(np.float32)
    G = rng.normal(size=lead + (d, K)).astype(np.float32)
    gb = G.mean(axis=-1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (V, G, gb)]


def _refresh_diff(got, want):
    """(pivots equal, G_sel equal, max|errors diff|, |logvol diff|)."""
    import torch
    return (torch.equal(got[0].long(), want[0].long()), torch.equal(got[3], want[3]),
            (got[1] - want[1]).abs().max().item(),
            (got[2] - want[2]).abs().max().item())


def _all_equal(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _kernels_wide_and_global(dev):
    """graft_select at the wide shape and on the global-W plan; the batched
    kernel's rows against the single kernel."""
    import torch
    from repro_torch.kernels import graft_select as gs
    for K, R, d, rank in ((256, 64, 4096, 64), (1024, 64, 1024, 64)):
        args = _random_refresh(K, R, d, dev, seed=2) + [rank]
        plan = gs.choose_plan(K, R, rank)
        got = gs.graft_select(*args)
        torch.cuda.synchronize()
        piv_eq, gsel_eq, err_d, lv_d = _refresh_diff(got, gs.graft_select_reference(*args))
        lv_ok = lv_d <= 1e-5 * abs(got[2].item()) + 1e-7
        ok = piv_eq and gsel_eq and err_d <= 1e-5 and lv_ok
        ms = _time_auto(lambda: gs.graft_select(*args), max_iters=200)
        plain_ms = _time_auto(lambda: gs.graft_select_reference(*args))
        b_ms, b_by, nbytes, flops = _graft_bound(K, R, d, rank)
        print(f"[graft_select] {plan} plan K={K} R={R} d={d} rank={rank}: pivots "
              f"{'equal' if piv_eq else 'DIFFER'}, G_sel {'equal' if gsel_eq else 'DIFFERS'}, "
              f"max|errors diff| {err_d:.3g} (atol 1e-05), |logvol diff| {lv_d:.3g} "
              f"(rtol 1e-05) -> {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({nbytes} bytes, "
              f"{flops} flop); {ms / b_ms:.0f}x the bound", flush=True)
        if not ok:
            raise AssertionError(f"graft_select disagrees with its twin at K={K} R={R}")
    # every pair of W plan (MaxVol's working set) and basis plan (Qᵀ and ĝ)
    # that fits the block, against the pair the wrapper picks
    for K, R, d, rank in ((16, 8, 2304, 8), (16, 8, 4096, 8), (256, 64, 4096, 64),
                          (64, 8, 2304, 6)):
        args = _random_refresh(K, R, d, dev, seed=3) + [rank]
        want = gs.graft_select(*args)
        pairs = [(p, q) for p in gs.PLANS for q in gs.PLANS
                 if gs.smem_bytes(K, R, rank, p, d if q == "shared" else 0)
                 <= gs.SMEM_LIMIT_BYTES]
        same = {pq: _all_equal(gs.graft_select(*args, plan=pq[0], basis=pq[1]), want)
                for pq in pairs}
        t = {pq: _time_auto(lambda pq=pq: gs.graft_select(*args, plan=pq[0], basis=pq[1]),
                            max_iters=500) for pq in pairs}
        print(f"[graft_select] K={K} R={R} d={d} rank={rank}: picks W plan "
              f"{gs.choose_plan(K, R, rank)}, basis plan "
              f"{gs.choose_basis(K, R, d, rank, gs.choose_plan(K, R, rank))}; "
              + ", ".join(f"W {p} / basis {q} {'bit-equal' if same[(p, q)] else 'DIFFERS'} "
                          f"{t[(p, q)]:.4f} ms" for p, q in pairs)
              + " (pivots, errors, logvol, G_sel)", flush=True)
        if not all(same.values()):
            raise AssertionError("graft_select's plans disagree")
    for B, K, R, d, rank in ((4, 16, 8, 2304, 8), (4, 16, 8, 4096, 8), (8, 256, 32, 1024, 32)):
        Vs, Gs, gbs = _random_refresh(K, R, d, dev, B=B, seed=4)
        got = gs.graft_select_batched(Vs, Gs, gbs, rank)
        rows = all(_all_equal([t[b] for t in got], gs.graft_select(Vs[b], Gs[b], gbs[b], rank))
                   for b in range(B))
        print(f"[graft_select_batched] B={B} K={K} R={R} d={d} rank={rank}: every row "
              f"{'bit-equal to' if rows else 'DIFFERS from'} the single kernel", flush=True)
        if not rows:
            raise AssertionError("the batched kernel disagrees with the single kernel")


def _kernels_standalone(ctx, dev):
    """fast_maxvol and projection_sweep against their plain versions and
    the fused kernel, each timed against its bound."""
    import torch
    from repro_torch.core import maxvol as maxvol_lib
    from repro_torch.core import projection as proj_lib
    from repro_torch.kernels import fast_maxvol as fm
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import projection_sweep as ps
    for K, R, rank in ((16, 8, 8), (256, 32, 32), (1024, 64, 64), (2048, 256, 256)):
        V, G, gb = _random_refresh(K, R, 64, dev, seed=K)
        piv, lv = fm.fast_maxvol(V, rank)
        piv_r, lv_r = maxvol_lib.fast_maxvol(V, rank)
        fused = gs.graft_select(V, G, gb, rank)
        torch.cuda.synchronize()
        lv_d = abs(lv.item() - lv_r.item())
        ok = (torch.equal(piv.long(), piv_r.long()) and torch.equal(piv, fused[0])
              and torch.equal(lv, fused[2]) and lv_d <= 1e-5 * abs(lv_r.item()) + 1e-7)
        ms = _time_auto(lambda: fm.fast_maxvol(V, rank), max_iters=500)
        plain_ms = _time_auto(lambda: maxvol_lib.fast_maxvol(V, rank))
        bound = _bound(4 * (K * R + rank + 1), _maxvol_flops(K, R, rank))
        print(f"[fast_maxvol] {gs.choose_plan(K, R, rank)} plan K={K} R={R} rank={rank}: "
              f"pivots {'equal' if ok else 'DIFFER or'} to the plain version's and "
              f"graft_select's, logvol bit-equal to graft_select's, |logvol diff| vs plain "
              f"{lv_d:.3g} (rtol 1e-05) -> {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound[0]:.6f} ms by {bound[1]} "
              f"({bound[2]} bytes, {bound[3]} flop); {ms / bound[0]:.0f}x the bound", flush=True)
        if not ok:
            raise AssertionError(f"fast_maxvol disagrees at K={K} R={R} rank={rank}")
        if (K, R, rank) == (16, 8, 8):
            ctx["kernels"]["fast_maxvol"] = _entry(
                "fast_maxvol", "src/repro/kernels/fast_maxvol.py:55", None, lv_d,
                ms, plain_ms, bound)
    for d, R in ((2304, 8), (1024, 32), (16384, 64)):
        V, G, gb = _random_refresh(R, R, d, dev, seed=d)
        # G_sel from the fused kernel where its 12 MB guard admits the shape
        fits = gs.fused_budget_bytes(R, R, d, R) <= gs.VMEM_BUDGET_BYTES
        fused = gs.graft_select(V, G, gb, R) if fits else None
        G_sel = fused[3] if fits else G
        err = ps.projection_sweep(G_sel, gb)
        err_r = proj_lib.prefix_projection_errors(G_sel, gb)
        torch.cuda.synchronize()
        err_d = (err - err_r).abs().max().item()
        same = torch.equal(err, fused[1]) if fits else None
        plans_eq = torch.equal(ps.projection_sweep(G_sel, gb, plan="global"), err)
        ok = err_d <= 1e-5 and same is not False and plans_eq
        ms = _time_auto(lambda: ps.projection_sweep(G_sel, gb), max_iters=500)
        plain_ms = _time_auto(lambda: proj_lib.prefix_projection_errors(G_sel, gb))
        bound = _bound(4 * (d * R + d + R), _sweep_flops(d, R))
        vs_fused = ("bit-equal to the fused kernel's" if same else "DIFFER from the fused kernel's"
                    ) if fits else "(the fused kernel's 12 MB guard refuses this shape)"
        print(f"[projection_sweep] d={d} R={R}: max|errors diff| vs plain {err_d:.3g} "
              f"(atol 1e-05), errors {vs_fused}, global-scratch plan "
              f"{'bit-equal' if plans_eq else 'DIFFERS'} -> {'ok' if ok else 'FAIL'}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.6f} ms by {bound[1]} "
              f"({bound[2]} bytes, {bound[3]} flop); {ms / bound[0]:.0f}x the bound", flush=True)
        if not ok:
            raise AssertionError(f"projection_sweep disagrees at d={d} R={R}")
        if (d, R) == (2304, 8):
            ctx["kernels"]["projection_sweep"] = _entry(
                "projection_sweep", "src/repro/kernels/projection_sweep.py:50", None,
                err_d, ms, plain_ms, bound)


def _flash_inputs(B, H, Hkv, S, Dh, dtype, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(n):
        return torch.randn((n, S, Dh), generator=g, device="cuda").to(dt)
    return rnd(B * H), rnd(B * Hkv), rnd(B * Hkv), rnd(B * H)


def _flash_pairs(S, causal, window):
    """Unmasked (q, k) pairs of one head: what the inputs need computed."""
    import numpy as np
    i = np.arange(S, dtype=np.int64)
    hi = i if causal else np.full(S, S - 1)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(S, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _flash_bound(kind, B, H, Hkv, S, Dh, dtype, causal, window):
    """Least time on an H100: operations on the unmasked pairs (QKᵀ and PV
    forward; + dO·Vᵀ and dS·K for dQ; QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q for dK/dV) at
    the peak of the input type, vs each input read and each output written
    once over HBM."""
    el = 2 if dtype == "bfloat16" else 4
    q_b, kv_b, row_b = B * H * S * Dh * el, B * Hkv * S * Dh * el, B * H * S * 4
    pairs = B * H * _flash_pairs(S, causal, window)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * Dh * pairs
    nbytes = {"fwd": 2 * q_b + 2 * kv_b + row_b,            # q, k, v -> o, lse
              "dq": 3 * q_b + 2 * kv_b + 2 * row_b,         # q, do, k, v, lse, delta -> dq
              "dkv": 2 * q_b + 4 * kv_b + 2 * row_b}[kind]  # q, do, k, v, lse, delta -> dk, dv
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def _flash_plain(fn, q, k, v, do, lse, delta, group, opts):
    """The plain version over chunks of kv streams (≤ 1 GB of f32 scores
    each), so the dense reference fits beside the inputs at S = 8192."""
    import torch
    BHkv, S = k.shape[0], k.shape[1]
    per = max(1, (1 << 30) // (group * q.shape[1] * S * 4))
    outs = []
    for c in range(0, BHkv, per):
        qs = slice(c * group, (c + per) * group)
        args = (q[qs], k[c:c + per], v[c:c + per])
        if do is not None:
            args += (do[qs], lse[qs], delta[qs])
        outs.append(fn(*args, group=group, **opts))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _time_auto(fn, budget_ms=300.0, max_iters=50):
    """CUDA-event time of fn, with the iteration count sized to the budget."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    return cuda_time_ms(fn, iters=int(min(max_iters, max(2, budget_ms / once))), warmup=1)


def phase_flash(ctx):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for name, B, H, Hkv, S, Dh, dtype, causal, window, softcap in FLASH_SHAPES:
        group = H // Hkv
        q, k, v, do = _flash_inputs(B, H, Hkv, S, Dh, dtype)
        opts = dict(causal=causal, window=window, softcap=softcap)
        kw = dict(opts, group=group)

        def run(bound_loop=True):
            o, lse = fa.flash_forward(q, k, v, bound_loop=bound_loop, **kw)
            delta = (o.float() * do.float()).sum(-1)
            dq = fa.flash_dq(q, k, v, do, lse, delta, bound_loop=bound_loop, **kw)
            dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, bound_loop=bound_loop, **kw)
            torch.cuda.synchronize()
            return o, lse, delta, dq, dk, dv

        got = run()
        same = all(torch.equal(a, b) for a, b in zip(got, run()))
        bounded = all(torch.equal(a, b) for a, b in zip(got, run(bound_loop=False)))
        o, lse, delta, dq, dk, dv = got
        o_r, lse_r = _flash_plain(fa.flash_forward_reference, q, k, v, None, None, None,
                                  group, opts)
        dq_r = _flash_plain(fa.flash_dq_reference, q, k, v, do, lse, delta, group, opts)
        dk_r, dv_r = _flash_plain(fa.flash_dkv_reference, q, k, v, do, lse, delta,
                                  group, opts)
        torch.cuda.synchronize()
        # tolerance: float32 sums of up to S products in another order (f32:
        # 1e-4 of the largest value). bf16: 2^-7 of the largest value, one bf16
        # ulp there. The tensor-core forward and dK/dV round P (and dS) to bf16
        # once before their products, which adds at most 2^-9 sum_j p_j |v_j|
        # to o before its own rounding, and far less for random inputs; dQ
        # takes dS into dS.K as bf16 hi + lo (~16 bits), then rounds dQ once
        errs, ok = {}, same and bounded
        for what, a, b in (("o", o, o_r), ("dq", dq, dq_r), ("dk", dk, dk_r),
                           ("dv", dv, dv_r)):
            scale = b.float().abs().max().item()
            tol = 2.0 ** -7 * scale if dtype == "bfloat16" else 1e-4 * scale + 1e-6
            errs[what] = (a.float() - b.float()).abs().max().item()
            ok = ok and errs[what] <= tol and a.dtype == b.dtype
        fin = torch.isfinite(lse_r)
        ok = ok and torch.equal(fin, torch.isfinite(lse))
        errs["lse"] = (lse[fin] - lse_r[fin]).abs().max().item() if bool(fin.any()) else 0.0
        ok = ok and errs["lse"] <= 1e-4
        if window == 0:         # every row fully masked: exactly 0, lse +inf
            ok = ok and all(torch.equal(t, torch.zeros_like(t)) for t in (o, dq, dk, dv)) \
                and bool(torch.all(torch.isinf(lse) & (lse > 0)))
        print(f"[flash] {name}: B={B} H={H} Hkv={Hkv} S={S} Dh={Dh} {dtype} causal={causal} "
              f"window={window} softcap={softcap}: max|diff| "
              + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
              + f"; reruns {'bit-equal' if same else 'DIFFER'}, bounded vs exhaustive "
              f"{'bit-equal' if bounded else 'DIFFER'} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash kernels disagree with their plain versions on {name}")
        del o_r, lse_r, dq_r, dk_r, dv_r, got
        # times
        t = {"fwd": _time_auto(lambda: fa.flash_forward(q, k, v, **kw)),
             "dq": _time_auto(lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw)),
             "dkv": _time_auto(lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw))}
        plain = {"fwd": _time_auto(lambda: _flash_plain(
                     fa.flash_forward_reference, q, k, v, None, None, None, group, opts)),
                 "dq": _time_auto(lambda: _flash_plain(
                     fa.flash_dq_reference, q, k, v, do, lse, delta, group, opts)),
                 "dkv": _time_auto(lambda: _flash_plain(
                     fa.flash_dkv_reference, q, k, v, do, lse, delta, group, opts))}
        lib = {"fwd": None, "bwd": None}
        if window is None and softcap is None:
            # scaled_dot_product_attention computes the same function; its one
            # backward call gives dQ, dK and dV together
            q4, k4, v4 = (x.view(B, -1, S, Dh).detach().requires_grad_() for x in (q, k, v))
            sdpa = dict(is_causal=causal, enable_gqa=group > 1, scale=Dh ** -0.5)
            lib["fwd"] = _time_auto(lambda: F.scaled_dot_product_attention(q4, k4, v4, **sdpa))
            o4 = F.scaled_dot_product_attention(q4, k4, v4, **sdpa)
            do4 = do.view(B, H, S, Dh)
            lib["bwd"] = _time_auto(lambda: torch.autograd.grad(
                o4, (q4, k4, v4), do4, retain_graph=True))
            del o4
        bounds = {kind: _flash_bound(kind, B, H, Hkv, S, Dh, dtype, causal, window)
                  for kind in t}
        for kind in t:
            b_ms, b_by, nbytes, flops = bounds[kind]
            lib_ms = lib["fwd"] if kind == "fwd" else lib["bwd"]
            vs_lib = "" if lib_ms is None else f", {t[kind] / lib_ms:.2f}x SDPA"
            print(f"[flash] {name} {kind}: kernel {t[kind]:.4f} ms, plain {plain[kind]:.4f} ms, "
                  f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f"{' (SDPA backward: dQ, dK, dV in one call)' if lib_ms is not None and kind != 'fwd' else ''}, "
                  f"bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} flop); "
                  f"{t[kind] / b_ms:.1f}x the bound{vs_lib}", flush=True)
            rows.append({"shape": name, "kind": kind, "ms": t[kind], "plain_ms": plain[kind],
                         "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        if lib["bwd"] is not None:
            print(f"[flash] {name} dq+dkv: {t['dq'] + t['dkv']:.4f} ms, "
                  f"{(t['dq'] + t['dkv']) / lib['bwd']:.2f}x SDPA backward", flush=True)
        if name == "slice":
            for kind, key in (("fwd", "flash_forward"), ("dq", "flash_dq"), ("dkv", "flash_dkv")):
                err = {"fwd": max(errs["o"], errs["lse"]), "dq": errs["dq"],
                       "dkv": max(errs["dk"], errs["dv"])}[kind]
                ctx["kernels"][key] = {
                    "name": key, "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention.cu",
                    "replaces": FLASH_REPLACES[key], "launches": None,
                    "max_abs_err": err, "ms": t[kind], "plain_ms": plain[kind],
                    "bound_ms": bounds[kind][0], "bound_by": bounds[kind][1],
                    "library_ms": lib["fwd"] if kind == "fwd" else lib["bwd"]}
        del q, k, v, do, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_flash.json"), "w") as f:
        json.dump({"device": ctx["smi"], "rows": rows}, f, indent=1)


def _kernel_counters():
    """(name, holder, attribute) of every kernel's launch count."""
    from repro_torch.kernels import fast_maxvol as fm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import projection_sweep as ps
    from repro_torch.kernels import rwkv_scan as rw
    return [("graft_select", gs.graft_select, "launches"),
            ("flash_forward", fa.flash_attention, "forward_launches"),
            ("flash_dq", fa.flash_attention, "dq_launches"),
            ("flash_dkv", fa.flash_attention, "dkv_launches"),
            ("graft_select_batched", gs.graft_select_batched, "launches"),
            ("fast_maxvol", fm.fast_maxvol, "launches"),
            ("projection_sweep", ps.projection_sweep, "launches"),
            ("rwkv_scan", rw.rwkv_scan, "launches"),
            ("rwkv_scan_backward", rw.rwkv_scan_backward, "launches")]


def _zero_counts():
    for _, holder, attr in _kernel_counters():
        setattr(holder, attr, 0)


def _read_counts():
    return {name: getattr(holder, attr) for name, holder, attr in _kernel_counters()}


def _expected_launches(mcfg, cfg):
    """Launches the slice reckons: per step one forward per layer for the
    subset loss and one more for its remat recompute, and one backward; per
    refresh one selection forward per layer and one graft_select. The
    forward and backward kernels are flash (forward; dQ and dK/dV) for the
    dense family, the RWKV scan (forward; one backward launch) for the ssm
    family. The training path runs no batched refresh and no standalone
    stage."""
    steps = cfg.train.steps
    refreshes = sum(1 for s in range(steps) if s % cfg.graft.refresh_every == 0)
    fwd_per_step = 2 if mcfg.remat == "full" else 1
    L = mcfg.num_layers
    fwd, bwd = L * (steps * fwd_per_step + refreshes), L * steps
    ssm = mcfg.family == "ssm"
    return {"graft_select": refreshes, "flash_forward": 0 if ssm else fwd,
            "flash_dq": 0 if ssm else bwd, "flash_dkv": 0 if ssm else bwd,
            "graft_select_batched": 0, "fast_maxvol": 0, "projection_sweep": 0,
            "rwkv_scan": fwd if ssm else 0, "rwkv_scan_backward": bwd if ssm else 0}


def phase_slice(ctx):
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    cfg = ExperimentConfig().apply_overrides(SLICE_OVERRIDES)
    mcfg = cfg.model.build()
    n_params = (mcfg.vocab_size * mcfg.d_model + mcfg.d_model + mcfg.num_layers * (
        2 * mcfg.d_model + 4 * mcfg.d_model * mcfg.num_heads * mcfg.head_dim
        + 3 * mcfg.d_model * mcfg.d_ff))
    state_gb = n_params * (2 + 2 + 4 + 4) / 1e9   # bf16 params + grads, f32 m + v
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"[slice] minicpm-2b full width: {mcfg.num_layers} layers, d_model "
          f"{mcfg.d_model}, {mcfg.num_heads} heads x {mcfg.head_dim}, d_ff {mcfg.d_ff}, "
          f"vocab {mcfg.vocab_size}, {mcfg.param_dtype} params, remat={mcfg.remat}, "
          f"attn_backend={mcfg.attn_backend}; {n_params / 1e9:.3f} B params -> "
          f"params+grads+AdamW state ~{state_gb:.1f} GB of {total_gb:.1f} GB; depth not cut")
    from repro_torch.models.layers import resolve_attn_backend
    backend = resolve_attn_backend(mcfg, cfg.train.seq, cfg.train.seq, torch.device("cuda"))
    print(f"[slice] attn_backend={mcfg.attn_backend} resolves to {backend} on the card")
    assert backend == "flash", f"auto resolved to {backend}, not flash"
    torch.cuda.reset_peak_memory_stats()
    trainer = ctx["trainer"] = Trainer(cfg)
    _zero_counts()
    t0 = time.perf_counter()
    report = trainer.fit()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = report["history"]
    for i, row in enumerate(hist):
        print(f"[slice] step {i}: loss {row['loss']:.6f} rank {row['rank']} "
              f"proj_error {row['proj_error']:.4f} alignment {row['alignment']:.4f} "
              f"grad_norm {row['grad_norm']:.4f} step {row['step_time_s'] * 1e3:.1f} ms")
    print(f"[slice] fit wall {wall:.2f} s, peak memory allocated {peak_gb:.2f} GB, "
          f"kernel launches {launches}, config_hash {report['config_hash']}")
    expected = _expected_launches(mcfg, cfg)
    print(f"[slice] expected launches {expected}")
    assert all(np.isfinite(r["loss"]) for r in hist), "non-finite loss"
    assert all(int(r["rank"]) in cfg.graft.rset for r in hist), "rank outside rset"
    assert launches == expected, f"launches {launches}, expected {expected}"
    for name in ("graft_select", "flash_forward", "flash_dq", "flash_dkv"):
        assert launches[name] > 0, f"kernel {name} was never launched on the main path"
        ctx["kernels"][name]["launches"] = launches[name]
    steady = [r["step_time_s"] for r in hist[1:]]
    print(f"[slice] steady step time (steps 1-5) mean {np.mean(steady) * 1e3:.1f} ms; "
          f"refresh steps {[r['step_time_s'] * 1e3 for r in hist[2::2]]} ms")


def _engine_compare(cfg, Vs, Gs, gbs, scores, step, what):
    """The engine's three routes on one stack: one batched launch, a loop
    of select_batch (one single launch per lane), and the plain chain.
    Asserts the launch counts and the agreements; returns the batched
    state and the launch counts of its call."""
    import dataclasses
    import torch
    from repro_torch.selection import engine
    B = Vs.shape[0]
    _zero_counts()
    multi, carry = engine.select_multi_batch(cfg, "graft", Vs, Gs, gbs, scores=scores,
                                             step=step)
    torch.cuda.synchronize()
    counts = _read_counts()
    assert carry == {}, f"graft carries nothing, got {carry}"
    assert counts == dict({k: 0 for k in counts}, graft_select_batched=1), \
        f"{what}: select_multi_batch launched {counts}, expected one batched launch"
    _zero_counts()
    singles = [engine.select_batch(cfg, "graft", Vs[b], Gs[b], gbs[b], scores=scores[b],
                                   step=step)[0] for b in range(B)]
    torch.cuda.synchronize()
    loop_counts = _read_counts()
    assert loop_counts == dict({k: 0 for k in counts}, graft_select=B), loop_counts
    loop_eq = all(torch.equal(getattr(multi, f)[b], getattr(singles[b], f))
                  for b in range(B) for f in multi._fields)
    plain, _ = engine.select_multi_batch(dataclasses.replace(cfg, use_pallas=False), "graft",
                                         Vs, Gs, gbs, scores=scores, step=step)
    torch.cuda.synchronize()
    piv_eq = torch.equal(multi.pivots, plain.pivots) and torch.equal(multi.rank, plain.rank)
    err_d = max((multi.last_error - plain.last_error).abs().max().item(),
                (multi.alignment - plain.alignment).abs().max().item())
    print(f"[engine] {what}: select_multi_batch launched {counts['graft_select_batched']} "
          f"batched kernel; the select_batch loop {loop_counts['graft_select']} single "
          f"launches, every field {'bit-equal' if loop_eq else 'DIFFERS'}; plain chain "
          f"pivots and ranks {'equal' if piv_eq else 'DIFFER'}, max|last_error, alignment "
          f"diff| {err_d:.3g} (atol 1e-05); ranks {multi.rank.tolist()}", flush=True)
    assert loop_eq, f"{what}: the batched path differs from the select_batch loop"
    assert piv_eq and err_d <= 1e-5, f"{what}: the batched path differs from the plain chain"
    return multi, counts


def _engine_times(cfg, Vs, Gs, gbs, scores, step, what):
    """Device times of the batched launch, B single launches and the plain
    chain (kernel level), and of the engine call on both routes."""
    import dataclasses
    from repro_torch.kernels import graft_select as gs
    from repro_torch.selection import engine
    B, r = Vs.shape[0], cfg.r_max
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    t = {"batched": _time_auto(lambda: gs.graft_select_batched(Vs, Gs, gbs, r), max_iters=500),
         "batched_device": _device_times(lambda: gs.graft_select_batched(Vs, Gs, gbs, r),
                                         "graft_select")[1],
         "singles": _time_auto(lambda: [gs.graft_select(Vs[b], Gs[b], gbs[b], r)
                                        for b in range(B)], max_iters=500),
         "plain": _time_auto(lambda: gs.graft_select_batched_reference(Vs, Gs, gbs, r)),
         "engine": _time_auto(lambda: engine.select_multi_batch(
             cfg, "graft", Vs, Gs, gbs, scores=scores, step=step), max_iters=200),
         "engine_plain": _time_auto(lambda: engine.select_multi_batch(
             plain_cfg, "graft", Vs, Gs, gbs, scores=scores, step=step))}
    K, R, d = Vs.shape[1], Vs.shape[2], Gs.shape[1]
    bound = _graft_bound(K, R, d, r, B=B)
    print(f"[engine] {what} B={B} K={K} R={R} d={d} rank={r}: one batched launch "
          f"{t['batched']:.4f} ms (events), {t['batched_device']:.4f} ms (profiler device "
          f"time), {B} single launches {t['singles']:.4f} ms, plain chain "
          f"{t['plain']:.4f} ms; select_multi_batch with the epilogue {t['engine']:.4f} ms "
          f"(use_pallas) vs {t['engine_plain']:.4f} ms (plain); bound {bound[0]:.6f} ms by "
          f"{bound[1]} ({bound[2]} bytes, {bound[3]} flop); batched "
          f"{t['batched'] / bound[0]:.0f}x the bound", flush=True)
    return t, bound


def phase_engine(ctx):
    """The multi-batch selection engine at full width on the trained params."""
    import numpy as np
    import torch
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.selection import GraftConfig
    tr = ctx["trainer"]
    mcfg, tcfg = tr.mcfg, tr.tcfg
    cfg, B, step = tcfg.graft, 4, 6
    stack = tr.data.microbatch_stack(step=step, num_micro=B)
    _zero_counts()
    with torch.no_grad():
        per = [steps_lib.selection_inputs(mcfg, tcfg, tr.state["model"], {
            k: torch.from_numpy(np.ascontiguousarray(v[b])).to("cuda")
            for k, v in stack.items()}) for b in range(B)]
    torch.cuda.synchronize()
    sel_counts = _read_counts()
    Vs, Gs, gbs, scores = (torch.stack(x).contiguous() for x in zip(*per))
    print(f"[engine] microbatch_stack(step={step}, num_micro={B}): tokens "
          f"{stack['tokens'].shape}; selection inputs V {tuple(Vs.shape)}, G "
          f"{tuple(Gs.shape)}, g_bar {tuple(gbs.shape)}, scores {tuple(scores.shape)}; "
          f"flash forwards {sel_counts['flash_forward']} ({B} x {mcfg.num_layers} layers)",
          flush=True)
    assert Vs.shape == (B, tr.config.train.batch, cfg.r_max) and Gs.shape[2] == Vs.shape[1]
    assert sel_counts["flash_forward"] == B * mcfg.num_layers, sel_counts
    assert all(bool(torch.isfinite(x).all()) for x in (Vs, Gs, gbs, scores))
    multi, path_counts = _engine_compare(cfg, Vs, Gs, gbs, scores, step, "slice stack")
    # the same stack through kernels/ops: MaxVol, gather, sweep
    r = cfg.r_max
    fused = gs.graft_select_batched(Vs, Gs, gbs, r)
    _zero_counts()
    chain = []
    for b in range(B):
        piv, lv = ops.fast_maxvol_with_logvol(Vs[b], r)
        err = ops.projection_sweep(Gs[b].index_select(1, piv), gbs[b])
        chain.append((piv, err, lv))
    torch.cuda.synchronize()
    ops_counts = _read_counts()
    assert ops_counts == dict({k: 0 for k in ops_counts}, fast_maxvol=B, projection_sweep=B), \
        f"the ops chain launched {ops_counts}"
    chain_eq = all(torch.equal(piv, fused[0][b]) and torch.equal(err, fused[1][b])
                   and torch.equal(lv, fused[2][b]) for b, (piv, err, lv) in enumerate(chain))
    chain_eq = chain_eq and torch.equal(fused[0], multi.pivots)
    print(f"[engine] kernels/ops chain fast_maxvol -> gather -> projection_sweep on the "
          f"stack: {ops_counts['fast_maxvol']} + {ops_counts['projection_sweep']} launches; "
          f"pivots, logvol and errors {'bit-equal' if chain_eq else 'DIFFER'} to the batched "
          f"kernel's", flush=True)
    assert chain_eq, "the ops chain differs from the fused kernel"
    launches = {"graft_select_batched": path_counts["graft_select_batched"],
                "fast_maxvol": ops_counts["fast_maxvol"],
                "projection_sweep": ops_counts["projection_sweep"]}
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on its path"
    ctx["kernels"]["fast_maxvol"]["launches"] = launches["fast_maxvol"]
    ctx["kernels"]["projection_sweep"]["launches"] = launches["projection_sweep"]
    want = gs.graft_select_batched_reference(Vs, Gs, gbs, r)
    piv_eq, gsel_eq, err_d, lv_d = _refresh_diff(fused, want)
    assert piv_eq and gsel_eq and err_d <= 1e-5, "batched kernel vs its plain version"
    t, bound = _engine_times(cfg, Vs, Gs, gbs, scores, step, "slice stack")
    ctx["kernels"]["graft_select_batched"] = _entry(
        "graft_select_batched", "src/repro/kernels/graft_select.py:175",
        launches["graft_select_batched"],
        max(err_d, lv_d), t["batched"], t["plain"], bound, t["batched_device"])
    # the selection benchmark's shape (benchmarks/bench_selection_overhead.py)
    bcfg = GraftConfig(rset=(8, 16, 32), eps=0.25, use_pallas=True)
    Vs, Gs, gbs = _random_refresh(256, 32, 1024, "cuda", B=8, seed=5)
    scores = torch.zeros(8, 256, device="cuda")
    _engine_compare(bcfg, Vs, Gs, gbs, scores, 0, "benchmark shape")
    _engine_times(bcfg, Vs, Gs, gbs, scores, 0, "benchmark shape")
    unfused = _time_auto(lambda: [ops.projection_sweep(
        Gs[b].index_select(1, ops.fast_maxvol(Vs[b], 32)), gbs[b]) for b in range(8)],
        max_iters=200)
    print(f"[engine] benchmark shape: the unfused ops chain (fast_maxvol, gather, "
          f"projection_sweep) for the 8 refreshes {unfused:.4f} ms", flush=True)


def phase_profile(ctx):
    _profile(ctx["trainer"], "profile")


# substrings of the port's own kernels' names, for their share of a profiled step
PORT_KERNEL_NAMES = ("rwkv_fwd", "rwkv_bwd", "flash_fwd", "flash_dq", "flash_dkv",
                     "graft_select_kernel", "fast_maxvol_kernel", "projection_sweep_kernel")


def _profile(tr, tag):
    """Parts of a step timed apart on a trained state, then one whole step
    under torch.profiler: its kernels by device time."""
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import make_optimizer
    mcfg, tcfg, state = tr.mcfg, tr.tcfg, tr.state
    K, S = tr.config.train.batch, tr.config.train.seq
    batch = tr._to_device(tr.data.batch_at(tcfg.graft.refresh_every * 10))
    refresh = steps_lib.make_selection_refresh(mcfg, tcfg)
    opt = make_optimizer(tcfg.optimizer)
    out = {}

    def timed(name, fn, reps=3):
        out[name] = cuda_time_ms(fn, iters=reps, warmup=1)
        return fn()

    graft_state, _ = timed(f"selection refresh (forward K={K}, features, kernel)",
                           lambda: refresh(state["model"].tree(), batch, {}, 0))
    grads = timed(f"subset forward+backward ({int(graft_state.rank)} x {S} tokens, "
                  f"remat={mcfg.remat})",
                  lambda: torch.autograd.grad(
                      steps_lib.subset_loss(mcfg, state, batch, graft_state),
                      state["params"]), reps=2)
    clipped, _ = timed("global-norm clip", lambda: opt.preprocess(grads))
    timed("AdamW update (in place)",
          lambda: opt.update(state["params"], clipped, state["opt"], 6), reps=1)
    del grads, clipped
    for name, ms in out.items():
        print(f"[{tag}] {name}: {ms:.1f} ms device")
    step_fn = steps_lib.make_train_step(mcfg, tcfg)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if not events or total_ms <= 0:
        print(f"[{tag}] one step {wall_ms:.1f} ms wall; device time not measured "
              "(the profiler saw no CUDA kernels)")
        return
    print(f"[{tag}] one {'refresh' if state['step'] % tcfg.graft.refresh_every == 1 else 'subset'} "
          f"step under the profiler: {wall_ms:.1f} ms wall, {total_ms:.1f} ms of kernels "
          f"(device busy {100 * total_ms / wall_ms:.0f}% of the wall), "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"[{tag}]   {dev_us(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")
    own = [e for e in events if any(n in e.key for n in PORT_KERNEL_NAMES)]
    for e in sorted(own, key=lambda e: -dev_us(e)):
        print(f"[{tag}]   the port's kernel {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:80]}")


def phase_depth8(ctx):
    """Dense vs flash attention on the slice at 8 layers, same seed, one call."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    ctx.pop("trainer", None)           # the full-depth state: free its ~46 GB
    gc.collect()
    torch.cuda.empty_cache()
    steady = {"dense": [], "auto": []}
    for backend in ("dense", "auto", "auto", "dense"):
        cfg = ExperimentConfig().apply_overrides(
            [o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
            + [f'model.overrides={{"attn_backend": "{backend}", "num_layers": 8}}',
               "train.log_every=0"])
        _zero_counts()
        report = Trainer(cfg).fit()
        counts = _read_counts()
        flash_ran = counts["flash_forward"] > 0
        assert flash_ran == (backend == "auto"), f"{backend}: launches {counts}"
        hist = report["history"]
        assert all(np.isfinite(r["loss"]) for r in hist), "non-finite loss"
        times = [r["step_time_s"] * 1e3 for r in hist]
        steady[backend].append(float(np.mean(times[1:])))
        print(f"[depth8] attn {backend}{' (flash)' if flash_ran else ''}: step ms "
              f"{[round(x, 1) for x in times]}; steady (steps 1-5) mean {steady[backend][-1]:.1f} ms; "
              f"losses {[round(r['loss'], 5) for r in hist]}", flush=True)
        del report
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[depth8] steady step mean over both runs: dense {np.mean(steady['dense']):.1f} ms, "
          f"flash {np.mean(steady['auto']):.1f} ms")


# (name, BH, T, D, w_low): the JAX kernel test's shapes, rwkv6-7b's
# selection forward (16 sequences × 64 heads), its subset forward and
# backward at rank 8 (8 × 64) and at rank 2 (2 × 64, the rank phase
# rwkv_slice picks), the rank-2 shape again with w in [0, 0.59) (decays down
# to 0), a long context, a T that is not a multiple of the time tile, and a
# D the model never uses; w uniform in [w_low, w_low + 0.59)
RWKV_SHAPES = [
    ("jax_1x32x16", 1, 32, 16, 0.4), ("jax_4x64x32", 4, 64, 32, 0.4),
    ("jax_2x128x64", 2, 128, 64, 0.4), ("jax_3x96x48", 3, 96, 48, 0.4),
    ("selection", 1024, 256, 64, 0.4), ("subset", 512, 256, 64, 0.4),
    ("subset_r2", 128, 256, 64, 0.4), ("subset_w0", 128, 256, 64, 0.0),
    ("long_context", 64, 4096, 64, 0.4), ("ragged_T", 64, 250, 64, 0.4),
    ("D256", 16, 256, 256, 0.4),
]
RWKV_REPLACES = {
    "rwkv_scan": "src/repro/kernels/rwkv_scan.py:49",
    "rwkv_scan_backward": "src/repro/kernels/rwkv_scan.py:49 (its gradient: the JAX "
                          "package differentiates lax.scan, src/repro/models/ssm.py:86)"}


def _rwkv_inputs(BH, T, D, seed=0, w_low=0.4):
    """The JAX kernel test's distributions, drawn on the card: w uniform in
    [w_low, w_low + 0.59)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    w = w_low + 0.59 * torch.rand((BH, T, D), generator=g, device="cuda")
    return (rnd(BH, T, D, scale=0.3), rnd(BH, T, D, scale=0.3), rnd(BH, T, D, scale=0.3),
            w, rnd(BH, D, scale=0.1), rnd(BH, T, D))


def _rwkv_bound(kind, BH, T, D):
    """Least time on an H100 for the function, not for this design. Bytes:
    each input read and each output written once — forward r, k, v, w, u →
    o; backward r, k, v, w, u, do → dr, dk, dv, dw, du. The tile states the
    kernels save and reload are this design's intermediate and not counted.
    Float32 operations per state element per step: forward 5 (r·S 2, the
    decay update and k·vᵀ 3) plus 5 per step and k-row for the bonus
    (Σ r u k, then its multiple of v); backward 14 (one recompute of S, the
    dS update, and the dr, dk, dv, dw sums) plus 16 per step and row for c,
    the u terms, du and Σ r u k."""
    stream, vec = BH * T * D * 4, BH * D * 4
    if kind == "fwd":
        return _bound(5 * stream + vec, BH * T * (5 * D * D + 5 * D))
    return _bound(9 * stream + 2 * vec, BH * T * (14 * D * D + 16 * D))


def phase_rwkv(ctx):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv_scan as rw
    for name, BH, T, D, w_low in RWKV_SHAPES:
        r, k, v, w, u, do = _rwkv_inputs(BH, T, D, w_low=w_low)
        o, states = rw.rwkv_scan_forward(r, k, v, w, u, save_states=True)
        grads = rw.rwkv_scan_backward(r, k, v, w, u, do, states)
        o_ng, none = rw.rwkv_scan_forward(r, k, v, w, u)
        o2, states2 = rw.rwkv_scan_forward(r, k, v, w, u, save_states=True)
        grads2 = rw.rwkv_scan_backward(r, k, v, w, u, do, states2)
        torch.cuda.synchronize()
        same = none is None and torch.equal(o, o_ng) and torch.equal(o, o2) and \
            torch.equal(states, states2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
        want = rw.rwkv_scan_reference(r, k, v, w, u)
        want_g = rw.rwkv_scan_backward_reference(r, k, v, w, u, do)
        torch.cuda.synchronize()
        # tolerance: float32 sums in another order — over D for the output
        # (1e-5 of its largest value), over D and T for the gradients (1e-4)
        errs, ok = {}, same
        for what, a, b in zip(("o", "dr", "dk", "dv", "dw", "du"), (o,) + grads,
                              (want,) + want_g):
            errs[what] = (a - b).abs().max().item()
            scale = b.abs().max().item()
            ok = ok and errs[what] <= (1e-5 if what == "o" else 1e-4) * scale + 1e-6
        chunks = ""
        if T % 64 == 0:
            outs = [ops.rwkv_scan(r, k, v, w, u, chunk=c) for c in (16, 32, 64)]
            inv = all(torch.equal(x, o) for x in outs)
            ok = ok and inv
            chunks = f", ops.rwkv_scan chunk 16/32/64 {'bit-equal' if inv else 'DIFFER'}"
        print(f"[rwkv] {name}: BH={BH} T={T} D={D}: max|diff| "
              + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
              + f"; reruns and the no-grad forward {'bit-equal' if same else 'DIFFER'}"
              f"{chunks} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"rwkv kernels disagree with their plain versions on {name}")
        del want, want_g, o2, states2, grads2, o_ng
        t = {"fwd": _time_auto(lambda: rw.rwkv_scan_forward(r, k, v, w, u)),
             "fwd_states": _time_auto(lambda: rw.rwkv_scan_forward(r, k, v, w, u,
                                                                   save_states=True)),
             "bwd": _time_auto(lambda: rw.rwkv_scan_backward(r, k, v, w, u, do, states))}
        plain = {"fwd": _time_auto(lambda: rw.rwkv_scan_reference(r, k, v, w, u), max_iters=5),
                 "bwd": _time_auto(lambda: rw.rwkv_scan_backward_reference(
                     r, k, v, w, u, do), max_iters=5)}
        plain["fwd_states"] = plain["fwd"]
        bounds = {"fwd": _rwkv_bound("fwd", BH, T, D),
                  "fwd_states": _rwkv_bound("fwd", BH, T, D),
                  "bwd": _rwkv_bound("bwd", BH, T, D)}
        for kind in t:
            b_ms, b_by, nbytes, flops = bounds[kind]
            print(f"[rwkv] {name} {kind}: kernel {t[kind]:.4f} ms, plain {plain[kind]:.4f} ms, "
                  f"library none, bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} flop); "
                  f"{t[kind] / b_ms:.1f}x the bound", flush=True)
        # the kernels line: the forward at the selection forward's shape, the
        # backward at the subset's at rank 2 (where each runs on the path)
        for key, shape, kind, err in (("rwkv_scan", "selection", "fwd", errs["o"]),
                                      ("rwkv_scan_backward", "subset_r2", "bwd",
                                       max(errs[x] for x in ("dr", "dk", "dv", "dw", "du")))):
            if name == shape:
                ctx["kernels"][key] = {
                    "name": key, "route": "cuda", "source": "src/repro_torch/csrc/rwkv_scan.cu",
                    "replaces": RWKV_REPLACES[key], "launches": None, "max_abs_err": err,
                    "ms": t[kind], "plain_ms": plain[kind], "bound_ms": bounds[kind][0],
                    "bound_by": bounds[kind][1], "library_ms": None}
        del r, k, v, w, u, do, o, states, grads
        torch.cuda.empty_cache()


RWKV_LAYERS = 16


def phase_rwkv_slice(ctx):
    """rwkv6-7b at full width, depth cut to RWKV_LAYERS, through Trainer."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.models import ssm
    ctx.pop("trainer", None)           # minicpm's state: the two do not fit together
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ExperimentConfig().apply_overrides(
        [o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
        + ["model.arch=rwkv6-7b", f'model.overrides={{"num_layers": {RWKV_LAYERS}}}'])
    mcfg = cfg.model.build()
    per_layer = 2 * mcfg.d_model + sum(      # ln1, ln2, time mix, channel mix
        int(np.prod(s)) for shapes in (ssm.rwkv_time_shapes(mcfg, mcfg.dtype),
                                       ssm.rwkv_channel_shapes(mcfg, mcfg.dtype))
        for s, _ in shapes.values())
    head = mcfg.vocab_size * mcfg.d_model * (1 if mcfg.tie_embeddings else 2)
    n_params = head + mcfg.d_model + mcfg.num_layers * per_layer
    full = head + mcfg.d_model + 32 * per_layer
    print(f"[rwkv_slice] rwkv6-7b full width: d_model {mcfg.d_model}, {mcfg.num_heads} heads x "
          f"{mcfg.d_model // mcfg.num_heads}, d_ff {mcfg.d_ff}, vocab {mcfg.vocab_size}, "
          f"untied head, lora rank {ssm.lora_rank(mcfg)}, {mcfg.param_dtype} params, "
          f"remat={mcfg.remat}; depth cut to {mcfg.num_layers} of 32 layers: "
          f"{n_params / 1e9:.3f} B params (32 layers: {full / 1e9:.3f} B) -> bf16 params + "
          f"grads + f32 AdamW moments ~{n_params * 12 / 1e9:.1f} GB (32 layers: "
          f"~{full * 12 / 1e9:.1f} GB)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg)
    _zero_counts()
    t0 = time.perf_counter()
    report = trainer.fit()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = report["history"]
    for i, row in enumerate(hist):
        print(f"[rwkv_slice] step {i}: loss {row['loss']:.6f} rank {row['rank']} "
              f"proj_error {row['proj_error']:.4f} grad_norm {row['grad_norm']:.4f} "
              f"step {row['step_time_s'] * 1e3:.1f} ms")
    expected = _expected_launches(mcfg, cfg)
    print(f"[rwkv_slice] fit wall {wall:.2f} s, {report['num_params']} params, peak memory "
          f"allocated {peak_gb:.2f} GB, kernel launches {launches}", flush=True)
    print(f"[rwkv_slice] expected launches {expected}")
    assert report["num_params"] == n_params, (report["num_params"], n_params)
    assert all(np.isfinite(r["loss"]) for r in hist), "non-finite loss"
    assert all(int(r["rank"]) in cfg.graft.rset for r in hist), "rank outside rset"
    assert launches == expected, f"launches {launches}, expected {expected}"
    for name in ("rwkv_scan", "rwkv_scan_backward"):
        assert launches[name] > 0, f"kernel {name} was never launched on the main path"
        ctx["kernels"][name]["launches"] = launches[name]
    steady = [r["step_time_s"] for r in hist[1:]]
    print(f"[rwkv_slice] steady step time (steps 1-5) mean {np.mean(steady) * 1e3:.1f} ms; "
          f"refresh steps {[round(r['step_time_s'] * 1e3, 1) for r in hist[2::2]]} ms")
    _profile(trainer, "rwkv_slice")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def phase_check(ctx):
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps as steps_lib
    base = ['model.overrides={"param_dtype": "float32", "attn_backend": "flash"}',
            "train.steps=4", "train.batch=8", "graft.rset=[2,4]",
            "graft.refresh_every=2", "graft.use_pallas=true"]
    for arch, seq in (("minicpm-2b", 16), ("gemma2-27b", 32), ("rwkv6-7b", 16)):
        cfg = ExperimentConfig().apply_overrides(
            [f"model.arch={arch}", f"train.seq={seq}"] + base)
        runs = {}
        for dev in ("cuda", "cpu"):
            mcfg, tcfg, data = cfg.build()
            gen = torch.Generator(device="cpu").manual_seed(0)
            model_cpu = steps_lib.init_train_state(mcfg, tcfg, gen, 8)["model"]
            state = steps_lib.state_for_model(mcfg, tcfg, model_cpu.to(dev), 8)
            step_fn = steps_lib.make_train_step(mcfg, tcfg)
            rows = []
            _zero_counts()
            for s in range(cfg.train.steps):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(s).items()}
                state, m = step_fn(state, batch)
                rows.append((m["loss"].item(), int(m["rank"]),
                             state["graft"].pivots.cpu().tolist()))
            counts = _read_counts()
            kernel = "rwkv_scan" if mcfg.family == "ssm" else "flash_forward"
            assert (counts[kernel] > 0) == (dev == "cuda"), f"{dev}: {counts}"
            runs[dev] = rows
        if mcfg.family == "ssm":
            print(f"[check] {arch} seq {seq} through the RWKV kernels ({mcfg.num_heads} heads "
                  f"x {mcfg.d_model // mcfg.num_heads})")
        else:
            print(f"[check] {arch} seq {seq} under flash (window {mcfg.sliding_window}, "
                  f"softcap {mcfg.attn_logit_softcap}, GQA {mcfg.num_heads // mcfg.num_kv_heads}, "
                  f"head_dim {mcfg.head_dim})")
        for (lg, rg, pg), (lc, rc, pc) in zip(runs["cuda"], runs["cpu"]):
            print(f"[check] loss gpu {lg:.7f} cpu {lc:.7f}; rank {rg}/{rc}; pivots {pg}/{pc}")
            assert abs(lg - lc) <= 1e-4 * abs(lc) and rg == rc and pg == pc, \
                "GPU run disagrees with the CPU run"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"cannot import repro_torch next to {__file__}: {e}", file=sys.stderr)
        return 2
    ctx = {}
    failed = []
    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", phase_kernels), ("flash", phase_flash),
                     ("slice", phase_slice), ("engine", phase_engine),
                     ("profile", phase_profile), ("depth8", phase_depth8),
                     ("rwkv", phase_rwkv), ("rwkv_slice", phase_rwkv_slice),
                     ("check", phase_check)):
        print(f"=== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:                          # noqa: BLE001 — report, go on
            traceback.print_exc()
            failed.append(name)
        print(f"=== phase {name} {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if name in ("device", "build") and failed:
            break
    kernels = list(ctx.get("kernels", {}).values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    unrun = [k.get("name") for k in kernels
             if any(f not in k for f in keys) or not k["launches"]]
    if not failed and (len(kernels) != len(_kernel_counters()) or unrun):
        print(f"chip_smoke: kernels without a full entry or a launch on their path: "
              f"{unrun or [k.get('name') for k in kernels]}", file=sys.stderr)
        failed.append("kernels line")
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
