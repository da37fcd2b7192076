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
  3. kernels — each kernel against its plain PyTorch twin on the card, at
               the training path's shapes and on degenerate inputs (exact
               equality where the arithmetic is the same, a stated tolerance
               where only the summation order differs), then timed with CUDA
               events against the twin.
  4. slice   — the training path through the user entry point
               (``repro_torch.api.Trainer``) on minicpm-2b at full width:
               6 steps, GRAFT refresh every 2 steps through the kernel. The
               kernels' launch counts are zeroed just before and read just
               after; every kernel of the path must have launched.
  5. profile — where a steady step's time goes: the selection refresh, the
               subset forward/backward, clipping and the AdamW update timed
               apart with CUDA events on the trained state, and the top
               kernels of one whole step by device time (torch.profiler).
  6. check   — the same path at smoke size on the card against the port's
               CPU run (which the CPU tests hold against the JAX package):
               per-step losses rtol 1e-4, ranks and pivots equal.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""
import json
import os
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

SLICE_OVERRIDES = [
    "model.smoke=false", 'model.overrides={"attn_backend": "dense"}',
    "graft.use_pallas=true", "graft.rset=[2,4,8]", "graft.eps=0.25",
    "graft.refresh_every=2", "train.batch=16", "train.seq=256",
    "train.steps=6", "train.log_every=1",
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
        for line in b.ptxas_log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                print(f"[{b.name}] {line.strip()}")


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


def _graft_bound(K, R, d, rank):
    """Least time for the refresh on an H100: its inputs read once and its
    outputs written once over HBM bandwidth, vs its float32 operations."""
    nbytes = 4 * (K * R + d * K + d + rank + rank + 1 + d * rank)
    maxvol = rank * (K + 2 * K * R)                    # divide, multiply-subtract
    sweep = sum(2 * 4 * d * j + 6 * d for j in range(rank))  # 2 CGS passes + norm/dot
    flops = maxvol + sweep
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def phase_kernels(ctx):
    import numpy as np
    import torch
    from repro_torch.kernels.graft_select import graft_select, graft_select_reference
    dev = torch.device("cuda")
    cases = [("slice", 16, 8, 2304, 8), ("wide", 256, 64, 4096, 64),
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
    # time at the training path's shapes
    K, R, d, rank = 16, 8, 2304, 8
    args = _graft_inputs("slice", K, R, d, rank, dev, seed=1)
    ms = cuda_time_ms(lambda: graft_select(*args), iters=500, warmup=20)
    plain_ms = cuda_time_ms(lambda: graft_select_reference(*args), iters=50, warmup=5)
    bound_ms, bound_by, nbytes, flops = _graft_bound(K, R, d, rank)
    print(f"[graft_select] K={K} R={R} d={d} rank={rank}: kernel {ms:.4f} ms, "
          f"twin {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
          f"({nbytes} bytes, {flops} flop); {ms / bound_ms:.0f}x the bound")
    ctx["kernels"] = {"graft_select": {
        "name": "graft_select", "route": "cuda",
        "source": "src/repro_torch/csrc/graft_select.cu",
        "replaces": "src/repro/kernels/graft_select.py:137",
        "launches": None, "max_abs_err": ctx["graft_max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}}


def _kernel_counters():
    from repro_torch.kernels import graft_select as gs
    return {"graft_select": gs.graft_select}


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
    counters = _kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    trainer = ctx["trainer"] = Trainer(cfg)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    report = trainer.fit()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = report["history"]
    for i, row in enumerate(hist):
        print(f"[slice] step {i}: loss {row['loss']:.6f} rank {row['rank']} "
              f"proj_error {row['proj_error']:.4f} alignment {row['alignment']:.4f} "
              f"grad_norm {row['grad_norm']:.4f} step {row['step_time_s'] * 1e3:.1f} ms")
    print(f"[slice] fit wall {wall:.2f} s, peak memory allocated {peak_gb:.2f} GB, "
          f"kernel launches {launches}, config_hash {report['config_hash']}")
    refreshes = sum(1 for s in range(cfg.train.steps) if s % cfg.graft.refresh_every == 0)
    assert all(np.isfinite(r["loss"]) for r in hist), "non-finite loss"
    assert all(int(r["rank"]) in cfg.graft.rset for r in hist), "rank outside rset"
    assert launches["graft_select"] == refreshes, \
        f"graft_select launched {launches['graft_select']} times, expected {refreshes}"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on the main path"
        ctx["kernels"][name]["launches"] = n
    steady = [r["step_time_s"] for r in hist[1:]]
    print(f"[slice] steady step time (steps 1-5) mean {np.mean(steady) * 1e3:.1f} ms; "
          f"refresh steps {[r['step_time_s'] * 1e3 for r in hist[2::2]]} ms")


def phase_profile(ctx):
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import make_optimizer
    tr = ctx["trainer"]
    mcfg, tcfg, state = tr.mcfg, tr.tcfg, tr.state
    batch = tr._to_device(tr.data.batch_at(tcfg.graft.refresh_every * 10))
    refresh = steps_lib.make_selection_refresh(mcfg, tcfg)
    opt = make_optimizer(tcfg.optimizer)
    out = {}

    def timed(name, fn, reps=3):
        out[name] = cuda_time_ms(fn, iters=reps, warmup=1)
        return fn()

    graft_state, _ = timed("selection refresh (forward K=16, features, kernel)",
                           lambda: refresh(state["model"].tree(), batch, {}, 0))
    grads = timed("subset forward+backward (8 x 256 tokens, remat)",
                  lambda: torch.autograd.grad(
                      steps_lib.subset_loss(mcfg, state, batch, graft_state),
                      state["params"]), reps=2)
    clipped, _ = timed("global-norm clip", lambda: opt.preprocess(grads))
    timed("AdamW update (in place)",
          lambda: opt.update(state["params"], clipped, state["opt"], 6), reps=1)
    del grads, clipped
    for name, ms in out.items():
        print(f"[profile] {name}: {ms:.1f} ms device")
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
        print(f"[profile] one step {wall_ms:.1f} ms wall; device time not measured "
              "(the profiler saw no CUDA kernels)")
        return
    print(f"[profile] one {'refresh' if state['step'] % tcfg.graft.refresh_every == 1 else 'subset'} "
          f"step under the profiler: {wall_ms:.1f} ms wall, {total_ms:.1f} ms of kernels "
          f"(device busy {100 * total_ms / wall_ms:.0f}% of the wall), "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")


def phase_check(ctx):
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps as steps_lib
    cfg = ExperimentConfig().apply_overrides([
        'model.overrides={"param_dtype": "float32"}', "train.steps=4",
        "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
        "graft.refresh_every=2", "graft.use_pallas=true"])
    runs = {}
    for dev in ("cuda", "cpu"):
        mcfg, tcfg, data = cfg.build()
        gen = torch.Generator(device="cpu").manual_seed(0)
        model_cpu = steps_lib.init_train_state(mcfg, tcfg, gen, 8)["model"]
        state = steps_lib.state_for_model(mcfg, tcfg, model_cpu.to(dev), 8)
        step_fn = steps_lib.make_train_step(mcfg, tcfg)
        rows = []
        for s in range(cfg.train.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(s).items()}
            state, m = step_fn(state, batch)
            rows.append((m["loss"].item(), int(m["rank"]),
                         state["graft"].pivots.cpu().tolist()))
        runs[dev] = rows
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
                     ("kernels", phase_kernels), ("slice", phase_slice),
                     ("profile", phase_profile), ("check", phase_check)):
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
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(ctx["kernels"].values())}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
