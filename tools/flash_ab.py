#!/usr/bin/env python3
"""Time the bf16 flash-attention kernels of two checkouts of this repo on one
CUDA card, in turns A, B, B, A, at ``chip_smoke.py``'s bf16 flash shapes.

    python3 tools/flash_ab.py OTHER_ROOT [--out FILE]

A is OTHER_ROOT, another checkout of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists);
B is the checkout this script is in. Both builds run first, in parallel,
each into its own root's ``build/``. Each turn is then a subprocess that
imports ``repro_torch`` from its root and times ``flash_forward``,
``flash_dq`` and ``flash_dkv`` on the same seeded inputs twice: with CUDA
events around the wrapper calls (``ms``: device time and the host time
between launches), and under ``torch.profiler`` (``device_ms``: the device
time of the flash kernels alone, per call). At the shapes without a window
or softcap each turn also times PyTorch's scaled_dot_product_attention
forward (``sdpa_fwd``) and one backward call for dQ, dK and dV
(``sdpa_bwd``), the yardsticks, whose ``device_ms`` sums every kernel of
the call; the same library runs in both turns, so their B/A is the noise.
Prints the card's name and power limit, one row per (shape, kernel) with
the four times of each kind and B's mean over A's, and writes every time
to FILE as JSON. Needs one card; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(B, H, Hkv, S, Dh, dtype, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(n):
        return torch.randn((n, S, Dh), generator=g, device="cuda").to(getattr(torch, dtype))
    return rnd(B * H), rnd(B * Hkv), rnd(B * Hkv), rnd(B * H)


def times(fn, cuda_time_ms, match="flash_", budget_ms=300.0, max_iters=50):
    """(CUDA-event ms per call, profiler device ms per call of the kernels
    whose name holds ``match``), over an iteration count sized to the
    budget."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_time_ms(fn, iters=2, warmup=1)
    iters = int(min(max_iters, max(2, budget_ms / max(ms, 1e-3))))
    ms = cuda_time_ms(fn, iters=iters, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key)
    if us <= 0:
        raise RuntimeError(f"the profiler saw no kernel matching {match!r}")
    return ms, us / 1e3 / iters


def _worker(root: str, build_only: bool) -> None:
    sys.path.insert(0, HERE)
    from chip_smoke import FLASH_SHAPES, cuda_time_ms
    sys.path.insert(0, os.path.join(root, "src"))   # this root's repro_torch
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    assert os.path.dirname(fa.__file__).startswith(os.path.abspath(root)), fa.__file__
    if build_only:
        build.load("flash_attention")
        return
    rows = []
    for name, B, H, Hkv, S, Dh, dtype, causal, window, softcap in FLASH_SHAPES:
        if dtype != "bfloat16":
            continue
        q, k, v, do = _inputs(B, H, Hkv, S, Dh, dtype)
        kw = dict(causal=causal, window=window, softcap=softcap, group=H // Hkv)
        o, lse = fa.flash_forward(q, k, v, **kw)
        delta = (o.float() * do.float()).sum(-1)
        for kind, fn in (("fwd", lambda: fa.flash_forward(q, k, v, **kw)),
                         ("dq", lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw)),
                         ("dkv", lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw))):
            ms, device_ms = times(fn, cuda_time_ms)
            rows.append({"shape": name, "kind": kind, "ms": ms, "device_ms": device_ms})
        if window is None and softcap is None:
            q4, k4, v4 = (x.view(B, -1, S, Dh).detach().requires_grad_() for x in (q, k, v))
            sdpa = dict(is_causal=causal, enable_gqa=H != Hkv, scale=Dh ** -0.5)
            o4 = F.scaled_dot_product_attention(q4, k4, v4, **sdpa)
            do4 = do.view(B, H, S, Dh)
            for kind, fn in (("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                                 q4, k4, v4, **sdpa)),
                             ("sdpa_bwd", lambda: torch.autograd.grad(
                                 o4, (q4, k4, v4), do4, retain_graph=True))):
                ms, device_ms = times(fn, cuda_time_ms, match="")
                rows.append({"shape": name, "kind": kind, "ms": ms, "device_ms": device_ms})
            del q4, k4, v4, o4
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "rows": rows}))


def _run(script: str, root: str, *flags: str) -> str:
    out = subprocess.run([sys.executable, os.path.abspath(script), "--worker", root, *flags],
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"worker for {root} failed:\n{out.stdout}\n{out.stderr}")
    return out.stdout


def run_ab(script: str, worker, doc: str) -> int:
    """The A/B driver shared by the tools of this directory: ``script
    OTHER_ROOT [--out FILE]`` builds both roots in parallel (``worker(root,
    True)`` in a subprocess of ``script``, whose printed lines it repeats),
    runs the turns A B B A (one subprocess each, ``worker(root, False)``
    printing ``{"rows": [{"shape", "kind", "ms", "device_ms"}, ...]}`` as
    its last line), prints the card's name and power limit and one row per
    (shape, kind) with B's mean over A's, and writes every time to FILE as
    JSON."""
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2], "--build" in sys.argv[3:])
        return 0
    if len(sys.argv) not in (2, 4) or (len(sys.argv) == 4 and sys.argv[2] != "--out"):
        print(doc, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(f"no CUDA device: {os.path.basename(script)} needs an NVIDIA GPU", file=sys.stderr)
        return 2
    roots = {"A": os.path.abspath(sys.argv[1]), "B": HERE}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda r: _run(script, r, "--build"), roots.values()))
    for turn, out in zip(roots, built):
        for line in out.strip().splitlines():
            print(f"build {turn}: {line}")
    by_row = {}
    for turn in "ABBA":
        res = json.loads(_run(script, roots[turn]).strip().splitlines()[-1])
        for row in res["rows"]:
            t = by_row.setdefault((row["shape"], row["kind"]),
                                 {m: {"A": [], "B": []} for m in ("ms", "device_ms")})
            for m in t:
                t[m][turn].append(row[m])
    print(f"A = {roots['A']}, B = {roots['B']}; ms in turns A B B A")
    table = []
    for (shape, kind), t in by_row.items():
        cols = []
        for m, ab in t.items():
            a, b = sum(ab["A"]) / 2, sum(ab["B"]) / 2
            cols.append(f"{m} A {ab['A'][0]:.4f} B {ab['B'][0]:.4f} B {ab['B'][1]:.4f} "
                        f"A {ab['A'][1]:.4f} B/A {b / a:.3f}")
        print(f"{shape:16s} {kind:10s} " + " | ".join(cols))
        table.append({"shape": shape, "kind": kind, **t})
    if len(sys.argv) == 4:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[3])), exist_ok=True)
        with open(sys.argv[3], "w") as f:
            json.dump({"device": smi.stdout.strip(), "roots": roots, "rows": table}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(run_ab(__file__, _worker, __doc__))
