#!/usr/bin/env python3
"""Time the GRAFT refresh kernels of two checkouts of this repo on one CUDA
card, in turns A, B, B, A, at the shapes the training path and the engine
run, and at the wide and standalone shapes that share their device code.

    python3 tools/select_ab.py OTHER_ROOT [--out FILE]

A is OTHER_ROOT, another checkout of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists);
B is the checkout this script is in. The build, the turns and the table
are ``tools/flash_ab.py``'s (``run_ab``). Each turn imports ``repro_torch``
from its root and times, on the same seeded inputs (``chip_smoke.py``'s
``_random_refresh``):

* ``graft_select`` (K, R, d, rank) at (16, 8, 2304, 8), the minicpm-2b
  refresh, (16, 8, 4096, 8), the rwkv6-7b one, and (256, 64, 4096, 64), a
  wide refresh whose basis stays in global memory;
* ``graft_select_batched``, the engine's stack of 4 × (16, 8, 2304, 8);
* ``fast_maxvol`` (K, R, rank) (16, 8, 8) and ``projection_sweep`` (d, R)
  (2304, 8) and (16384, 64), the standalone stages of the refresh;

with CUDA events around the wrapper calls (``ms``: device time and the host
time between launches) and under ``torch.profiler`` (``device_ms``: the
device time of the kernels whose names hold ``graft_select``,
``fast_maxvol`` or ``projection_sweep``, per call). Prints the card's name
and power limit first; the build step prints each kernel's registers,
shared memory and spills. Needs one card; imports nothing of JAX.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from flash_ab import HERE, run_ab, times  # noqa: E402

# (kind, name, shape)
SHAPES = [("graft_select", "minicpm_2304", (16, 8, 2304, 8)),
          ("graft_select", "rwkv_4096", (16, 8, 4096, 8)),
          ("graft_select_batched", "stack_B4_2304", (4, 16, 8, 2304, 8)),
          ("graft_select", "wide_global", (256, 64, 4096, 64)),
          ("fast_maxvol", "maxvol_16x8", (16, 8, 8)),
          ("projection_sweep", "sweep_2304x8", (2304, 8)),
          ("projection_sweep", "sweep_16384x64", (16384, 64))]


def _worker(root: str, build_only: bool) -> None:
    sys.path.insert(0, HERE)
    from chip_smoke import _random_refresh, cuda_time_ms
    sys.path.insert(0, os.path.join(root, "src"))   # this root's repro_torch
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fast_maxvol as fm
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import projection_sweep as ps
    assert os.path.dirname(gs.__file__).startswith(os.path.abspath(root)), gs.__file__
    if build_only:                                  # registers, shared memory, spills
        log = build.load("graft_select").ptxas_log.splitlines()
        for i, line in enumerate(log):
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
                print(kernel, " ".join(x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                                       if "registers" in x or "spill" in x))
        return
    dev = torch.device("cuda")
    rows = []
    for kind, name, shape in SHAPES:
        if kind == "graft_select":
            K, R, d, rank = shape
            V, G, gb = _random_refresh(K, R, d, dev, seed=1)
            fn = lambda: gs.graft_select(V, G, gb, rank)  # noqa: E731
        elif kind == "graft_select_batched":
            B, K, R, d, rank = shape
            V, G, gb = _random_refresh(K, R, d, dev, B=B, seed=4)
            fn = lambda: gs.graft_select_batched(V, G, gb, rank)  # noqa: E731
        elif kind == "fast_maxvol":
            K, R, rank = shape
            V = _random_refresh(K, R, 64, dev, seed=K)[0]
            fn = lambda: fm.fast_maxvol(V, rank)  # noqa: E731
        else:
            d, R = shape
            G = _random_refresh(R, R, d, dev, seed=d)[1]
            gb = G.mean(dim=1).contiguous()
            fn = lambda: ps.projection_sweep(G, gb)  # noqa: E731
        match = "graft_select" if kind.startswith("graft_select") else kind
        ms, device_ms = times(fn, cuda_time_ms, match=match, max_iters=500)
        rows.append({"shape": name, "kind": kind, "ms": ms, "device_ms": device_ms})
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "rows": rows}))


if __name__ == "__main__":
    sys.exit(run_ab(__file__, _worker, __doc__))
