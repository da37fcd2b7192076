#!/usr/bin/env python3
"""Time the RWKV recurrence's kernels of two checkouts of this repo on one
CUDA card, in turns A, B, B, A, at the D-64 shapes the rwkv6-7b path runs.

    python3 tools/rwkv_ab.py OTHER_ROOT [--out FILE]

A is OTHER_ROOT, another checkout of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists);
B is the checkout this script is in. The build, the turns and the table
are ``tools/flash_ab.py``'s (``run_ab``). Each turn imports ``repro_torch``
from its root and times, on the same seeded inputs (``chip_smoke.py``'s
``_rwkv_inputs``), ``rwkv_scan_forward`` without states (``fwd``, the
selection forward), with states (``fwd_states``, the subset's forward) and
``rwkv_scan_backward`` (``bwd``), at BH 1024, 512 and 128 × T 256 and BH 64
× T 4096, with CUDA events around the wrapper calls (``ms``) and under
``torch.profiler`` (``device_ms``: the device time of the RWKV kernels
alone, per call). Prints the card's name and power limit first. Needs one
card; imports nothing of JAX. The build step prints each side's registers
and spills.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from flash_ab import HERE, run_ab, times  # noqa: E402

# (name, BH, T): D is 64
SHAPES = [("selection", 1024, 256), ("subset_r8", 512, 256), ("subset_r2", 128, 256),
          ("long_context", 64, 4096)]


def _worker(root: str, build_only: bool) -> None:
    sys.path.insert(0, HERE)
    from chip_smoke import _rwkv_inputs, cuda_time_ms
    sys.path.insert(0, os.path.join(root, "src"))   # this root's repro_torch
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv_scan as rw
    assert os.path.dirname(rw.__file__).startswith(os.path.abspath(root)), rw.__file__
    if build_only:                                  # registers and spills of each kernel
        log = build.load("rwkv_scan").ptxas_log.splitlines()
        for i, line in enumerate(log):
            if "Compiling entry function" in line:
                kernel = "rwkv_bwd_kernel" if "rwkv_bwd" in line else "rwkv_fwd_kernel"
                print(kernel, " ".join(x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                                       if "registers" in x or "spill" in x))
        return
    rows = []
    for name, BH, T in SHAPES:
        r, k, v, w, u, do = _rwkv_inputs(BH, T, 64)
        _, states = rw.rwkv_scan_forward(r, k, v, w, u, save_states=True)
        for kind, fn in (("fwd", lambda: rw.rwkv_scan_forward(r, k, v, w, u)),
                         ("fwd_states", lambda: rw.rwkv_scan_forward(r, k, v, w, u,
                                                                     save_states=True)),
                         ("bwd", lambda: rw.rwkv_scan_backward(r, k, v, w, u, do, states))):
            ms, device_ms = times(fn, cuda_time_ms, match="rwkv")
            rows.append({"shape": name, "kind": kind, "ms": ms, "device_ms": device_ms})
        del r, k, v, w, u, do, states
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "rows": rows}))


if __name__ == "__main__":
    sys.exit(run_ab(__file__, _worker, __doc__))
