#!/usr/bin/env python3
"""Steady step of ``chip_smoke.py``'s phase slice (minicpm-2b at full width
and depth, 6 steps, the GRAFT refresh every 2 steps through the kernels)
for several checkouts of this repo, in turns on one CUDA card.

    python3 tools/slice_ab.py ROOT [ROOT ...] [--turns 2] [--out FILE]

Each ROOT is a checkout (for example an older commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists, or ``.``). Every
root's kernels are built first, all roots in parallel, each into its own
``build/``. Then each turn is a subprocess that imports that root's own
``chip_smoke.py`` and runs its phases device and slice; the turns go
forward through the roots and back (A B C C B A for ``--turns 2``), so
that a drift of the card over the call weighs on every root alike. Prints
the card's name and power limit, each run's step times and each root's
steady-step means (steps 1-5), and writes them to FILE as JSON. Needs one
card; imports nothing of JAX.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STEP_RE = re.compile(r"\[slice\] step (\d+): .* step ([0-9.]+) ms")

BUILD = ("import chip_smoke as c; ctx = {}; c.phase_device(ctx); c.phase_build(ctx)")
SLICE = ("import collections, chip_smoke as c; "
         "ctx = {'kernels': collections.defaultdict(dict)}; "
         "c.phase_device(ctx); c.phase_slice(ctx)")


def _run(root: str, code: str, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(roots)) as pool:
        builds = list(pool.map(lambda r: _run(r, BUILD, 900), roots))
    for root, proc in zip(roots, builds):
        if proc.returncode != 0:
            print(f"build failed in {root}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
    print(f"[slice_ab] builds done in {time.perf_counter() - t0:.1f} s", flush=True)

    order = []
    for turn in range(args.turns):
        order += roots if turn % 2 == 0 else roots[::-1]
    runs = []
    for root in order:
        proc = _run(root, SLICE, 900)
        if proc.returncode != 0:
            print(f"phase slice failed in {root}:\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        ms = [float(m.group(2)) for m in STEP_RE.finditer(proc.stdout)]
        if len(ms) < 2:
            print(f"no step times in {root}'s output:\n{proc.stdout[-2000:]}", file=sys.stderr)
            return 1
        steady = sum(ms[1:]) / len(ms[1:])
        runs.append({"root": root, "step_ms": ms, "steady_ms": steady})
        print(f"[slice_ab] {root}: step ms {ms}; steady (steps 1-{len(ms) - 1}) "
              f"{steady:.3f} ms", flush=True)
    summary = {}
    for root in roots:
        mine = [r["steady_ms"] for r in runs if r["root"] == root]
        summary[root] = {"steady_ms": mine, "mean_ms": sum(mine) / len(mine)}
        print(f"[slice_ab] {smi} | {root}: steady step {mine} ms, mean "
              f"{summary[root]['mean_ms']:.3f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
