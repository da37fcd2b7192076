#!/usr/bin/env python3
"""Which kernel records torch.profiler drops from a short profile, on one
CUDA card: the measurement behind ``analysis/runner.py``
``held_to_profiler``'s witnesses and edges.

    python3 tools/profiler_edges.py [--rounds 150] [--gaps 0,0.05] [--prelude] [--out FILE]

With ``--prelude`` it first runs ``chip_smoke.py``'s phases kernels and
flash, which profile a lot (the state in which phase analysis runs). Each
round profiles, for every edge gap in turn (forward and back on alternate
rounds), two short sections of the analysis battery through
``runner.profiled_section`` with ``runner.EDGE_S`` set to the gap: one
refresh launch at minicpm-2b's shape (K 16, R 8, d 2304) and the battery's
streaming section (K 256, d 1024, R 32: two launches). It counts the pre
and post witnesses seen, the profiles whose loss reached past the pre
witnesses or into the post ones, and those whose refresh launches the
profiler miscounted. Then ``held_to_profiler`` on a section that launches
the refresh past its counted route must fail every time. Prints the card's
name and power limit and a JSON summary (also to FILE). Needs one card;
imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--gaps", default="0,0.05",
                    help="host seconds inside each end of the window, comma-separated")
    ap.add_argument("--bypass", type=int, default=40,
                    help="profiles of the section that launches past its route")
    ap.add_argument("--prelude", action="store_true",
                    help="run chip_smoke.py's phases kernels and flash first")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import chip_smoke as cs
    ctx = {"kernels": {}}
    cs.phase_device(ctx)
    cs.phase_build(ctx)
    if args.prelude:
        cs.phase_kernels(ctx)
        cs.phase_flash(ctx)
    import collections
    import torch
    from repro_torch.analysis import launch_audit, runner
    from repro_torch.kernels import graft_select as gs
    dev = torch.device("cuda")
    V, G, gb = (t.to(dev) for t in runner._selection_inputs(16, 2304, 8, "cpu"))

    def refresh():
        gs.graft_select(V, G, gb, 8)
        return runner.Report()

    sections = {
        "refresh K=16 d=2304": (refresh, 1),
        "battery streaming K=256 d=1024": (
            lambda: runner.check_streaming_selection(dev, 256, 1024, 32, (8, 16, 32)), 2),
    }
    gaps = [float(g) for g in args.gaps.split(",")]
    edge = runner.EDGE_S
    stats = {}
    t0 = time.perf_counter()
    for i in range(args.rounds):
        for gap in (gaps if i % 2 == 0 else gaps[::-1]):
            runner.EDGE_S = gap
            for name, (section, want) in sections.items():
                _, _, _, events, (pre, post) = runner.profiled_section(section, dev)
                seen = launch_audit.profiler_counts(events)["graft_select_kernel"]
                st = stats.setdefault(f"{name}, edge {gap} s", {
                    "profiles": 0, "pre_seen": collections.Counter(), "post_seen":
                    collections.Counter(), "loss_past_pre": 0, "post_lost": 0,
                    "refresh_miscounted": 0})
                st["profiles"] += 1
                st["pre_seen"][pre] += 1
                st["post_seen"][post] += 1
                st["loss_past_pre"] += int(pre == 0)
                st["post_lost"] += int(post != runner.POST)
                st["refresh_miscounted"] += int(seen != want)
    runner.EDGE_S = edge

    def bypass():
        gs._launch(V[None], G[None], gb[None], 8, 1, 16, 8, 2304, None, None)
        return runner.Report()

    failed = sum(int(not runner.held_to_profiler(bypass, "bypass", dev).ok)
                 for _ in range(args.bypass))
    result = {"card": ctx["smi"], "rounds": args.rounds, "prelude": args.prelude,
              "seconds": time.perf_counter() - t0,
              "witnesses": {"pre": runner.PRE, "post": runner.POST},
              "sections": {k: {kk: dict(vv) if isinstance(vv, collections.Counter) else vv
                               for kk, vv in v.items()} for k, v in stats.items()},
              "bypass": {"profiles": args.bypass, "failed": failed}}
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if failed == args.bypass else 1


if __name__ == "__main__":
    raise SystemExit(main())
