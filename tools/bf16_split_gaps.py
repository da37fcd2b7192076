"""How far a bfloat16 train step's gradient lies from float32's, in one
process and split as the ``default`` preset splits it, on the CPU at a
reduced width.

One refresh step of ``--arch`` (2 layers, d_model 256, 4 heads of 64,
d_ff 512, vocabulary 512, ``remat="full"``; 8 rows of 64 positions) from
seed-0 weights: in one process in float32 (the bfloat16 draws' values),
in one process in bfloat16, and on two gloo ranks of a (1, 2) ("data",
"model") mesh under ``RULE_PRESETS["default"]`` in bfloat16. It prints the
grad norms and step 0's first moment (the clipped gradient's direction)
of each bfloat16 run against float32's and of the split against the one
process, as a whole and for the leaves furthest apart. Where the two
bfloat16 runs lie as far from float32 as each other, the split rounds no
worse than one process, and the gap between them is bfloat16's.

    PYTHONPATH=src python tools/bf16_split_gaps.py [--arch rwkv6-7b]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.api import ExperimentConfig  # noqa: E402
from repro_torch.backend import fleet  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

WIDTH = {"d_model": 256, "num_heads": 4, "num_kv_heads": 4, "head_dim": 64, "d_ff": 512,
         "vocab_size": 512, "remat": "full"}
ROWS, SEQ = 8, 64


def _gaps(got, want):
    """Each leaf's relative Frobenius gap (by its index in the tree's
    leaves), and the whole tree's."""
    leaves, d2, n2 = [], 0.0, 0.0
    for i, (g, w) in enumerate(zip(model_lib._leaves(got), model_lib._leaves(want))):
        d = float(torch.linalg.vector_norm(g.float() - w.float()))
        n = float(torch.linalg.vector_norm(w.float()))
        d2, n2 = d2 + d * d, n2 + n * n
        leaves.append((i, d / max(n, 1e-30)))
    return leaves, (d2 / n2) ** 0.5


def _one_process(mcfg, tcfg, batch, weights):
    model = model_lib.Model(mcfg)
    with torch.no_grad():
        for p, w in zip(model.parameters(), weights):
            p.copy_(w.to(p.dtype))
    state = steps.state_for_model(mcfg, tcfg, model, ROWS)
    state, m = steps.make_train_step(mcfg, tcfg)(state, batch)
    return float(m["grad_norm"]), model_lib.values_tree(state["model"], state["opt"]["m"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-7b")
    args = ap.parse_args(argv)
    cfg = ExperimentConfig().apply_overrides([
        f"model.arch={args.arch}", f"model.overrides={json.dumps(WIDTH)}", "train.steps=1",
        "train.log_every=0", f"train.batch={ROWS}", f"train.seq={SEQ}", "graft.rset=[2,4]",
        "graft.use_pallas=true", "optimizer.schedule=constant"])
    mcfg, tcfg, _ = cfg.build()
    g = torch.Generator().manual_seed(0)
    batch = {}
    for k, s in specs.batch_specs(mcfg, ROWS, SEQ).items():
        batch[k] = (torch.randn(s.shape, generator=g).to(s.dtype) if s.dtype.is_floating_point
                    else torch.randint(0, mcfg.vocab_size, s.shape, generator=g, dtype=s.dtype))
    weights = list(model_lib.init_params(mcfg, torch.Generator().manual_seed(0)).parameters())
    gn32, m32 = _one_process(dataclasses.replace(mcfg, param_dtype="float32"), tcfg, batch,
                             weights)
    gn16, m16 = _one_process(mcfg, tcfg, batch, weights)
    work = tempfile.mkdtemp(prefix="bf16_split_gaps.")
    try:
        job = {"kind": "tp", "preset": "default", "mesh": ((1, 2), ("data", "model")),
               "arch": args.arch, "smoke": True, "model": WIDTH, "seed": 0, "steps": 1,
               "batches": [batch], "tcfg": dataclasses.asdict(tcfg)}
        torch.save([job], os.path.join(work, "job.pt"))
        port = fleet.free_port()
        runs = fleet.launch([fleet.mesh_worker_command(
            os.path.join(work, "job.pt"), os.path.join(work, "out"),
            fleet.backend_overrides(2, r, port), device="cpu") for r in range(2)], timeout=600)
        got = torch.load(runs[0].last_json()["path"], weights_only=True)["tasks"][0]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    names = [p for p, _ in _paths(m32)]
    print(f"{args.arch} at {WIDTH}, {ROWS} x {SEQ}, one refresh step on the CPU")
    print(f"grad norm: float32 {gn32:.6g}, bfloat16 one process {gn16:.6g} "
          f"({gn16 / gn32 - 1:+.3%}), bfloat16 split {got['grad_norms'][0]:.6g} "
          f"({got['grad_norms'][0] / gn32 - 1:+.3%}; {got['grad_norms'][0] / gn16 - 1:+.3%} "
          f"from one process)")
    for label, a, b in (("bfloat16 one process vs float32", m16, m32),
                        ("bfloat16 split vs float32", got["m0"], m32),
                        ("bfloat16 split vs one process", got["m0"], m16)):
        leaves, whole = _gaps(a, b)
        far = sorted(leaves, key=lambda x: x[1], reverse=True)[:4]
        print(f"first moment, {label}: {whole:.4g} in all; furthest "
              f"{[(names[i], round(x, 4)) for i, x in far]}")
    return 0


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


if __name__ == "__main__":
    sys.exit(main())
