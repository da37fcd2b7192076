#!/usr/bin/env python3
"""How far step 0's gradient of ``chip_smoke.py`` phase fsdp's
configuration (minicpm-2b at full width, 2 layers, the slice's GRAFT
settings, seed 0) lies from the same gradient in float32, leaf by leaf, on
one CUDA card: computed in one process over the whole selected subset
("one"), and over the subset split into the (2, 2) fleet's 4 parts in rank
order, the parts summed in bfloat16 ("parts-bf16") and in float32
("parts-f32"); with the parts' norms over their sum's norm (how much the
parts cancel). The measurement behind phase fsdp's per-leaf bar, which
holds the fleet to the split.

    python3 tools/fsdp_split_gaps.py

Prints the card's name and power limit, the step's pivots and weights, and
a line a leaf (relative Frobenius norms). Needs one card; imports nothing
of JAX.
"""
import dataclasses
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def rel(a, b):
    import torch
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main():
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    ctx = {}
    cs.phase_device(ctx)
    cs.phase_build(ctx)
    cfg = ExperimentConfig().apply_overrides(cs.FSDP_OVERRIDES)
    mcfg, tcfg, data = cfg.build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = steps.state_for_model(mcfg, tcfg, model_lib.init_params(mcfg, gen, "cuda"), 16)
    init = [p.detach().clone() for p in state["params"]]
    fn = steps.make_train_step(mcfg, tcfg)
    state, m = fn(state, batch)
    g0 = state["graft"]
    print("pivots", g0.pivots.tolist(), "weights", g0.weights.tolist(), flush=True)

    def grads_of(dtype, rows=None):
        c = dataclasses.replace(mcfg, param_dtype=dtype)
        model = model_lib.Model(c, "cuda")
        params = list(model.parameters())
        with torch.no_grad():
            for p, q in zip(params, init):
                p.copy_(q)
        loss = steps.subset_loss(c, {"model": model}, batch, g0, rows)
        gs = steps.param_grads(loss, params)
        tree = model_lib.values_tree(model, list(gs))
        return dict(zip(cs._tree_paths(tree), model_lib._leaves(tree)))

    true = grads_of("float32")
    one = grads_of("bfloat16")
    parts = [grads_of("bfloat16", types.SimpleNamespace(
        process_index=r, process_count=4, all_gather_rows=lambda x: x)) for r in range(4)]
    for path in true:
        ps = [p[path] for p in parts]
        s16 = ps[0].clone()
        for p in ps[1:]:
            s16 = s16 + p
        s32 = sum(p.float() for p in ps)
        canc = sum(float(torch.linalg.vector_norm(p.float())) for p in ps) / float(
            torch.linalg.vector_norm(s32))
        print(f"{path}: one {rel(one[path], true[path]):.4f} parts-bf16 "
              f"{rel(s16, true[path]):.4f} parts-f32 {rel(s32, true[path]):.4f} "
              f"sum|part|/|sum| {canc:.2f} |true| {float(torch.linalg.vector_norm(true[path])):.4g}",
              flush=True)


if __name__ == "__main__":
    main()
