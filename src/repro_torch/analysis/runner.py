"""The full analysis battery — what ``python -m repro_torch.analysis`` runs,
the twin of the JAX package's ``analysis/runner.py``.

Sections, each returning findings in the shared report format:

  * **lint**    — the AST rules over every module under ``src/repro_torch``;
  * **launches** — one call each of the fused selection refresh, the
    streaming (sketch-reservoir) refresh, the sharded engine's refresh on a
    one-rank mesh and the flash-attention probe model against the
    launch-count contracts (one ``graft_select`` per refresh with no gather
    around it — streaming and sharded included, one flash forward per
    attention layer, one dQ and one dK/dV per layer in the train step, no
    unsanctioned host sync and no float64 op in either step), plus SP001:
    no registered sampler may close over mutable Python state;
  * **smem**    — the shared-memory estimator at the probe and production
    shapes, with headroom notes; on the card also every estimate against
    the C library's own sum;
  * **runtime** — a short REAL ``Trainer.fit`` on the probe config with
    ``train.audit=true``: the strict SyncGuard and the signature watcher
    wrap the live step loop, and the run's launches must equal what it
    reckons. Skippable with ``--no-runtime``.

It runs on the card unless told otherwise (``device="cpu"``): there every
section drives the kernels, and a plain version where a kernel is meant to
run is a JX003 error. On the CPU the route decisions count the plain
versions, so the same contracts hold. Exit code 1 on any error-severity
finding.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import launch_audit, lint, smem
from repro_torch.analysis.report import Finding, Report, rule_table
from repro_torch.analysis.sync_guard import SyncGuardError
from repro_torch.api.trainer import resolve_device

# probe shapes — the JAX package's (its bench acceptance configs)
SEL_K, SEL_D, SEL_R, SEL_RSET = 256, 1024, 32, (8, 16, 32)
ATTN_LAYERS, ATTN_B, ATTN_S = 2, 4, 64
# the port's probe runs GRAFT through the refresh kernel, so that its
# launches can be reckoned (the JAX probe's unfused chain launches none)
PORT_PROBE = ("graft.use_pallas=true",)
# production shapes of the smem report: minicpm-2b's selection (K 16, R 8)
# at d 2304 and 4096, flash at its slice (S 256, Dh 64) and long context
REFRESH_SHAPES = ((16, 8, 2304, 8), (16, 8, 4096, 8), (SEL_K, SEL_R, SEL_D, SEL_R))
FLASH_REPORT_SHAPES = ((ATTN_S, ATTN_S, 16, "float32"), (256, 256, 64, "bfloat16"),
                       (2048, 2048, 64, "bfloat16"), (4096, 4096, 128, "bfloat16"))


def check_lint() -> Report:
    return lint.lint_tree()


def _selection_inputs(K: int, d: int, R: int, device):
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.normal(size=(K, R)).astype(np.float32)).to(device)
    G = torch.from_numpy(rng.normal(size=(d, K)).astype(np.float32)).to(device)
    return V, G, G.mean(dim=1)


def check_fused_selection(device=None, K: int = SEL_K, d: int = SEL_D, R: int = SEL_R,
                          rset: Tuple[int, ...] = SEL_RSET) -> Report:
    """The single-launch contract on the real refresh entry point."""
    from repro_torch.selection import GraftConfig
    from repro_torch.selection import graft as graft_lib

    device = resolve_device(device)
    cfg = GraftConfig(rset=tuple(rset), eps=0.25, use_pallas=True)

    def fused(v, g, gb):
        return graft_lib.pivot_and_sweep(cfg, v, g, gb)

    return launch_audit.audit_step(
        fused, _selection_inputs(K, d, R, device),
        label=f"fused_selection_refresh(K={K}, d={d}, R={R})",
        extra_rules=launch_audit.fused_selection_rules(), device=device)


def check_streaming_selection(device=None, K: int = SEL_K, d: int = SEL_D,
                              R: int = SEL_R, rset: Tuple[int, ...] = SEL_RSET) -> Report:
    """The streaming (sketch-reservoir) refresh reuses the fused launch —
    ONE ``graft_select`` for the whole select — and the reservoir update
    adds no gathers beyond the per-batch GRAFT select (``select_rank``'s
    candidate lookup, shared by both paths)."""
    from repro_torch.selection import (CarrySpec, GraftConfig, SelectionInputs,
                                       get_sampler)

    device = resolve_device(device)
    cfg = GraftConfig(rset=tuple(rset), eps=0.25, use_pallas=True, streaming=True)
    V, G, g_bar = _selection_inputs(K, d, R, device)
    smp = get_sampler("streaming_graft")
    carry = smp.init_carry(cfg, CarrySpec(batch_size=K, grad_dim=d, device=V.device))
    step = torch.zeros((), dtype=torch.int32, device=V.device)

    def streaming(v, g, gb, c):
        return smp.select_fn(cfg, SelectionInputs(v, g, gb), c, step)

    def per_batch(v, g, gb):
        return get_sampler("graft").fn(cfg, SelectionInputs(v, g, gb), step)

    _, base = launch_audit.run_audited(per_batch, (V, G, g_bar))
    gather_budget = base.counts["gather"]
    rules = [
        launch_audit.LaunchRule(
            "graft_select", exact=1, rule="JX003",
            why="the streaming refresh (sketch update + blended-target "
                "select) must stay a single fused kernel launch",
            fix_hint="keep streaming_select_fn on graft.pivot_and_sweep — "
                     "do not add a second launch for the reservoir"),
        launch_audit.LaunchRule(
            "gather", max_count=gather_budget, rule="JX004",
            why=f"the reservoir update must add no gathers over the "
                f"per-batch GRAFT select (budget {gather_budget} from the "
                f"shared rank-decision epilogue)",
            fix_hint="express the FD sketch update with slices/matmuls, "
                     "not fancy indexing"),
    ]
    return launch_audit.audit_step(
        streaming, (V, G, g_bar, carry),
        label=f"streaming_selection_refresh(K={K}, d={d}, R={R})",
        extra_rules=rules, device=device)


def check_sharded_selection(device=None, K: int = SEL_K, d: int = SEL_D,
                            R: int = SEL_R, rset: Tuple[int, ...] = SEL_RSET) -> Report:
    """The sharded engine's GRAFT refresh on this process's rows, over a
    (1, 1) ``("data", "model")`` mesh of the local backend: ONE
    ``graft_select`` per call, no gather beyond the single-batch select's,
    no host sync and no float64 op (``launch_audit.sharded_selection_rules``;
    a fleet's ranks each hold the same contract, ``chip_smoke.py`` phase
    sharded)."""
    from repro_torch.backend import LocalBackend, LocalBackendConfig, make_mesh
    from repro_torch.selection import GraftConfig, engine

    device = resolve_device(device)
    cfg = GraftConfig(rset=tuple(rset), eps=0.25, use_pallas=True)
    mesh = make_mesh((1, 1), ("data", "model"), LocalBackend(LocalBackendConfig()))
    V, G, g_bar = _selection_inputs(K, d, R, device)
    _, base = launch_audit.run_audited(
        lambda v, g, gb: engine.select_batch(cfg, "graft", v, g, gb), (V, G, g_bar))
    return launch_audit.audit_step(
        lambda v, g: engine.select_sharded(cfg, mesh, v, g), (V, G),
        label=f"sharded_selection_refresh(K={K}, d={d}, R={R})",
        extra_rules=launch_audit.sharded_selection_rules(base.counts["gather"]),
        device=device)


def check_sampler_closures() -> Report:
    """SP001: no registered sampler may smuggle cross-step state through a
    closed-over mutable (list/dict/set/bytearray) — rollback and resume
    could never restore it. The Sampler-v2 carry is the only sanctioned
    channel."""
    from repro_torch.selection import available, get_sampler

    mutable = (list, dict, set, bytearray)
    report = Report()
    for name in available():
        smp = get_sampler(name)
        for attr in ("fn", "select_fn", "init_carry_fn"):
            fn = getattr(smp, attr)
            cells = getattr(fn, "__closure__", None) or ()
            for cell in cells:
                try:
                    value = cell.cell_contents
                except ValueError:       # empty cell
                    continue
                if isinstance(value, mutable):
                    report.add(Finding(
                        rule="SP001", location=f"sampler '{name}'.{attr}",
                        message=f"closes over mutable "
                                f"{type(value).__name__}: {value!r:.80}",
                        fix_hint="thread the state through init_carry_fn/"
                                 "select_fn (Sampler-v2 carry) so it rides "
                                 "the train state and checkpoints"))
    if report.ok:
        report.add(Finding(
            rule="SP001", severity="info", location="selection.registry",
            message=f"no mutable closures across "
                    f"{len(available())} registered samplers"))
    return report


def probe_model_config():
    """The JAX package's attention probe model: dense, 2 layers, d 64, 4
    heads over 2 KV heads of 16, float32, flash."""
    from repro_torch.models.model import ModelConfig
    return ModelConfig(
        family="dense", num_layers=ATTN_LAYERS, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        param_dtype="float32", scan_layers=False, attn_backend="flash")


def check_attention(device=None, mcfg=None, batch: int = ATTN_B,
                    seq: int = ATTN_S) -> Report:
    """One flash forward launch per layer in the forward, one dQ and one
    dK/dV per layer in the train step (and the remat recompute's forwards),
    and a sync-free, float64-free train step, on the probe model or
    ``mcfg``."""
    from repro_torch.models import model as model_lib

    mcfg = mcfg or probe_model_config()
    dev = resolve_device(device)
    params = model_lib.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = [p for p in params.parameters() if p.requires_grad]
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, mcfg.vocab_size, (2, batch, seq)).astype(np.int64)
    batch_t = {"tokens": torch.from_numpy(tokens[0]).to(dev),
               "labels": torch.from_numpy(tokens[1]).to(dev)}
    L = mcfg.num_layers
    recomputed = L - mcfg.first_k_dense if mcfg.remat in ("full", "dots") else 0
    label = f"{mcfg.name}(L={L}, d={mcfg.d_model}, B={batch}, S={seq})"

    def fwd(p, b):
        with torch.no_grad():
            return model_lib.loss_fn(mcfg, p, b)[0]

    def step(p, b):
        return torch.autograd.grad(model_lib.loss_fn(mcfg, p, b)[0], leaves)

    step_rules = [launch_audit.LaunchRule(
        name, exact=n, why="one backward kernel per attention layer, one "
                           "forward per layer and per remat recompute")
        for name, n in (("flash_forward", L + recomputed), ("flash_dq", L),
                        ("flash_dkv", L))]
    report = Report()
    for fn, rules, what in ((fwd, launch_audit.attention_rules(L), "flash_forward"),
                            (step, step_rules, "flash_train_step")):
        report.extend(launch_audit.audit_step(
            fn, (params, batch_t), label=f"{what} {label}", extra_rules=rules,
            device=dev))
    return report


# torch.profiler now and then drops the first records of a profile: a few
# of them in most profiles after other profiling in the process, at times
# all of them (tools/profiler_edges.py measures it on the card). A profiled
# section is therefore bracketed by launches of torch.cuda._sleep's spin
# kernel, which no section launches: PRE short ones before it, POST long
# ones after it (told apart by their device time), with EDGE_S seconds of
# host time inside each end of the window. A profile is a measurement of
# the section when the loss stopped inside the pre witnesses (one of them
# seen) and every post witness was seen; else it is taken again, up to
# PROFILES times.
PRE, PRE_CYCLES, POST, POST_CYCLES = 64, 1_000, 8, 200_000
LONG_US, EDGE_S, PROFILES = 20.0, 0.05, 3
WITNESS_KERNEL = "spin_kernel"


def _witnesses(n: int, cycles: int, device) -> None:
    for _ in range(n):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize(device)


def profiled_section(section: Callable[[], Report], device):
    """``(the section's report, its route decisions, the launch counters
    that moved, the profiler's CUDA events by name, (pre, post) witnesses
    seen)`` of one profile of ``section`` between the edges and
    witnesses."""
    from torch.profiler import ProfilerActivity, profile
    out: List[Report] = []
    before = launch_audit.read_counts()
    with launch_audit.recording() as trace, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        _witnesses(PRE, PRE_CYCLES, device)
        out.append(section())
        _witnesses(POST, POST_CYCLES, device)
        time.sleep(EDGE_S)
    counted = {k: v - before[k] for k, v in launch_audit.read_counts().items()}
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
    spins = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == cuda and WITNESS_KERNEL in e.name]
    seen = (sum(us < LONG_US for us in spins), sum(us >= LONG_US for us in spins))
    return out[0], trace, counted, events, seen


def held_to_profiler(section: Callable[[], Report], label: str, device) -> Report:
    """Run ``section``; on a CUDA device also hold every route decision it
    made to the wrappers' launch counters and to torch.profiler's count of
    the port's CUDA kernels by name. A profile whose record loss reached
    past the pre witnesses, or lost a post witness, is taken again with the
    section; one that kept them and disagrees fails at once."""
    if torch.device(device).type != "cuda":
        return section()
    lost = []
    for _ in range(PROFILES):
        report, trace, counted, events, (pre, post) = profiled_section(section, device)
        if pre >= 1 and post == POST:
            break
        lost.append((pre, post))
    routed = {k: trace.counts.get(k, 0) for k in counted}
    if routed != counted:
        report.add(Finding(rule="JX003", location=label,
                           message=f"route decisions {routed}, the wrappers' launch "
                                   f"counters {counted}",
                           fix_hint="a wrapper launches without counting, or counts "
                                    "a launch it did not route"))
    if len(lost) == PROFILES:
        report.add(Finding(rule="JX003", location=label,
                           message=f"torch.profiler lost records in all {PROFILES} profiles "
                                   f"((pre, post) witnesses seen {lost} of {(PRE, POST)}): "
                                   "launches not held to the profiler",
                           fix_hint="profile the section alone"))
        return report
    if lost:
        report.add(Finding(rule="JX003", severity="info", location=label,
                           message=f"torch.profiler lost records in {len(lost)} profile(s) "
                                   f"((pre, post) witnesses seen {lost} of {(PRE, POST)}); "
                                   "profiled again"))
    report.extend(launch_audit.check_profiler(trace.counts, events, label))
    return report


def check_smem() -> Report:
    """The estimator at the probe and production shapes: each kernel on the
    plan its wrapper picks, with headroom notes (VM003), the flash
    feasibility checks, and the JAX package's refusals."""
    report = Report()
    for S, T, dh, dtype in FLASH_REPORT_SHAPES:
        report.extend(smem.flash_attention_report(S, T, dh, dtype))
    for K, R, d, rank in REFRESH_SHAPES:
        plan = smem.choose_plan(K, R, rank)
        basis = smem.choose_basis(K, R, d, rank, plan)
        report.extend(smem.graft_select_smem(K, R, d, rank, plan, basis).report())
        report.extend(smem.fused_select_vmem(K, R, d, rank).report())
    for K, R, rank in ((SEL_K, SEL_R, SEL_R), (1024, 64, 64)):
        report.extend(smem.fast_maxvol_smem(K, R, rank, smem.choose_plan(K, R, rank)).report())
    for R in (8, SEL_R, 64):
        plan = "shared" if smem.projection_sweep_smem(R).fits else "global"
        report.extend(smem.projection_sweep_smem(R, plan).report())
    report.extend(smem.rwkv_report(256, 64))
    return report


def library_sums() -> List[Tuple[str, int, int]]:
    """(configuration, estimator's bytes, library's bytes) for every plan of
    every kernel with a shared-memory plan — flash at every head dim in
    both types, the refresh's plan pairs at the paths' d (minicpm-2b's K 16,
    R 8), MaxVol and the sweep at the engine's and the wide shapes, the RWKV
    backward — the library's ``-1`` (above one block) read as the
    estimate's total when it does not fit. Builds the libraries: card
    only."""
    from repro_torch.kernels import fast_maxvol as fm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import projection_sweep as ps
    from repro_torch.kernels import rwkv_scan as rw

    def lib(est, got):
        return got if got >= 0 or est.fits else est.total

    rows = []
    for dh in range(1, smem.FLASH_MAX_HEAD_DIM + 1):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in smem.FLASH_KINDS:
                est = smem.flash_smem(kind, dh, dtype)
                rows.append((est.kernel, est.total, fa.plan_smem_bytes(kind, dh, dtype)))
    for d in (1536, 1600, 2304, 4096, 5120, 6144):
        for plan in smem.PLANS:
            for basis in smem.PLANS:
                est = smem.graft_select_smem(16, 8, d, 8, plan, basis)
                rows.append((est.kernel, est.total,
                             lib(est, gs.library_smem_bytes(16, 8, d, 8, plan, basis))))
    for K, R, rank in ((16, 8, 8), (SEL_K, SEL_R, SEL_R), (1024, 64, 64), (2048, 256, 256)):
        for plan in smem.PLANS:
            est = smem.fast_maxvol_smem(K, R, rank, plan)
            rows.append((est.kernel, est.total, lib(est, fm.library_smem_bytes(K, R, rank, plan))))
    for R in (8, 16, SEL_R, 64):
        for plan in smem.PLANS:
            est = smem.projection_sweep_smem(R, plan)
            rows.append((est.kernel, est.total, lib(est, ps.library_smem_bytes(R, plan))))
    est = smem.rwkv_backward_smem()
    rows.append((est.kernel, est.total, rw.library_smem_bytes()))
    return rows


def check_smem_library() -> Report:
    """VM001 for every sum of the estimator that differs from the C
    library's; an info note with the count otherwise."""
    report = Report()
    rows = library_sums()
    for kernel, est, got in rows:
        if est != got:
            report.add(Finding(
                rule="VM001", location=kernel,
                message=f"the estimator sums {est} B, the C library {got} B",
                fix_hint="analysis/smem.py and the CUDA source must sum the "
                         "same buffers"))
    if report.ok:
        report.add(Finding(rule="VM003", severity="info", location="smem vs library",
                           message=f"{len(rows)} sums equal to the C library's "
                                   f"({len({k.split('(')[0] for k, _, _ in rows})} kernels)"))
    return report


def probe_overrides(tmpdir: str) -> List[str]:
    """The host-stall probe config (the JAX bench's async-loop gate) with
    the audit knob on — the clean-pass configuration the battery
    certifies."""
    return [
        "train.steps=8", "train.batch=8", "train.seq=16",
        "train.log_every=4", "train.eval_every=4",
        f"train.metrics_path={tmpdir}/metrics.jsonl",
        "train.metrics_flush_every=4",
        f"train.checkpoint_dir={tmpdir}/ckpt", "train.checkpoint_every=4",
        "graft.rset=[2,4]", "graft.refresh_every=3", "graft.overlap=true",
        "train.audit=true",
    ]


def run_probe(overrides: Sequence[str] = (), device=None):
    """One ``Trainer.fit`` on the probe config (``PORT_PROBE`` and
    ``overrides`` after it) on ``device`` (default: the card, and an error
    without one): ``(trainer, run report or None, findings)`` —
    an SY001/RC001 error when the audit stopped the run, JX003 where the
    run's launches differ from its reckoning or a plain version ran on the
    card."""
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.models.layers import resolve_attn_backend

    report = Report()
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        cfg = ExperimentConfig().apply_overrides(
            probe_overrides(td) + list(PORT_PROBE) + list(overrides))
        trainer = Trainer(cfg, device=dev)
        try:
            with launch_audit.recording() as trace:
                run_report = trainer.fit()
        except SyncGuardError as e:
            report.add(Finding(rule="SY001", location="train.audit", message=str(e)))
            return trainer, None, report
        except RuntimeError as e:
            if "[train.audit]" not in str(e):
                raise
            report.add(Finding(rule="RC001", location="train.audit", message=str(e)))
            return trainer, None, report
    mcfg = trainer.mcfg
    flash = resolve_attn_backend(mcfg, cfg.train.seq, cfg.train.seq, dev) == "flash"
    want = launch_audit.expected_launches(
        mcfg, cfg, launch_audit.optim_groups(trainer.state["params"]), flash=flash,
        card=dev.type == "cuda")
    got = {k: trace.counts.get(k, 0) for k in want}
    label = f"runtime probe ({mcfg.name}, L={mcfg.num_layers}, d={mcfg.d_model})"
    if got != want:
        report.add(Finding(rule="JX003", location=label,
                           message=f"launches {got}, reckoned {want}",
                           fix_hint="launch_audit.expected_launches and the step "
                                    "path disagree"))
    report.extend(launch_audit.plain_on_card(trace, dev, label))
    launched = {k: v for k, v in got.items() if v}
    audit = run_report.get("audit")
    if audit is None:
        report.add(Finding(rule="SY001", severity="info", location=label,
                           message=f"run with train.audit off; launches {launched}"))
        return trainer, run_report, report
    sites = ", ".join(f"{k}={v}" for k, v in audit["sync_sites"].items()) or "none"
    report.add(Finding(
        rule="SY001", severity="info", location="train.audit",
        message=f"clean audited run: {audit['sync_events']} sanctioned sync(s) "
                f"[{sites}], {audit['unsanctioned']} unsanctioned, "
                f"{audit['recompiles']} signature drift(s); launches {launched}"))
    return trainer, run_report, report


def check_runtime(overrides: Sequence[str] = (), device=None) -> Report:
    """Run the REAL Trainer under ``train.audit`` on the probe config, on
    ``device`` (default: the card)."""
    return run_probe(overrides, device)[2]


def run_battery(device, *, selections: Sequence[Tuple[int, int, int, Tuple[int, ...]]]
                = ((SEL_K, SEL_D, SEL_R, SEL_RSET),), attn_mcfg=None,
                attn_batch: int = ATTN_B, attn_seq: int = ATTN_S, runtime: bool = True,
                overrides: Sequence[str] = ()) -> Report:
    """Every section on ``device``: the selection contracts at each (K, d,
    R, rset) of ``selections``, the attention contract on ``attn_mcfg``
    (default: the probe model), the runtime probe with ``overrides``. On the
    card each launching section is also held to the profiler, and the
    estimator to the C libraries."""
    dev = torch.device(device)
    report = Report()
    report.extend(check_lint())
    for K, d, R, rset in selections:
        report.extend(held_to_profiler(
            lambda: check_fused_selection(dev, K, d, R, rset), f"fused K={K} d={d}", dev))
        report.extend(held_to_profiler(
            lambda: check_streaming_selection(dev, K, d, R, rset),
            f"streaming K={K} d={d}", dev))
        report.extend(held_to_profiler(
            lambda: check_sharded_selection(dev, K, d, R, rset),
            f"sharded K={K} d={d}", dev))
    report.extend(check_sampler_closures())
    report.extend(held_to_profiler(
        lambda: check_attention(dev, attn_mcfg, attn_batch, attn_seq), "attention", dev))
    report.extend(check_smem())
    if dev.type == "cuda":
        report.extend(check_smem_library())
    if runtime:
        report.extend(held_to_profiler(
            lambda: check_runtime(overrides, dev), "runtime probe", dev))
    return report


def run_all(runtime: bool = True, overrides: Sequence[str] = (), device=None) -> Report:
    """Every section at the JAX probe shapes on ``device`` (default: the
    card, and an error without one)."""
    return run_battery(resolve_device(device), runtime=runtime, overrides=overrides)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static + runtime audit of the training hot-path "
                    "contracts (lint, launches, shared memory, sync/"
                    "signature drift)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    help="emit the report as JSON (to PATH, or stdout "
                         "with no argument)")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--no-runtime", action="store_true",
                    help="skip the audited Trainer probe run")
    ap.add_argument("--quiet", action="store_true",
                    help="hide info-severity findings")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    dest="overrides",
                    help="extra ExperimentConfig override for the runtime "
                         "probe (repeatable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU on purpose)")
    args = ap.parse_args(argv)
    if args.rules:
        print(rule_table())
        return 0
    report = run_all(runtime=not args.no_runtime, overrides=args.overrides,
                     device=args.device)
    if args.json:
        blob = report.to_json(indent=1)
        if args.json == "-":
            print(blob)
        else:
            with open(args.json, "w") as f:
                f.write(blob + "\n")
    print(report.format(show_info=not args.quiet))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
