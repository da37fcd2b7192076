"""The port's launch audit (``repro_torch.analysis.launch_audit``) beside the
JAX package's ``repro.analysis.jaxpr_audit``: ``LaunchRule.check`` against
``PrimitiveRule.check`` on the same count dicts (``pallas_call`` read as
the kernel's name), ``monotone_count_rows`` equal, the contracts' declared
counts, and the contracts on the CPU route, where a route decision in
``kernels/build.py`` is a call of the kernel's plain version (the
counterpart of a ``pallas_call`` in an interpret-mode jaxpr). The JAX
tracing entry points (``count_primitives``, ``audit_dtypes``) fail on jax
0.9 and are not called. Counts are compared exactly; no tolerance is
involved.
"""
import dataclasses
import importlib.util
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from repro.analysis import jaxpr_audit as jaudit
from repro_torch.analysis import launch_audit as la
from repro_torch.analysis import runner
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_optim as fo
from repro_torch.selection import GraftConfig
from repro_torch.selection import graft as graft_lib

SEED = 0


def _problems(message):
    """(count, the violation kinds) of a rule's message."""
    n = int(message.split("×", 1)[0])
    kinds = re.search(r"\(([^()]*expected[^()]*)\)", message).group(1)
    return n, kinds


def _count_cases():
    rng = np.random.default_rng(SEED)
    for _ in range(40):
        bounds = {}
        for key in ("exact", "max_count", "min_count"):
            if rng.random() < 0.5:
                bounds[key] = int(rng.integers(0, 4))
        yield bounds, int(rng.integers(0, 5)), str(rng.choice(["JX003", "JX004"]))


@pytest.mark.parametrize("bounds,n,rule_id", list(_count_cases()))
def test_launch_rule_check_matches_primitive_rule(bounds, n, rule_id):
    """Same bounds, same count: the same rule id, severity and violation
    kinds, with ``pallas_call`` read as the kernel's name."""
    jrule = jaudit.PrimitiveRule("pallas_call", rule=rule_id, why="w", fix_hint="f", **bounds)
    trule = la.LaunchRule("graft_select", rule=rule_id, why="w", fix_hint="f", **bounds)
    want = jrule.check({"pallas_call": n}, "lbl")
    got = trule.check({"graft_select": n}, "lbl")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rule, g.severity, g.location, g.fix_hint) == \
            (w.rule, w.severity, w.location, w.fix_hint)
        assert _problems(g.message) == _problems(w.message)
        assert g.message.endswith(" — w") and w.message.endswith(" — w")


def test_monotone_count_rows_equal_jax():
    rng = np.random.default_rng(SEED)
    keys = ["graft_select", "flash_forward", "gather", "absent"]
    for _ in range(10):
        base = {k: int(rng.integers(0, 4)) for k in keys[:3]}
        cur = {k: int(rng.integers(0, 4)) for k in keys[1:]}
        assert la.monotone_count_rows("p", base, cur, keys, "why") == \
            jaudit.monotone_count_rows("p", base, cur, keys, "why")


def _bounds(rule):
    return (rule.exact, rule.max_count, rule.min_count, rule.rule)


def test_contracts_declare_the_jax_counts():
    """One launch and no gather for the fused refresh; one forward launch
    per attention layer."""
    t, j = la.fused_selection_rules(), jaudit.fused_selection_rules()
    assert [r.kernel for r in t] == ["graft_select", "gather"]
    assert [r.primitive for r in j] == ["pallas_call", "gather"]
    assert [_bounds(r) for r in t] == [_bounds(r) for r in j] == \
        [(1, None, None, "JX003"), (None, 0, None, "JX004")]
    for L in (1, 2, 5, 40):
        (tr,), (jr,) = la.attention_rules(L), jaudit.attention_rules(L)
        assert tr.kernel == "flash_forward" and _bounds(tr) == _bounds(jr) == \
            (L, None, None, "JX003")


def _refresh(use_pallas=True, K=64, d=128, R=16):
    cfg = GraftConfig(rset=(4, 8, 16), eps=0.25, use_pallas=use_pallas)
    return (lambda v, g, gb: graft_lib.pivot_and_sweep(cfg, v, g, gb),
            runner._selection_inputs(K, d, R, "cpu"))


def test_fused_refresh_is_one_launch_and_no_gather_on_the_cpu_route():
    fn, args = _refresh()
    _, audit = la.run_audited(fn, args)
    assert audit.counts == {"graft_select": 1, "gather": 0}
    assert audit.trace.plain == {"graft_select": 1}
    assert la.count_launches(fn, *args) == {"graft_select": 1}
    assert runner.check_fused_selection("cpu", 64, 128, 16, (4, 8, 16)).ok


def test_unfused_chain_breaks_the_fused_contract():
    """use_pallas=False: no refresh launch (JX003) and the G gather around
    it (JX004); MaxVol's float64 product stays info under its site."""
    fn, args = _refresh(use_pallas=False)
    report = la.audit_step(fn, args, label="unfused",
                           extra_rules=la.fused_selection_rules())
    assert sorted(f.rule for f in report.errors) == ["JX003", "JX004"]
    wide = report.by_rule("JX002")
    assert wide and all(f.severity == "info" for f in wide)
    assert all("maxvol_exact_product" in f.message for f in wide)


def test_stray_index_select_on_the_fused_path_is_jx004():
    fn, args = _refresh()

    def gathered(v, g, gb):
        out = fn(v, g, gb)
        g.index_select(1, out[0][:2].long())
        return out

    report = la.audit_step(gathered, args, extra_rules=la.fused_selection_rules())
    assert [f.rule for f in report.errors] == ["JX004"]


def test_streaming_refresh_is_one_launch_within_the_gather_budget():
    report = runner.check_streaming_selection("cpu", 64, 128, 16, (4, 8, 16))
    assert report.ok, report.format()
    # fd_update's float64 eigendecomposition: info, named by its site
    assert {f.severity for f in report.by_rule("JX002")} == {"info"}
    assert any("fd_update_eigh" in f.message for f in report.by_rule("JX002"))


def test_item_in_a_step_is_jx001():
    x = torch.ones(3)

    def step(t):
        return (t * 2).sum().item()

    report = la.audit_step(step, (x,), label="fixture")
    assert [f.rule for f in report.errors] == ["JX001"]
    assert "item" in report.errors[0].message
    # a named site passes, and shows up as info
    from repro_torch.analysis.sync_guard import sync_allowed

    def drained(t):
        with sync_allowed("flush"):
            return (t * 2).sum().item()

    assert la.audit_step(drained, (x,), sync_sites=("flush",)).ok
    assert not la.audit_step(drained, (x,)).ok         # a site the caller did not name


def test_float64_constant_is_jx002_and_wide_allowed_makes_it_info():
    x = torch.ones(4)

    def step(t):
        return t * torch.tensor(2.0, dtype=torch.float64)

    report = la.audit_step(step, (x,), label="fixture")
    assert [f.rule for f in report.errors] == ["JX002"]
    assert "float64" in report.errors[0].message

    def allowed(t):
        with la.wide_allowed("fixture_site"):
            return step(t)

    report = la.audit_step(allowed, (x,), label="fixture")
    assert report.ok and report.by_rule("JX002")
    assert all("fixture_site" in f.message for f in report.by_rule("JX002"))
    assert not la.audit_step(step, (x,), check_dtypes=False).by_rule("JX002")


def test_probe_model_launches_one_flash_kernel_per_layer_and_pass():
    """The 2-layer probe model: L flash forwards in the forward; in its
    train step L dQ, L dK/dV and L + L (remat recompute) forwards."""
    report = runner.check_attention("cpu")
    assert report.ok, report.format()
    mcfg = runner.probe_model_config()
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(mcfg, torch.Generator().manual_seed(SEED))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, 256, (2, 2, 16)))
    batch = {"tokens": tokens[0], "labels": tokens[1]}
    leaves = list(params.parameters())
    counts = la.count_launches(
        lambda: torch.autograd.grad(model_lib.loss_fn(mcfg, params, batch)[0], leaves))
    L = mcfg.num_layers
    assert counts == {"flash_forward": 2 * L, "flash_dq": L, "flash_dkv": L}
    assert runner.check_attention("cpu", mcfg=dataclasses.replace(mcfg, num_layers=3)).ok
    with la.recording() as trace:
        model_lib.loss_fn(mcfg, params, batch)
    assert [f.rule for f in la.attention_rules(L + 1)[0].check(trace.counts, "x")] == ["JX003"]


def test_recordings_nest():
    """A section audited inside another (the profiler check around a step
    audit): both count every decision, and each leaves on its own exit."""
    fn, args = _refresh()
    with la.recording() as outer:
        with la.recording() as inner:
            fn(*args)
        fn(*args)
    assert inner.counts == {"graft_select": 1} and outer.counts == {"graft_select": 2}
    from repro_torch.kernels import build
    assert build.AUDITS == []


def test_flash_wrappers_route_under_their_kernel_names():
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    with la.recording() as trace:
        fa.flash_attention(q, k, v).sum().backward()
    assert trace.counts == {"flash_forward": 1, "flash_dq": 1, "flash_dkv": 1}
    assert trace.plain == trace.counts


def test_optimizer_update_routes_once_per_dtype_group():
    """Kernel B launches once per (param dtype, state dtype) group; the CPU
    route calls the plain version once per group too, with the same
    result as one call over all leaves."""
    rng = np.random.default_rng(SEED)
    shapes = [(3, 4), (5,), (2, 2), (0,)]
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.float32]

    def leaves():
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dt)
                for s, dt in zip(shapes, dtypes)]

    params, grads = leaves(), leaves()
    m = [torch.zeros(s) for s in shapes]
    v = [torch.zeros(s) for s in shapes]
    hp = fo.Hyper(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.1,
                  momentum=0.0, bc1=0.1, bc2=0.001)
    want = [p.clone() for p in params]
    fo.update_reference("adamw", want, grads, [x.clone() for x in m],
                        [x.clone() for x in v], hp)
    with la.recording() as trace:
        fo.optimizer_update("adamw", params, grads, m, v, hp)
    assert trace.counts == {"optimizer_update": 2}
    assert la.optim_groups(params[:3]) == 2
    assert all(torch.equal(a, b) for a, b in zip(params, want))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_registry_counters_and_chip_smoke_share_one_reckoning():
    chip_smoke = _chip_smoke()
    counters = la.kernel_counters()
    assert [c[0] for c in counters] == list(la.KERNEL_NAMES)
    assert all(isinstance(getattr(h, a), int) for _, h, a in counters)
    assert chip_smoke._read_counts() == la.read_counts()
    assert sorted(n for names in la.PROFILER_KERNELS.values() for n in names) == \
        sorted(la.KERNEL_NAMES)
    cfg = types.SimpleNamespace(train=types.SimpleNamespace(steps=6, eval_every=2),
                                graft=types.SimpleNamespace(refresh_every=2))
    mcfg = types.SimpleNamespace(num_layers=3, first_k_dense=0, remat="full", family="dense")
    want = la.expected_launches(mcfg, cfg, 2)
    assert chip_smoke._expected_launches(mcfg, cfg, 2) == want
    # 3 refreshes; 3 · (6 + 3 + 4·3) + 3 · 6 forwards; 18 backwards
    assert (want["graft_select"], want["flash_forward"], want["flash_dq"],
            want["grad_norm"], want["optimizer_update"]) == (3, 81, 18, 6, 12)
    assert la.dispatched_launches(mcfg, [0, 1, 2, 3, 2, 3], 2, True) == \
        {"graft_select": 3, "flash_forward": 3 * 9 + 18, "flash_dq": 18, "flash_dkv": 18}


class _Event:
    def __init__(self, key, count):
        self.key, self.count = key, count


def test_profiler_counts_are_held_to_the_audit():
    events = [_Event("void (anonymous namespace)::graft_select_kernel(float const*)", 3),
              _Event("void flash_fwd_mma_kernel<64>(...)", 4),
              _Event("void flash_dq_mma_kernel<64>(...)", 2),
              _Event("ampere_sgemm_128x64", 9)]
    counts = {"graft_select": 2, "graft_select_batched": 1, "flash_forward": 4, "flash_dq": 2}
    report = la.check_profiler(counts, events, "fixture")
    assert report.ok and "graft_select_kernel=3" in report.findings[0].message
    report = la.check_profiler(dict(counts, flash_dq=1), events, "fixture")
    assert [f.rule for f in report.errors] == ["JX003"] and "flash_dq" in report.errors[0].message


def test_a_plain_version_on_the_card_is_an_error():
    trace = la.LaunchTrace()
    trace("graft_select", True)
    trace("flash_forward", False)
    assert la.plain_on_card(trace, "cpu", "x").ok
    report = la.plain_on_card(trace, torch.device("cuda"), "x")
    assert [f.rule for f in report.errors] == ["JX003"]
    assert "flash_forward" in report.errors[0].message
