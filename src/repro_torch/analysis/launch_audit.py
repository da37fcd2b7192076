"""Kernel-launch accounting and step audits over one eager call — the twin
of the JAX package's ``analysis/jaxpr_audit.py``.

The port has no jaxpr to walk, so each JAX check becomes its eager
equivalent over one call of the function:

  * **launches** (JX003): every kernel wrapper decides its route in
    ``kernels/build.py`` ``route``, once per launch; :func:`count_launches`
    counts those decisions by kernel name. On CUDA tensors a decision is a
    launch (equal to the wrappers' ``launches`` counters and to a
    ``torch.profiler`` count of the CUDA kernels by name); on CPU tensors it
    is a call of the kernel's plain version, the counterpart of a
    ``pallas_call`` in an interpret-mode jaxpr, so the contracts hold here
    too;
  * **host syncs** (JX001): the call runs under a
    :class:`~repro_torch.analysis.sync_guard.SyncGuard` that sanctions only
    the sites the caller names;
  * **wide dtypes** (JX002) and **gathers** (JX004): a ``TorchDispatchMode``
    records every aten op whose output is float64 or complex128, and every
    gather-class op (``gather``, ``index_select``, ``index.Tensor``,
    ``take``, ``embedding``). Ops that run inside a kernel wrapper
    (``kernels/``: a plain version on the CPU, an allocation on the card)
    are the kernel's, as a ``pallas_call`` body is in JAX. A deliberate
    float64 site marks itself with :func:`wide_allowed`, as a drain point
    marks itself with ``sync_allowed``: its ops come out as info findings
    that name the site, never silently dropped.

The same registry and reckoning serve the audit and ``chip_smoke.py``:
:func:`kernel_counters` (every wrapper's launch counter),
:func:`expected_launches` and :func:`dispatched_launches` (what a training
run reckons), :func:`expected_sharded_launches` (what each rank of a
sharded selection reckons), and :func:`monotone_count_rows` (the JAX
regression gate's row format).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, \
    Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding, Report
from repro_torch.analysis.sync_guard import SyncGuard
from repro_torch.kernels import build

_WIDE_DTYPES = (torch.float64, torch.complex128)
# aten overload packets that read rows by index: the port's gathers
GATHER_OPS = ("gather", "index_select", "index", "take", "embedding")

# kernel name → (module under repro_torch.kernels, wrapper, counter attribute)
KERNELS = (
    ("graft_select", "graft_select", "graft_select", "launches"),
    ("flash_forward", "flash_attention", "flash_attention", "forward_launches"),
    ("flash_dq", "flash_attention", "flash_attention", "dq_launches"),
    ("flash_dkv", "flash_attention", "flash_attention", "dkv_launches"),
    ("graft_select_batched", "graft_select", "graft_select_batched", "launches"),
    ("fast_maxvol", "fast_maxvol", "fast_maxvol", "launches"),
    ("projection_sweep", "projection_sweep", "projection_sweep", "launches"),
    ("rwkv_scan", "rwkv_scan", "rwkv_scan", "launches"),
    ("rwkv_scan_backward", "rwkv_scan", "rwkv_scan_backward", "launches"),
    ("grad_norm", "fused_optim", "grad_norm", "launches"),
    ("optimizer_update", "fused_optim", "optimizer_update", "launches"),
)
KERNEL_NAMES = tuple(k[0] for k in KERNELS)

# a substring of each CUDA kernel's name → the launch counts it sums (the
# batched refresh is the same CUDA kernel on a grid of B blocks; grad_norm
# launches fused_norm_kernel and then norm_finish_kernel)
PROFILER_KERNELS = {
    "graft_select_kernel": ("graft_select", "graft_select_batched"),
    "flash_fwd": ("flash_forward",),
    "flash_dq": ("flash_dq",),
    "flash_dkv": ("flash_dkv",),
    "fast_maxvol_kernel": ("fast_maxvol",),
    "projection_sweep_kernel": ("projection_sweep",),
    "rwkv_fwd_kernel": ("rwkv_scan",),
    "rwkv_bwd_kernel": ("rwkv_scan_backward",),
    "fused_norm_kernel": ("grad_norm",),
    "fused_update_kernel": ("optimizer_update",),
}


# ---------------------------------------------------------------------------
# the wrappers' launch counters
# ---------------------------------------------------------------------------

def kernel_counters() -> List[Tuple[str, Any, str]]:
    """(name, holder, attribute) of every kernel's launch counter."""
    import importlib
    out = []
    for name, module, holder, attr in KERNELS:
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        out.append((name, getattr(mod, holder), attr))
    return out


def zero_counts() -> None:
    for _, holder, attr in kernel_counters():
        setattr(holder, attr, 0)


def read_counts() -> Dict[str, int]:
    return {name: getattr(holder, attr) for name, holder, attr in kernel_counters()}


# ---------------------------------------------------------------------------
# the reckoning of a training run
# ---------------------------------------------------------------------------

def optim_groups(params) -> int:
    """Kernel B's launches a step: one per (param dtype, state dtype) group
    (the moments follow the params' grouping)."""
    return len({p.dtype for p in params})


def expected_launches(mcfg, cfg, groups: int, flash: bool = True,
                      card: bool = True, sharded: bool = False,
                      optimizer: str = "adamw") -> Dict[str, int]:
    """Launches a run of ``cfg.train.steps`` healthy steps reckons: per step
    one forward per layer for the subset loss and, for the stacked layers,
    one more for their remat recompute (full or dots: a kernel is no matrix
    product that dots keeps; the ``first_k_dense`` blocks are never
    recomputed, as in JAX), and one backward; per refresh one selection
    forward per layer and one graft_select. The forward and backward kernels
    are flash (forward; dQ and dK/dV) for the dense family, the RWKV scan
    (forward; one backward launch) for the ssm family. The training path
    runs no batched refresh and no standalone stage. The optimizer step is
    one grad_norm launch a step and one optimizer_update launch per dtype
    group. Each held-out eval (every ``train.eval_every`` steps) runs one
    forward a layer for each of its 4 batches. ``flash=False``: the
    attention resolves to dense (no flash tile divides the sequence), so no
    flash kernel runs. ``card=False``: on the CPU the optimizer clips with
    plain ops and routes no grad_norm.

    The reckoning holds for each rank of a data-parallel fleet and of a
    sharded one (the fsdp preset, ``launch/steps.py``) alike: a rank runs
    every layer's kernels on its own rows (the weights gathered around
    them launch no kernel of the port), one graft_select a refresh on the
    gathered batch, kernel A once a step (split into its pass and its
    finish around the psum of the ranks' sums: one launch) and kernel B
    once per dtype group on its shards. ``sharded``: the global norm routes
    through kernel A's wrapper on the CPU too (its plain split version),
    once a step. With no ``cfg.graft`` (the baseline step) no refresh runs.
    ``optimizer`` "adafactor": the update is plain PyTorch (no kernel B).

    Under JAX's ``default`` preset (``sharded``; every family) the
    counts are the same a rank (a MoE layer's experts and the SSM heads run
    on aten ops): each rank runs one flash forward, dQ and
    dK/dV a layer and pass on its slice of the queries against the whole
    K/V (the query offset), or one RWKV scan forward and backward a layer
    and pass on its heads' B·H/n streams of the gathered sequence, the MLP
    (the channel mix's) and vocabulary slices on aten ops, and the one
    graft_select a refresh on the gathered batch. ``flash`` is the route
    of the whole sequence."""
    steps = cfg.train.steps
    refreshes = (0 if cfg.graft is None else
                 sum(1 for s in range(steps) if s % cfg.graft.refresh_every == 0))
    evals = steps // cfg.train.eval_every if cfg.train.eval_every else 0
    L = mcfg.num_layers
    recomputed = L - mcfg.first_k_dense if mcfg.remat in ("full", "dots") else 0
    fwd = L * (steps + refreshes + 4 * evals) + recomputed * steps
    bwd = L * steps
    ssm = mcfg.family == "ssm"
    attn = flash and not ssm
    return {"graft_select": refreshes, "flash_forward": fwd if attn else 0,
            "flash_dq": bwd if attn else 0, "flash_dkv": bwd if attn else 0,
            "graft_select_batched": 0, "fast_maxvol": 0, "projection_sweep": 0,
            "rwkv_scan": fwd if ssm else 0, "rwkv_scan_backward": bwd if ssm else 0,
            "grad_norm": steps if card or sharded else 0,
            "optimizer_update": 0 if optimizer == "adafactor" else steps * groups}


def dispatched_launches(mcfg, steps: Sequence[int], refresh_every: int,
                        flash: bool) -> Dict[str, int]:
    """Launches that the dispatched ``steps`` reckon (one JSONL row per
    dispatched step, replays included): one graft_select a refresh step;
    per layer one flash forward a step, one a refresh and one recompute a
    step under remat, and one dQ and one dK/dV a step."""
    n = len(steps)
    refreshes = sum(1 for s in steps if s % refresh_every == 0)
    L = mcfg.num_layers
    recomputed = L - mcfg.first_k_dense if mcfg.remat in ("full", "dots") else 0
    fwd, bwd = L * (n + refreshes) + recomputed * n, L * n
    names = ("flash_forward", "flash_dq", "flash_dkv")
    return {"graft_select": refreshes,
            **dict(zip(names, (fwd, bwd, bwd) if flash else (0, 0, 0)))}


# ---------------------------------------------------------------------------
# counting route decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)      # recordings nest: each is removed by identity
class LaunchTrace:
    """Route decisions of one call by kernel name: ``counts`` all of them
    (kernel launches on CUDA tensors, plain-version calls on CPU tensors),
    ``plain`` the plain-version calls alone."""
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    plain: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __call__(self, name: str, on_kernel: bool) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1
        if not on_kernel:
            self.plain[name] = self.plain.get(name, 0) + 1


@contextlib.contextmanager
def recording() -> Iterator[LaunchTrace]:
    """Count every route decision made while the block runs, in any thread."""
    trace = LaunchTrace()
    build.AUDITS.append(trace)
    try:
        yield trace
    finally:
        build.AUDITS.remove(trace)


def count_launches(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Kernel name → route decisions in one call of ``fn`` — launches per
    call on the card."""
    with recording() as trace:
        fn(*args, **kwargs)
    return dict(trace.counts)


def cuda_kernel_events(fn: Callable) -> Tuple[list, float]:
    """The CUDA kernels of one call of ``fn`` by torch.profiler (its
    key_averages events on the device) and the call's wall ms, ending in a
    synchronize."""
    import time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA], wall_ms


def profiler_counts(events) -> Dict[str, int]:
    """Launches of the port's CUDA kernels among profiler ``events``, keyed
    by the substrings of ``PROFILER_KERNELS``."""
    out = {key: 0 for key in PROFILER_KERNELS}
    for e in events:
        for key in PROFILER_KERNELS:
            if key in e.key:
                out[key] += e.count
    return out


def check_profiler(counts: Mapping[str, int], events, label: str) -> Report:
    """JX003 where the audited launches of a CUDA kernel differ from the
    profiler's count of it; an info line with both otherwise."""
    rep = Report()
    seen = profiler_counts(events)
    agreed = []
    for key, names in PROFILER_KERNELS.items():
        want = sum(counts.get(n, 0) for n in names)
        if seen[key] != want:
            rep.add(Finding(
                rule="JX003", location=label,
                message=f"the profiler saw {seen[key]}× '{key}', the audit counted "
                        f"{want} ({' + '.join(names)})",
                fix_hint="a wrapper launches without routing (kernels/build.py "
                         "route) or routes without launching"))
        elif want:
            agreed.append(f"{key}={want}")
    if rep.ok:
        rep.add(Finding(rule="JX003", severity="info", location=label,
                        message="profiler counts equal the audit's: "
                                + (", ".join(agreed) or "no kernel launched")))
    return rep


def plain_on_card(trace: LaunchTrace, device, label: str) -> Report:
    """JX003 for every plain-version call on a CUDA device: on the card a
    kernel is meant to run there."""
    rep = Report()
    if torch.device(device).type != "cuda":
        return rep
    for name, n in sorted(trace.plain.items()):
        rep.add(Finding(
            rule="JX003", location=label,
            message=f"{n}× the plain version of '{name}' ran on the card",
            fix_hint="every operand of the wrapper must be a CUDA tensor"))
    return rep


# ---------------------------------------------------------------------------
# declarative rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchRule:
    """Bound on one kernel's launches (or on the gathers, ``"gather"``) in
    one call. ``exact``/``max_count``/``min_count`` — any subset; unset
    bounds are not checked. ``rule`` is the report rule id the violation
    carries."""
    kernel: str
    exact: Optional[int] = None
    max_count: Optional[int] = None
    min_count: Optional[int] = None
    rule: str = "JX003"
    why: str = ""
    fix_hint: str = ""

    def check(self, counts: Mapping[str, int], label: str) -> List[Finding]:
        n = counts.get(self.kernel, 0)
        problems = []
        if self.exact is not None and n != self.exact:
            problems.append(f"expected exactly {self.exact}")
        if self.max_count is not None and n > self.max_count:
            problems.append(f"expected at most {self.max_count}")
        if self.min_count is not None and n < self.min_count:
            problems.append(f"expected at least {self.min_count}")
        if not problems:
            return []
        why = f" — {self.why}" if self.why else ""
        return [Finding(
            rule=self.rule, location=label,
            message=f"{n}× '{self.kernel}' in one call "
                    f"({'; '.join(problems)}){why}",
            fix_hint=self.fix_hint)]


def fused_selection_rules() -> List[LaunchRule]:
    """The single-launch contract of a refresh: ONE ``graft_select``, NO
    gather."""
    return [
        LaunchRule(
            "graft_select", exact=1, rule="JX003",
            why="the fused selection refresh must be a single kernel launch",
            fix_hint="route through kernels/graft_select.py "
                     "(GraftConfig.use_pallas) instead of the unfused chain"),
        LaunchRule(
            "gather", max_count=0, rule="JX004",
            why="the fused path gathers pivot columns inside the kernel; a "
                "gather around it means a round trip through memory crept "
                "back in",
            fix_hint="keep the G-gather inside the fused kernel "
                     "(no index_select on the fused path)"),
    ]


# the samplers whose refresh runs through graft.pivot_and_sweep (graft_select
# under use_pallas)
REFRESH_SAMPLERS = ("graft", "streaming_graft")


def sharded_selection_rules(gather_budget: int) -> List[LaunchRule]:
    """The contract of a sharded GRAFT refresh, per rank and call
    (``selection/engine.py`` ``make_sharded_selector``): ONE
    ``graft_select`` on the rank's rows, and no gather beyond the
    single-batch select's ``gather_budget`` (the rank decision's candidate
    lookup). The collectives launch no kernel of the port."""
    return [
        LaunchRule(
            "graft_select", exact=1, rule="JX003",
            why="each rank's shard of a sharded GRAFT refresh must be a single "
                "kernel launch",
            fix_hint="keep the shard on graft.pivot_and_sweep under "
                     "GraftConfig.use_pallas"),
        LaunchRule(
            "gather", max_count=gather_budget, rule="JX004",
            why=f"the sharded refresh must add no gathers over the single-batch "
                f"select (budget {gather_budget})",
            fix_hint="offset the pivots and gather the state with collectives, "
                     "not fancy indexing"),
    ]


def expected_sharded_launches(gcfg, sampler: str, calls: int = 1) -> Dict[str, int]:
    """Launches on each rank of ``calls`` sharded selections with
    ``sampler``: one ``graft_select`` a call where the sampler refreshes
    through the kernel (``REFRESH_SAMPLERS`` under ``use_pallas``), none of
    any other kernel."""
    n = calls if gcfg.use_pallas and sampler in REFRESH_SAMPLERS else 0
    return {name: n if name == "graft_select" else 0 for name in KERNEL_NAMES}


def attention_rules(layers: int) -> List[LaunchRule]:
    """One flash forward launch per attention layer."""
    return [LaunchRule(
        "flash_forward", exact=layers, rule="JX003",
        why=f"flash attention must launch exactly one forward kernel per "
            f"layer ({layers} layers)",
        fix_hint="check resolve_attn_backend routing (models/layers.py)")]


# ---------------------------------------------------------------------------
# op audit: wide dtypes and gathers
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def wide_allowed(site: str):
    """Mark the enclosed block as a deliberate float64 site named ``site``:
    the op audit reports its wide ops as info under that name. Cheap when no
    audit runs; safe to leave in production code."""
    stack = getattr(_tls, "wide", None)
    if stack is None:
        stack = _tls.wide = []
    stack.append(site)
    try:
        yield
    finally:
        stack.pop()


def _wide_site() -> Optional[str]:
    stack = getattr(_tls, "wide", None)
    return stack[-1] if stack else None


_SKIP_FRAMES = ("/torch/", "launch_audit")


def _caller() -> Tuple[str, bool]:
    """(the op's user call site, whether it runs inside a kernel wrapper)."""
    f = sys._getframe(2)
    where = None
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/kernels/" in fn:
            return where or fn.rsplit("/", 1)[-1], True
        if where is None and not any(s in fn for s in _SKIP_FRAMES):
            where = f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return where or "<torch>", False


class OpAudit(TorchDispatchMode):
    """Records, outside the kernel wrappers, the aten ops whose outputs are
    float64/complex128 (with the ``wide_allowed`` site they ran in) and the
    gather-class ops."""

    def __init__(self):
        super().__init__()
        # (op, dtype, site) → [count, first call site]
        self.wide: Dict[Tuple[str, str, Optional[str]], List] = {}
        self.gathers: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = out if isinstance(out, (tuple, list)) else (out,)
        wide = [str(t.dtype).removeprefix("torch.") for t in outs
                if isinstance(t, torch.Tensor) and t.dtype in _WIDE_DTYPES]
        if wide or name in GATHER_OPS:
            where, in_kernel = _caller()
            if not in_kernel:
                if name in GATHER_OPS:
                    self.gathers[name] = self.gathers.get(name, 0) + 1
                for dtype in dict.fromkeys(wide):
                    key = (name, dtype, _wide_site())
                    entry = self.wide.setdefault(key, [0, where])
                    entry[0] += 1
        return out

    @property
    def gather_count(self) -> int:
        return sum(self.gathers.values())

    def dtype_report(self, label: str) -> Report:
        """JX002 per (op, dtype) outside every ``wide_allowed`` site, an info
        note per sanctioned (op, dtype, site), and info totals."""
        rep = Report()
        for (op, dtype, site), (n, where) in self.wide.items():
            if site is None:
                rep.add(Finding(
                    rule="JX002", location=f"{label} @ {where}",
                    message=f"'{op}' produces {dtype} inside a step function",
                    fix_hint="cast to float32 (or audit for a stray float64 "
                             "constant / np scalar), or mark a deliberate site "
                             "with wide_allowed(\"<site>\")"))
                if n > 1:
                    rep.add(Finding(
                        rule="JX002", severity="info", location=label,
                        message=f"'{op}' → {dtype} occurs {n}× in total"))
            else:
                rep.add(Finding(
                    rule="JX002", severity="info", location=f"{label} @ {where}",
                    message=f"'{op}' → {dtype} {n}× inside wide_allowed('{site}')"))
        return rep


# ---------------------------------------------------------------------------
# audits
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepAudit:
    """Everything one audited call saw."""
    trace: LaunchTrace
    ops: OpAudit
    guard: SyncGuard

    @property
    def counts(self) -> Dict[str, int]:
        """Launches by kernel name, and the gathers under ``"gather"`` (as
        JAX's primitive counts hold ``pallas_call`` and ``gather``)."""
        return {**self.trace.counts, "gather": self.ops.gather_count}


def run_audited(fn: Callable, args: Sequence[Any],
                sync_sites: Sequence[str] = ()) -> Tuple[Any, StepAudit]:
    """Call ``fn(*args)`` once while counting route decisions, recording
    wide and gather ops, and recording host syncs (a sync in a
    ``sync_allowed`` site not in ``sync_sites`` counts as unsanctioned)."""
    guard = SyncGuard(strict=False, label="audit_step")
    with recording() as trace, OpAudit() as ops, guard:
        out = fn(*args)
    allowed = set(sync_sites)
    guard.events = [dataclasses.replace(e, site=e.site if e.site in allowed else None)
                    for e in guard.events]
    return out, StepAudit(trace=trace, ops=ops, guard=guard)


def sync_report(guard: SyncGuard, label: str) -> Report:
    """JX001 per distinct unsanctioned sync (kind, call site), an info note
    on the sanctioned ones."""
    rep = Report()
    seen: Dict[Tuple[str, str], int] = {}
    for e in guard.violations:
        seen[(e.kind, e.where)] = seen.get((e.kind, e.where), 0) + 1
    for (kind, where), n in seen.items():
        rep.add(Finding(
            rule="JX001", location=f"{label} @ {where}",
            message=f"host sync via {kind}" + (f" ({n}×)" if n > 1 else "")
                    + " inside a step function",
            fix_hint="move the read to a flush boundary (drain it under "
                     "sync_allowed(...) there)"))
    sanctioned = [e for e in guard.events if e.sanctioned]
    if sanctioned:
        rep.add(Finding(rule="JX001", severity="info", location=label,
                        message=f"{len(sanctioned)} sync(s) at the named sites "
                                f"{sorted({e.site for e in sanctioned})}"))
    return rep


def audit_step(fn: Callable, args: Sequence[Any], *, label: str = "step",
               extra_rules: Sequence[LaunchRule] = (), check_dtypes: bool = True,
               sync_sites: Sequence[str] = (), device=None) -> Report:
    """The standard train/selection-step audit over one call: no host sync
    outside ``sync_sites`` (JX001), no float64 op (JX002), the caller's
    count rules (JX003/JX004), and on a CUDA ``device`` no plain version
    where a kernel is meant to run."""
    _, audit = run_audited(fn, args, sync_sites)
    report = sync_report(audit.guard, label)
    for rule in extra_rules:
        report.extend(rule.check(audit.counts, label))
    if check_dtypes:
        report.extend(audit.ops.dtype_report(label))
    if device is not None:
        report.extend(plain_on_card(audit.trace, device, label))
    return report


# ---------------------------------------------------------------------------
# regression-gate helper (the JAX package's row format)
# ---------------------------------------------------------------------------

def monotone_count_rows(prefix: str, baseline: Mapping[str, Any],
                        current: Mapping[str, Any],
                        keys: Sequence[str], why: str,
                        ) -> Tuple[List[Tuple[str, float, float, bool]],
                                   List[str]]:
    """Diff integer counters that must never INCREASE (launch counts).
    Returns ``(rows, problems)``: rows ``(metric, baseline, current,
    regressed)``."""
    rows: List[Tuple[str, float, float, bool]] = []
    problems: List[str] = []
    for k in keys:
        b = float(baseline.get(k, 0))
        c = float(current.get(k, 0))
        bad = c > b
        rows.append((f"{prefix}.{k}", b, c, bad))
        if bad:
            problems.append(f"{prefix}.{k}: {why} "
                            f"(baseline {int(b)}, current {int(c)})")
    return rows, problems
