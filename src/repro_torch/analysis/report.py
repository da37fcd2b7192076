"""One report format for every checker: rule id, severity, location,
message, fix hint — the port of the JAX package's ``analysis/report.py``,
with its rule registry and its JSON, so that a report reads the same from
either package.

Rule ids are stable strings, the JAX package's (``JX*`` step audits:
launch counts, syncs, wide dtypes, gathers; ``SY*`` sync, ``RC*`` signature
drift, ``VM*`` shared memory, ``LN*`` lint, ``SP*`` samplers) so CI logs,
tests, and whitelists can reference a rule without parsing prose.
``RULES`` is the registry the CLI prints as the rule table.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning", "info")

# rule id → (default severity, one-line description). The ids and
# severities are the JAX package's; the descriptions name the port's checks.
RULES: Dict[str, tuple] = {
    "JX001": ("error", "host sync (.item/.tolist/.cpu/float/synchronize) "
                       "inside one audited step call, outside the named "
                       "sites"),
    "JX002": ("error", "float64/complex128 aten op inside a step call "
                       "outside a wide_allowed site (silent 2× bandwidth, "
                       "off the tensor cores)"),
    "JX003": ("error", "kernel launches (route decisions in kernels/build.py) "
                       "differ from the launch-count contract, from the "
                       "profiler's count, or a plain version ran on the card"),
    "JX004": ("error", "stray gather-class aten op (gather, index_select, "
                       "index, take, embedding) on the fused selection path"),
    "SY001": ("error", "host↔device sync outside a sanctioned site"),
    "RC001": ("error", "step signature drifted between steps "
                       "(shape/dtype/static arg)"),
    "VM001": ("error", "a kernel plan's shared memory exceeds one Hopper "
                       "block (227 KB), no plan serves the shape, or the "
                       "estimator disagrees with the C library's sum"),
    "VM002": ("error", "block size does not divide the array extent (the "
                       "flash block ladder, T % chunk of the RWKV scan)"),
    "VM003": ("info", "shared-memory headroom of a kernel configuration"),
    "LN001": ("error", "float()/.item()/.tolist()/.cpu()/.numpy()/np.asarray/"
                       "synchronize() in a hot-path module outside a "
                       "whitelisted site"),
    "LN002": ("error", "wall clock (time.time/perf_counter) where the "
                       "dispatch/device clock is required"),
    "LN003": ("error", "kernel launch (build.call/build.load/ctypes.CDLL/"
                       "launchers()) outside kernels/ (launches live behind "
                       "the kernel wrappers)"),
    "LN004": ("error", "torch.distributed/init_process_group/DeviceMesh "
                       "outside backend/ (topology is the execution "
                       "backend's monopoly)"),
    "SP001": ("error", "registered sampler closes over mutable Python state "
                       "(cross-step state must flow through the Sampler-v2 "
                       "carry, or rollback/resume silently desyncs)"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation (or info note) from any checker."""
    rule: str                       # registry id, e.g. "JX003"
    location: str                   # "file.py:42", "train_step", "flash fwd"
    message: str                    # what is wrong, with the observed values
    fix_hint: str = ""              # how to fix or whitelist it
    severity: str = ""              # defaults to the rule's registered one

    def __post_init__(self):
        if not self.severity:
            object.__setattr__(
                self, "severity", RULES.get(self.rule, ("error",))[0])
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def format(self) -> str:
        line = f"{self.severity.upper():7s} {self.rule} {self.location}: " \
               f"{self.message}"
        if self.fix_hint:
            line += f"\n        fix: {self.fix_hint}"
        return line

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Report:
    """An ordered collection of findings with error/ok accounting."""

    def __init__(self, findings: Optional[Iterable[Finding]] = None):
        self.findings: List[Finding] = list(findings or [])

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, other: "Report | Iterable[Finding]") -> None:
        self.findings.extend(
            other.findings if isinstance(other, Report) else other)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def format(self, show_info: bool = True) -> str:
        shown = [f for f in self.findings
                 if show_info or f.severity != "info"]
        if not shown:
            return "analysis: clean (no findings)"
        lines = [f.format() for f in shown]
        lines.append(f"analysis: {len(self.errors)} error(s), "
                     f"{len(self.findings) - len(self.errors)} note(s)")
        return "\n".join(lines)

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps({"ok": self.ok,
                           "findings": [f.to_dict() for f in self.findings]},
                          indent=indent, sort_keys=True)

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)


def rule_table() -> str:
    """The rule registry as a markdown table (CLI ``--rules``)."""
    lines = ["| rule | severity | description |", "|---|---|---|"]
    for rid, (sev, desc) in sorted(RULES.items()):
        lines.append(f"| {rid} | {sev} | {desc} |")
    return "\n".join(lines)
