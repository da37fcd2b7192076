"""One report format for every checker: rule id, severity, location,
message, fix hint — the port of the JAX package's ``analysis/report.py``,
with its rule registry and its JSON, so that a report reads the same from
either package.

Rule ids are stable strings (``JX*`` jaxpr, ``SY*`` sync, ``RC*``
recompile, ``VM*`` VMEM, ``LN*`` lint) so CI logs, tests, and whitelists
can reference a rule without parsing prose. ``RULES`` is the registry the
CLI prints as the rule table.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning", "info")

# rule id → (default severity, one-line description)
RULES: Dict[str, tuple] = {
    "JX001": ("error", "host-callback primitive traced into a jitted hot "
                       "path (a device→host sync every dispatch)"),
    "JX002": ("error", "float64/complex128 op inside a step function "
                       "(silent 2× bandwidth + matmul off the MXU path)"),
    "JX003": ("error", "pallas_call launch count differs from the "
                       "single-dispatch contract"),
    "JX004": ("error", "stray gather primitive on the fused selection path"),
    "SY001": ("error", "host↔device sync outside a sanctioned site"),
    "RC001": ("error", "step function re-traced: call signature "
                       "(shape/dtype/static arg) drifted between steps"),
    "VM001": ("error", "kernel's resident blocks exceed the per-program "
                       "VMEM budget"),
    "VM002": ("error", "block size does not divide the array extent "
                       "(grid would drop or pad elements)"),
    "VM003": ("info", "VMEM headroom report for a kernel configuration"),
    "LN001": ("error", "float()/np.asarray/jax.device_get in a hot-path "
                       "module outside a whitelisted site"),
    "LN002": ("error", "wall clock (time.time/perf_counter) where the "
                       "dispatch/device clock is required"),
    "LN003": ("error", "pallas_call outside kernels/ (kernel launches must "
                       "live behind the kernels API)"),
    "LN004": ("error", "jax.distributed/mesh construction/process queries "
                       "outside repro/backend/ + launch/mesh.py (topology "
                       "is the execution backend's monopoly)"),
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
