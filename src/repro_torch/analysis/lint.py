"""AST lint rules ruff can't express — the port's hot-path hygiene, the
twin of the JAX package's ``analysis/lint.py`` (the same walk, the same
``# lint: allow`` marker, the same rule ids, PyTorch's calls in them).

Four rules, each scoped to the modules where the pattern is actually a
bug (the same call is fine elsewhere):

* **LN001** — ``float()`` / ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``np.asarray`` / ``np.array`` / ``synchronize()`` in the
  launch/api hot-path modules. Every one of these reads the device to the
  host (or waits for it); on the async host loop they belong only at
  sanctioned drain points.
* **LN002** — ``time.time()`` / ``time.perf_counter()`` in step, selection
  or kernel code, where timing must come from the dispatch clock
  (``launch/metrics.py`` ``DeviceClock``, CUDA events): a wall clock there
  measures the Python host, not the device.
* **LN003** — a kernel launch outside ``kernels/``: ``build.call``,
  ``build.load``, ``ctypes.CDLL`` or a wrapper's ``launchers()``. Launches
  live behind the kernel wrappers (operand checks, the counted route, the
  plain version on CPU tensors, the autograd functions); a stray direct
  launch bypasses all of them.
* **LN004** — ``torch.distributed.*`` / ``init_process_group`` /
  ``DeviceMesh`` / ``init_device_mesh`` outside ``backend/``: process
  topology is the execution backend's monopoly.

Whitelisting is inline and local: put ``lint: allow`` in a comment on the
flagged line (or the line above). The sanctioned drain points carry the
marker next to their ``sync_allowed(...)`` wrapper, so the static
whitelist and the runtime whitelist sit on the same lines.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Callable, List, Optional, Sequence

from repro_torch.analysis.report import Finding, Report

ALLOW_MARKER = "lint: allow"

# modules where a host sync outside a sanctioned site is a hot-path bug
HOT_PATH_MODULES = (
    "launch/steps.py",
    "launch/metrics.py",
    "launch/evaluate.py",
    "resilience/guard.py",
    "api/trainer.py",
    "api/callbacks.py",
    "selection/overlap.py",
)

# modules where timing must come from the dispatch clock
DISPATCH_CLOCK_SCOPES = ("launch/steps.py", "selection/", "kernels/")

_SYNC_CALLS = {"float", "np.asarray", "numpy.asarray", "np.array",
               "numpy.array"}
_SYNC_TAILS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_WALL_CLOCK = {"time.time", "time.perf_counter", "time.monotonic",
               "perf_counter"}

# kernel launches live in kernels/ (LN003)
_LAUNCH_CALLS = {"build.call", "build.load", "kernels.build.call",
                 "kernels.build.load", "ctypes.CDLL", "CDLL"}
_LAUNCH_TAILS = {"launchers", "_launchers"}

# topology is the backend's monopoly (LN004)
_TOPOLOGY_SCOPES = ("backend/",)
_TOPOLOGY_TAILS = {"init_process_group", "init_device_mesh", "DeviceMesh"}


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _in_scope(relpath: str, scopes: Sequence[str]) -> bool:
    return any(relpath == s or (s.endswith("/") and relpath.startswith(s))
               for s in scopes)


def _allowed(lines: Sequence[str], lineno: int) -> bool:
    """``lint: allow`` on the flagged line or the one above."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and ALLOW_MARKER in lines[ln - 1]:
            return True
    return False


def _call_findings(relpath: str, name: str, lineno: int) -> List[Finding]:
    tail = name.rsplit(".", 1)[-1]
    out: List[Finding] = []
    loc = f"{relpath}:{lineno}"
    if _in_scope(relpath, HOT_PATH_MODULES) and (
            name in _SYNC_CALLS or tail in _SYNC_TAILS):
        out.append(Finding(
            rule="LN001", location=loc,
            message=f"host-sync call '{name}()' in a hot-path module",
            fix_hint="drain at a flush boundary under sync_allowed(...), "
                     "then mark the line '# lint: allow <why>'"))
    if _in_scope(relpath, DISPATCH_CLOCK_SCOPES) and name in _WALL_CLOCK:
        out.append(Finding(
            rule="LN002", location=loc,
            message=f"wall clock '{name}()' where the dispatch clock is "
                    "required",
            fix_hint="use launch/metrics.py:DeviceClock (CUDA events) or "
                     "hoist the timing out of the step path"))
    if (name in _LAUNCH_CALLS or tail in _LAUNCH_TAILS) and \
            not relpath.startswith("kernels/"):
        out.append(Finding(
            rule="LN003", location=loc,
            message=f"direct kernel launch '{name}()' outside kernels/",
            fix_hint="call the kernel's wrapper in kernels/ (operand checks, "
                     "the counted route and the plain version live there)"))
    if not _in_scope(relpath, _TOPOLOGY_SCOPES) and (
            name.startswith("torch.distributed.") or tail in _TOPOLOGY_TAILS):
        out.append(Finding(
            rule="LN004", location=loc,
            message=f"topology call '{name}(...)' outside the execution "
                    "backend",
            fix_hint="route through the backend (backend/) — or mark "
                     "'# lint: allow <why>' for a deliberate exception"))
    return out


def lint_source(src: str, relpath: str) -> List[Finding]:
    """Lint one module's source. ``relpath`` is the path relative to
    ``src/repro_torch`` with forward slashes (drives the rule scopes)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rule="LN001", location=f"{relpath}:{e.lineno or 0}",
                        message=f"unparseable module: {e.msg}")]
    lines = src.splitlines()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if not name:
            continue
        for f in _call_findings(relpath, name, node.lineno):
            if not _allowed(lines, node.lineno):
                findings.append(f)
    return findings


def lint_file(path: pathlib.Path, root: pathlib.Path) -> List[Finding]:
    relpath = path.relative_to(root).as_posix()
    return lint_source(path.read_text(), relpath)


def lint_tree(root: Optional[pathlib.Path] = None,
              predicate: Optional[Callable[[str], bool]] = None) -> Report:
    """Lint every module under ``src/repro_torch`` (default: the installed
    package's own directory)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parent.parent
    report = Report()
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("analysis/"):
            continue                 # the linter's own sources
        if predicate is not None and not predicate(rel):
            continue
        report.extend(lint_file(path, root))
    return report
