"""Runtime analysis of the training hot path — the twins of the JAX
package's ``analysis`` modules that ``train.audit`` needs:

  * :mod:`repro_torch.analysis.sync_guard` — a runtime guard that records
    every host↔device sync with a stack summary and fails on syncs outside
    sanctioned sites (``train.audit``);
  * :mod:`repro_torch.analysis.recompile`  — signature drift across step
    calls, naming the argument whose shape/dtype drifted;
  * :mod:`repro_torch.analysis.report`     — the one finding format: rule
    id, severity, location, message, fix hint.

The static checkers (launch-count contracts, the shared-memory estimator,
the lint rules) and ``python -m repro.analysis`` have no twin yet
(``ROADMAP.md`` A9).
"""
from repro_torch.analysis.report import RULES, Finding, Report
from repro_torch.analysis.sync_guard import SyncGuard, SyncGuardError, sync_allowed

__all__ = [
    "Finding",
    "Report",
    "RULES",
    "SyncGuard",
    "SyncGuardError",
    "sync_allowed",
]
