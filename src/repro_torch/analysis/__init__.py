"""Static + runtime analysis of the training hot path — the twins of the JAX
package's ``analysis`` modules.

The port's efficiency story is a set of *contracts* — one kernel launch per
selection refresh, one flash forward per attention layer and one dQ and one
dK/dV per layer in the backward, an async host loop that never syncs per
step outside its named sites, kernel plans that fit one Hopper block's
shared memory — and this package is what enforces them:

  * :mod:`repro_torch.analysis.launch_audit` — launch accounting over one
    eager call (route decisions in ``kernels/build.py``, held to the
    profiler on the card), forbidden host syncs, float64 ops and stray
    gathers (a ``TorchDispatchMode``); the kernel registry and the launch
    reckoning that ``chip_smoke.py`` shares;
  * :mod:`repro_torch.analysis.sync_guard`   — a runtime guard that records
    every host↔device sync with a stack summary and fails on syncs outside
    sanctioned sites (``train.audit``);
  * :mod:`repro_torch.analysis.recompile`    — signature drift across step
    calls, naming the argument whose shape/dtype drifted;
  * :mod:`repro_torch.analysis.smem`         — the per-block shared memory
    of every Hopper kernel plan and the flash block rule (the one estimator
    the kernel wrappers and the attention router consult, held to the C
    libraries' own sums on the card);
  * :mod:`repro_torch.analysis.lint`         — AST rules ruff can't express
    (host-sync calls in hot-path modules, wall clocks where the dispatch
    clock is required, kernel launches outside ``kernels/``, topology calls
    outside ``backend/``);
  * :mod:`repro_torch.analysis.report`       — the one finding format: rule
    id, severity, location, message, fix hint.

``python -m repro_torch.analysis`` runs the full battery over a probe
config (``analysis/runner.py``), on the card unless ``--device=cpu``.
"""
from repro_torch.analysis.launch_audit import wide_allowed
from repro_torch.analysis.report import RULES, Finding, Report
from repro_torch.analysis.sync_guard import SyncGuard, SyncGuardError, sync_allowed

__all__ = [
    "Finding",
    "Report",
    "RULES",
    "SyncGuard",
    "SyncGuardError",
    "sync_allowed",
    "wide_allowed",
]

