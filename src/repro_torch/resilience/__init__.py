"""Resilience: divergence sentinel plumbing, rollback, and chaos testing —
the port of the JAX package's ``resilience`` package.

Three cooperating pieces:

  * the divergence sentinel lives in ``launch/steps.py``
    (``apply_sentinel``): a health verdict between the gradient and the
    update, so a poisoned gradient never touches the parameters;
  * :class:`~repro_torch.resilience.guard.DivergenceGuardCallback` consumes
    that verdict at drain boundaries and, after ``train.bad_step_patience``
    consecutive bad steps, asks the Trainer to roll back to the last
    checkpoint stamped healthy (``CheckpointManager.restore_latest_good``);
  * :mod:`~repro_torch.resilience.chaos` is the deterministic
    fault-injection harness (NaN batch, SIGTERM, kill-mid-save, bit-flip,
    stalled step) driven by ``train.fault_plan`` / ``REPRO_FAULT_PLAN`` and
    replayed bit-exactly by the tests and the scenario matrix
    (``python -m repro_torch.resilience``).
"""
from repro_torch.resilience.chaos import (ChaosCrash, FaultPlan, activate, active_plan,
                                          crash_point, deactivate, flip_checkpoint_leaf,
                                          load_plan)


def __getattr__(name):
    # guard pulls in the api/callback stack (which imports the checkpoint
    # module, which imports chaos from here) — load it lazily so
    # `from repro_torch.resilience import chaos` stays cycle-free and light
    if name == "DivergenceGuardCallback":
        from repro_torch.resilience.guard import DivergenceGuardCallback
        return DivergenceGuardCallback
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ChaosCrash",
    "DivergenceGuardCallback",
    "FaultPlan",
    "activate",
    "active_plan",
    "crash_point",
    "deactivate",
    "flip_checkpoint_leaf",
    "load_plan",
]
