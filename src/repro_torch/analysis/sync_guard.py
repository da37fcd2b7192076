"""Runtime guard recording every host↔device sync with a stack summary —
the port of the JAX package's ``analysis/sync_guard.py``.

The training loop's promise: between its drain points (metric flushes,
console lines, checkpoint saves, eval collection, rollback) the step loop
does not read device values to the host. :class:`SyncGuard` pins that
promise at runtime: it instruments the sync entry points of PyTorch —
``Tensor.item``, ``.tolist``, ``.numpy``, ``.cpu``, ``__float__``,
``__int__``, ``__bool__``, ``__array__``, ``torch.cuda.synchronize`` and
``torch.cuda.Event.synchronize`` — and records every hit in the guarded
thread; ``strict=True`` raises :class:`SyncGuardError` at the offending
call site.

Sanctioned sites mark themselves with :func:`sync_allowed`::

    with sync_allowed("metrics_flush"):
        vals = [float(v) for v in pending]     # recorded, but sanctioned

A call is recorded whatever the tensor's device, as the JAX guard records
reads of host-resident arrays on the CPU backend: the CPU tests see the
same sites as the card. One instrumented call is one event — the syncs it
makes inside (``__array__`` → ``numpy``) are not recorded again.

Scope is **thread-local**: only threads that entered a guard are audited.
The checkpoint writer thread and the autograd engine's device threads may
block freely.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding, Report

_tls = threading.local()

# the instrumented methods of torch.Tensor; most are inherited from
# torch._C.TensorBase, so a patch is undone by deleting it again
_TENSOR_METHODS = ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__",
                   "__array__")
_MISSING = object()


class SyncGuardError(RuntimeError):
    """A host↔device sync occurred outside every sanctioned site."""


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    """One observed sync: what kind, which sanctioned site (if any), and
    the user stack frame it came from."""
    kind: str                       # "__float__", "item", "synchronize", ...
    site: Optional[str]             # sanctioned site name, None = violation
    where: str                      # "file.py:42 in flush"

    @property
    def sanctioned(self) -> bool:
        return self.site is not None


def _origin() -> str:
    """The first frame outside the guard, torch and numpy: the call site
    the sync is charged to (a ``np.asarray(tensor)`` or a ``tensor.sum()
    .item()`` in user code is a user sync)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "sync_guard" in fn or "/torch/" in fn or "/numpy/" in fn:
            f = f.f_back
            continue
        return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno} in {f.f_code.co_name}"
    return "<torch>"


def _allowed_site() -> Optional[str]:
    stack = getattr(_tls, "allowed", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def sync_allowed(site: str):
    """Mark the enclosed block as a sanctioned sync site named ``site``.

    Cheap no-op when no guard is active in this thread; safe to leave in
    production code permanently (the whitelist lives at the drain sites
    themselves, not in a separate config).
    """
    stack = getattr(_tls, "allowed", None)
    if stack is None:
        stack = _tls.allowed = []
    stack.append(site)
    try:
        yield
    finally:
        stack.pop()


def _patch_points():
    """(holder, attribute, kind) of every instrumented entry point."""
    return ([(torch.Tensor, name, name) for name in _TENSOR_METHODS]
            + [(torch.cuda, "synchronize", "cuda.synchronize"),
               (torch.cuda.Event, "synchronize", "Event.synchronize")])


class SyncGuard:
    """Context manager auditing host↔device syncs in the entering thread.

    ``strict=True`` raises :class:`SyncGuardError` at the first
    unsanctioned sync; ``strict=False`` only records, for post-hoc
    :meth:`report`. Events (sanctioned included) accumulate in
    :attr:`events`. Reentrant patches are refcounted so nested guards and
    concurrent guarded threads compose.
    """

    _lock = threading.Lock()
    _install_count = 0
    # (holder, attribute) → what the holder's own __dict__ held before
    _saved: Dict[Tuple[object, str], object] = {}

    def __init__(self, strict: bool = False, label: str = "sync_guard"):
        self.strict = strict
        self.label = label
        self.events: List[SyncEvent] = []

    # -- patch plumbing ----------------------------------------------------

    @classmethod
    def _install(cls) -> None:
        with cls._lock:
            cls._install_count += 1
            if cls._install_count > 1:
                return
            cls._saved = {}
            for holder, name, kind in _patch_points():
                cls._saved[(holder, name)] = vars(holder).get(name, _MISSING)
                setattr(holder, name, _wrap(kind, getattr(holder, name)))

    @classmethod
    def _uninstall(cls) -> None:
        with cls._lock:
            cls._install_count -= 1
            if cls._install_count > 0:
                return
            for (holder, name), orig in cls._saved.items():
                if orig is _MISSING:
                    delattr(holder, name)        # inherited again
                else:
                    setattr(holder, name, orig)
            cls._saved = {}

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "SyncGuard":
        if getattr(_tls, "guard", None) is not None:
            raise RuntimeError("SyncGuard is not reentrant within a thread")
        self._install()
        _tls.guard = self
        return self

    def __exit__(self, *exc) -> None:
        _tls.guard = None
        self._uninstall()

    # -- results -----------------------------------------------------------

    def on_event(self, event: SyncEvent) -> None:
        self.events.append(event)
        if self.strict and not event.sanctioned:
            raise SyncGuardError(
                f"[{self.label}] unsanctioned host sync: {event.kind} at "
                f"{event.where} — wrap the drain point in "
                f"sync_allowed(\"<site>\") if this sync is intentional")

    @property
    def violations(self) -> List[SyncEvent]:
        return [e for e in self.events if not e.sanctioned]

    def site_counts(self) -> Dict[Tuple[str, str], int]:
        out: Dict[Tuple[str, str], int] = {}
        for e in self.events:
            key = (e.site or "UNSANCTIONED", e.kind)
            out[key] = out.get(key, 0) + 1
        return out

    def report(self) -> Report:
        """SY001 per distinct violating call site; sanctioned totals as an
        info note (the sync budget the run actually spent)."""
        rep = Report()
        seen: Dict[Tuple[str, str], int] = {}
        for e in self.violations:
            seen[(e.kind, e.where)] = seen.get((e.kind, e.where), 0) + 1
        for (kind, where), n in seen.items():
            times = f" ({n}×)" if n > 1 else ""
            rep.add(Finding(
                rule="SY001", location=where,
                message=f"unsanctioned host sync via {kind}{times} while "
                        f"[{self.label}] was active",
                fix_hint="move the sync to a flush boundary, or wrap the "
                         "site in repro_torch.analysis.sync_allowed(...) "
                         "with a named site"))
        sanctioned = [e for e in self.events if e.sanctioned]
        if sanctioned:
            by_site: Dict[str, int] = {}
            for e in sanctioned:
                by_site[e.site] = by_site.get(e.site, 0) + 1
            detail = ", ".join(f"{s}={n}" for s, n in sorted(by_site.items()))
            rep.add(Finding(
                rule="SY001", severity="info", location=self.label,
                message=f"{len(sanctioned)} sanctioned sync(s): {detail}"))
        return rep


def _wrap(kind: str, orig: Callable) -> Callable:
    def hook(*args, **kwargs):
        if getattr(_tls, "in_sync", False):
            return orig(*args, **kwargs)     # inside an instrumented call
        _record(kind)
        _tls.in_sync = True
        try:
            return orig(*args, **kwargs)
        finally:
            _tls.in_sync = False
    return hook


def _record(kind: str) -> None:
    guard: Optional[SyncGuard] = getattr(_tls, "guard", None)
    if guard is None:
        return                       # unguarded thread (checkpoint writer, ...)
    guard.on_event(SyncEvent(kind=kind, site=_allowed_site(), where=_origin()))
