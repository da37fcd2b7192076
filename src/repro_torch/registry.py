"""One generic name → object registry behind every pluggable subsystem.

The PyTorch port's copy of the JAX package's ``Registry`` (same contract):

  * ``register(name, obj, *, overwrite=False)`` — duplicate names raise
    ``ValueError("<kind> '<name>' already registered")`` unless
    ``overwrite=True`` is passed explicitly;
  * ``get(name)`` — unknown names raise
    ``KeyError("unknown <kind> '<name>'; available: (...)")`` so the caller
    sees every valid choice in the error itself;
  * ``available()`` — sorted name tuple.

One addition: ``not_ported`` names the entries the JAX package has and the
port does not have yet. Asking for one raises ``NotImplementedError``
pointing to ``ROADMAP.md`` instead of the generic unknown-name ``KeyError``.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, TypeVar

T = TypeVar("T")


class Registry(dict):
    """Name → object mapping with uniform register/get/available semantics."""

    def __init__(self, kind: str,
                 ensure_defaults: Optional[Callable[[], None]] = None,
                 not_ported: Iterable[str] = ()):
        super().__init__()
        self.kind = kind
        self._ensure = ensure_defaults
        self.not_ported = tuple(not_ported)

    def _ensure_defaults(self) -> None:
        if self._ensure is not None and not self:
            self._ensure()

    def register(self, name: str, obj: T, *, overwrite: bool = False) -> T:
        if not overwrite and name in self:
            raise ValueError(f"{self.kind} '{name}' already registered")
        self[name] = obj
        return obj

    def get(self, name: str) -> T:  # type: ignore[override]
        # NOT dict.get: unknown names raise with the available choices
        self._ensure_defaults()
        if name not in self:
            if name in self.not_ported:
                raise NotImplementedError(
                    f"{self.kind} '{name}' is not ported to repro_torch yet "
                    f"(see ROADMAP.md); available: {self.available()}")
            raise KeyError(f"unknown {self.kind} '{name}'; "
                           f"available: {self.available()}")
        return self[name]

    def available(self) -> Tuple[str, ...]:
        self._ensure_defaults()
        return tuple(sorted(self))
