"""Session handles over a :class:`~repro_torch.deploy.System`.

``System.load``/``switch`` return a :class:`Session`: the stable handle on
one machine's deployment lifecycle — which tenants are being served, what
strategy is active, and the full swap history — where the old API returned
the mutated ``System`` itself. The handle is a thin shim over its system
(every unknown attribute forwards), so legacy chained call forms
(``system.load(dep).run()``) and code that treated the return value as the
``System`` keep working unchanged; new code reads ``session.tenants``,
``session.strategy`` and ``session.swaps`` and drives swaps through
``session.switch(...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from .report import RunReport
from .strategy import Strategy

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .deployment import Deployment
    from .system import System


@dataclass(frozen=True)
class SwapRecord:
    """One program swap: which deployment went live, serving whom."""

    name: str
    strategy: Strategy
    tenants: tuple[str, ...]


class Session:
    """Handle on one system's deployment lifecycle (created by ``load``)."""

    def __init__(self, system: "System") -> None:
        self.system = system
        self.swaps: list[SwapRecord] = []

    # -- state views ---------------------------------------------------------
    @property
    def deployment(self) -> "Optional[Deployment]":
        return self.system.deployment

    @property
    def strategy(self) -> Optional[Strategy]:
        dep = self.system.deployment
        return dep.strategy if dep is not None else None

    @property
    def tenants(self) -> tuple[str, ...]:
        return self.system.tenants

    @property
    def history(self) -> list[tuple[str, RunReport]]:
        return self.system.history

    # -- lifecycle (delegates to the system, returns this handle) ------------
    def load(self, deployment: "Deployment") -> "Session":
        return self.system.load(deployment)

    def switch(self, deployment: "Deployment") -> "Session":
        return self.system.switch(deployment)

    def run(self, rounds: Optional[int] = None, *,
            until_cycles: float = float("inf")) -> RunReport:
        return self.system.run(rounds, until_cycles=until_cycles)

    def _record(self, deployment: "Deployment") -> None:
        self.swaps.append(SwapRecord(name=deployment.name,
                                     strategy=deployment.strategy,
                                     tenants=self.system.tenants))

    # -- thin shim: anything else behaves like the system itself -------------
    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("system", "swaps"):
            raise AttributeError(
                f"{type(self).__name__!s} has no attribute {name!r}")
        return getattr(self.system, name)

    def __repr__(self) -> str:
        strat = self.strategy
        return (f"Session(tenants={list(self.tenants)!r}, "
                f"strategy={str(strat) if strat else None!r}, "
                f"swaps={len(self.swaps)})")
