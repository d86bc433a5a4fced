"""Runtime sessions: one fixed PU array, hot-swappable deployments.

The paper's headline capability (Sec. V): the FPGA is configured once; a host
switches among deployment strategies — pipeline parallelism, batch-level
parallelism, hybrids — purely by loading new instruction programs into the
ICU BRAMs. :class:`System` is that story as an API:

    system = System()                        # fixed make_u50_system() machine
    session = system.load(deployment_a)      # -> Session handle
    session.run(rounds=6)                    # measure strategy A -> RunReport
    session.switch(deployment_c).run()       # swap programs, same hardware

``load``/``switch`` return a :class:`~repro_torch.deploy.session.Session` — the
handle carrying the active tenants, the current strategy and the swap
history — and ``run`` returns a :class:`~repro_torch.deploy.report.RunReport`
(the unified result schema). Both are thin over the legacy objects: the
session forwards unknown attributes to the system and the report to its
``SimResult``, so historical chained forms (``system.load(dep).run()``)
and result consumers keep working unchanged.

``switch`` is exactly ``load`` with a hardware-compatibility check against
the *current* machine — it never rebuilds the PU array, only resets the
transient kernel/ICU/ISU state (BRAM program images, LUTRAMs, buffers), so a
switch-then-run is bit-identical to a fresh load-then-run.

Deployments whose member sets differ in *model*, not just shape, swap the
same way: going from a single-tenant DP-A to a two-tenant ResNet+ViT split
(per-member :class:`~repro_torch.deploy.Workload`) is still just new instruction
programs on the unchanged PU array — no reconfiguration, and the per-tenant
rates come back through ``RunReport.fps_by_workload``.
"""
from __future__ import annotations

from typing import Optional

from ..core.pu import PUSpec, make_u50_system
from ..core.simulator import MultiPUSimulator
from .deployment import Deployment
from .report import RunReport
from .session import Session


class System:
    """One fixed simulated machine, executing hot-swappable deployments."""

    def __init__(self, pus: Optional[list[PUSpec]] = None, trace: bool = False) -> None:
        self.pus = list(pus) if pus is not None else make_u50_system()
        self.sim = MultiPUSimulator(self.pus, trace=trace)
        self.deployment: Optional[Deployment] = None
        self.session: Optional[Session] = None
        self.history: list[tuple[str, RunReport]] = []
        # The fault monitor comes with the copy of the fault package; the
        # simulator copy raises for any watchdog until then, so this stays None.
        self.watchdog = None

    # -- fault injection: the simulator copy raises until faults/ is copied --
    def inject(self, schedule) -> None:
        """Attach a fault schedule to the simulated hardware (raises
        ``NotImplementedError`` in the simulator copy, before any work)."""
        self.sim.inject(schedule)

    def clear_faults(self) -> None:
        self.sim.clear_faults()

    # -- deployment lifecycle ------------------------------------------------
    def _check_compatible(self, deployment: Deployment) -> None:
        if list(deployment.pus) != self.pus:
            raise ValueError(
                f"deployment {deployment.name!r} was compiled for different "
                "hardware than this system (PU array is fixed at session start)"
            )

    @property
    def tenants(self) -> tuple[str, ...]:
        """Workload labels of the active deployment (empty before load)."""
        if self.deployment is None:
            return ()
        return tuple(w.label for w in self.deployment.workloads)

    def load(self, deployment: Deployment) -> Session:
        """Stage ``deployment`` as the active strategy; returns the
        :class:`Session` handle (one per system lifetime, created on first
        load; later loads/switches record onto the same handle).

        The deployment may serve any mix of workloads — a multi-tenant
        member set loads exactly like a single-model one, since only the
        instruction programs differ."""
        self._check_compatible(deployment)
        self.deployment = deployment
        if self.session is None:
            self.session = Session(self)
        self.session._record(deployment)
        return self.session

    def switch(self, deployment: Deployment) -> Session:
        """Swap to another strategy on the *unchanged* hardware — including
        one whose members run different models (single-tenant -> multi-tenant
        and back).

        Equivalent to :meth:`load`; requires that a deployment is already
        active, which is what makes it a switch."""
        if self.deployment is None:
            raise RuntimeError("nothing loaded yet — use System.load first")
        return self.load(deployment)

    def run(self, rounds: Optional[int] = None, *,
            until_cycles: float = float("inf")) -> RunReport:
        """Execute the active deployment for ``rounds`` program rounds
        (default: the round count it was compiled with). Returns the
        unified :class:`RunReport` (forwards to its backing ``SimResult``)."""
        if self.deployment is None:
            raise RuntimeError("no deployment loaded — use System.load first")
        self.sim.reset()  # clear transient state; the PU array persists
        res = self.sim.run(
            self.deployment.programs(rounds),
            members=self.deployment.sim_members(),
            until_cycles=until_cycles,
            watchdog=self.watchdog,
        )
        report = RunReport.from_sim(res)
        self.history.append((self.deployment.name, report))
        return report
