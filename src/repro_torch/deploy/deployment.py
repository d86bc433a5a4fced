"""Compile a :class:`Strategy` into an executable :class:`Deployment`.

``compile_deployment(graph, strategy)`` runs the full compilation framework
(Fig. 4) once per member pipeline on a disjoint PU/HBM-channel slice of the
machine and bundles the results: merged instruction programs ready for the
discrete-event simulator (or the hardware), per-member placement, and the
analytic aggregate performance model (throughput = sum of members, system
latency = slowest member, CE over the assigned PUs) that the DSE caches.

Every member carries its *own* :class:`~repro_torch.deploy.Workload` and is
compiled against its own graph — so one deployment can mix models
(FPGA-virtualization-style multi-tenancy: a ResNet member and a ViT member
on disjoint slices). The ``graph`` argument is the backward-compatible
broadcast: it binds every workload-less member, and may be ``None`` when the
strategy already assigns a workload to each member (e.g. built by
``Strategy.tenants`` or ``explore_multi``).

This is the uniform executable form of every DSE design point: DP-A is a
one-member deployment, DP-B/DP-C are multi-member ones, a multi-tenant
split is a per-member-workload one — all produced by the same call and all
loadable into :class:`repro_torch.deploy.System`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from ..compiler.compile import CompiledModel, compile_model
from ..compiler.graph import Graph
from ..core.program import PUProgram
from ..core.pu import N_HBM_CHANNELS, PUSpec, make_u50_system
from ..core.simulator import PipelineMember
from .resources import MemberResources, partition_resources
from .strategy import Strategy, Workload


@dataclass
class DeployedMember:
    """One member pipeline of a deployment, placed on its machine slice."""

    index: int
    config: tuple[int, int]
    workload: Workload
    compiled: CompiledModel
    resources: MemberResources

    @property
    def graph(self) -> Graph:
        return self.workload.graph

    @property
    def pids(self) -> tuple[int, ...]:
        return tuple(sorted(self.compiled.pid_map.values()))

    @property
    def channels(self) -> tuple[int, ...]:
        return self.resources.channel_pool

    @property
    def first_pid(self) -> int:
        stages = [s.index for s in self.compiled.part.stages if s.nids]
        return self.compiled.pid_map[min(stages)]

    @property
    def last_pid(self) -> int:
        stages = [s.index for s in self.compiled.part.stages if s.nids]
        return self.compiled.pid_map[max(stages)]

    @property
    def predicted_fps(self) -> float:
        return self.compiled.predicted_fps

    @property
    def predicted_latency(self) -> float:
        return self.compiled.predicted_latency

    def sim_member(self) -> PipelineMember:
        a, b = self.config
        return PipelineMember(
            first_pid=self.first_pid,
            last_pid=self.last_pid,
            label=f"m{self.index}({a},{b})",
            workload=self.workload.label,
            slots=self.workload.slots,
            pids=self.pids,
        )


@dataclass
class Deployment:
    """An executable deployment: programs + placement + analytic model.

    ``rounds`` is the explicit deployment-wide loop-count request, ``None``
    when per-member defaults applied (Workload.rounds / decode window /
    ``DEFAULT_ROUNDS``) — the actually-compiled count of each member is its
    programs' ProgCtrl NR field."""

    strategy: Strategy
    members: list[DeployedMember]
    pus: list[PUSpec]
    rounds: Optional[int]

    @property
    def name(self) -> str:
        return self.strategy.name or str(self.strategy)

    @property
    def batch(self) -> int:
        return len(self.members)

    @property
    def workloads(self) -> tuple[Workload, ...]:
        """Distinct workloads, in first-appearance member order."""
        return self.strategy.workloads

    @property
    def is_multi_tenant(self) -> bool:
        return len(self.workloads) > 1

    @property
    def graph(self) -> Optional[Graph]:
        """The single model of a single-tenant deployment (legacy view);
        ``None`` when members run different workloads."""
        w = self.workloads
        return w[0].graph if len(w) == 1 else None

    # -- executable form -----------------------------------------------------
    def programs(self, rounds: Optional[int] = None) -> list[PUProgram]:
        """The merged per-PU instruction programs of all members.

        ``rounds`` overrides the per-round loop count compiled into the
        programs by patching the terminal ProgCtrl NR field of each group —
        the same in-BRAM field the host would rewrite on hardware. Workload
        ``rounds`` overrides (per-member round semantics) are already
        compiled in; an explicit ``rounds`` here repatches every member."""
        progs = [p for m in self.members for p in m.compiled.programs]
        if rounds is None:
            return progs
        patched = []
        for p in progs:
            q = p.clone()
            for grp in (q.ld, q.cp, q.st):
                grp.progctrl.nr = rounds
            patched.append(q)
        return patched

    def sim_members(self) -> list[PipelineMember]:
        return [m.sim_member() for m in self.members]

    # -- analytic model (the DSE cache, aggregated) --------------------------
    @property
    def predicted_throughput(self) -> float:
        """Sum of member rates. For a multi-tenant deployment the members'
        frames are of different models; see ``predicted_throughput_by_workload``
        for the per-tenant split."""
        return sum(m.predicted_fps for m in self.members)

    def predicted_throughput_by_workload(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for m in self.members:
            out[m.workload.label] = out.get(m.workload.label, 0.0) + m.predicted_fps
        return out

    @property
    def predicted_latency(self) -> float:
        return max(m.predicted_latency for m in self.members)

    @property
    def used_tops(self) -> float:
        return sum(m.compiled.used_tops for m in self.members)

    def predicted_ce(self, peak_tops: Optional[float] = None) -> float:
        """CE = achieved GOPS / peak GOPS (defaults to the assigned PUs).

        Achieved GOPS sums each member's own model work x its own rate, so
        the metric is well-defined for mixed-model deployments too."""
        peak = peak_tops if peak_tops is not None else self.used_tops
        gops = sum(
            2.0 * m.graph.total_macs() * m.predicted_fps / 1e9
            for m in self.members
        )
        return gops / (peak * 1e3) if peak else 0.0

    def assert_disjoint(self) -> None:
        """Invariant: member pipelines never share a PU or an HBM channel."""
        pids: set[int] = set()
        chans: set[int] = set()
        for m in self.members:
            if pids & set(m.pids) or chans & set(m.channels):
                raise AssertionError(f"member {m.index} overlaps earlier members")
            pids |= set(m.pids)
            chans |= set(m.channels)


DEFAULT_ROUNDS = 16


def compile_deployment(
    g: "Optional[Graph | Workload]",
    strategy,
    *,
    pus: Optional[list[PUSpec]] = None,
    rounds: Optional[int] = None,
    n_io: int = 4,
    n_channels: int = N_HBM_CHANNELS,
    verify: bool = True,
    available: Optional[Iterable[int]] = None,
    channels: Optional[Iterable[int]] = None,
) -> Deployment:
    """Compile any schedule-like ``strategy`` (see :meth:`Strategy.of`) into
    an executable deployment.

    ``g`` (a Graph or a :class:`Workload`) is broadcast onto every member
    that does not already carry its own :class:`Workload`; pass ``g=None``
    for a fully multi-tenant strategy (every member workload-bound). Each member pipeline is compiled by the
    single-pipeline framework — against its own graph — on a disjoint PU
    subset and HBM channel pool; the partitioning that previously had to be
    hand-wired through ``compile_model(pid_offset=..., channel_pool=...)``
    happens here.

    Per-member loop count, in precedence order: the member's explicit
    ``Workload.rounds``; an explicit ``rounds`` argument here; one full
    decode window for decode-phase graphs (``graph.decode_steps`` — one
    program round is one token, so a decode tenant runs a complete
    advancing-length pass per measurement); ``DEFAULT_ROUNDS``.

    ``verify=True`` (the default) runs the static program verifier
    (:mod:`repro_torch.verify`) over every member's compiled programs — ISA lint,
    sync-token deadlock-freedom, memory hazards, cross-member isolation —
    and raises :class:`~repro_torch.verify.VerificationError` (carrying the
    structured :class:`~repro_torch.verify.VerifyReport`) on any error-severity
    diagnostic. Pass ``verify=False`` to skip (e.g. when intentionally
    compiling a defective program for the mutation harness).

    ``available``/``channels`` are the degraded-array masks (fault
    tolerance): pids / HBM channel ids still healthy. Members are placed
    and compiled against the healthy subset only, but the deployment still
    records the *full* ``pus`` array — the machine (the bitstream) is
    unchanged, quarantined units merely receive no programs — so it stays
    loadable into the same :class:`~repro_torch.deploy.System`."""
    strategy = Strategy.of(strategy).with_workload(g)
    unbound = [i for i, m in enumerate(strategy.members) if m.workload is None]
    if unbound:
        raise ValueError(
            f"strategy {strategy} has no workload for member(s) {unbound} "
            "and no graph was given to broadcast"
        )
    pus = pus if pus is not None else make_u50_system()
    pool_pus = pus
    if available is not None:
        avail = set(available)
        pool_pus = [p for p in pus if p.pid in avail]
        if not pool_pus:
            raise ValueError("no available PUs: every pid is masked out")
        for kind in ("PU1x", "PU2x"):
            need = strategy.total_a if kind == "PU1x" else strategy.total_b
            if need > 0 and not any(p.kind == kind for p in pool_pus):
                raise ValueError(
                    f"strategy {strategy} needs {kind} units but every "
                    f"{kind} pid is quarantined")
    chan_list = sorted(channels) if channels is not None else None
    placement = partition_resources(strategy, pool_pus, n_channels=n_channels,
                                    channels=chan_list)

    members: list[DeployedMember] = []
    for member, res in zip(strategy.members, placement):
        workload = member.workload
        if workload.rounds is not None:
            member_rounds = workload.rounds
        elif rounds is not None:
            member_rounds = rounds
        else:
            member_rounds = workload.graph.decode_steps or DEFAULT_ROUNDS
        masked = strategy.batch > 1 or available is not None or channels is not None
        cm = compile_model(
            workload.graph,
            member.a,
            member.b,
            pus=pool_pus,
            rounds=member_rounds,
            n_io=n_io,
            pid_offset=res.pid_offset if masked else None,
            channel_pool=list(res.channel_pool) if masked else None,
        )
        # Force instruction generation here: compilation is lazy (the DSE
        # evaluates thousands of configs without ever emitting instructions),
        # and the deploy boundary is where a design point becomes executable.
        cm.ensure_programs()
        members.append(DeployedMember(index=res.index, config=res.config,
                                      workload=workload, compiled=cm,
                                      resources=res))

    dep = Deployment(strategy=strategy, members=members, pus=pus,
                     rounds=rounds)
    dep.assert_disjoint()
    if verify:
        from ..verify import verify_deployment

        verify_deployment(dep).raise_if_failed()
    return dep
