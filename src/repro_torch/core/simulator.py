"""Cycle-approximate multi-PU system simulator.

Wires together: PU specs (timing), ICUs (instruction decoding + LUTRAM
coordination state), the ISU token network (deterministic latencies), and the
shared HBM channels. Executes the instruction programs produced by the
compilation framework and reports throughput / latency / efficiency — this is
the executable model behind the paper's Figs. 3, 6 and Table III.

Deployments may comprise several concurrent member pipelines on disjoint PU
subsets (batch-level / hybrid parallelism, Sec. V-A). ``run`` therefore takes
a list of :class:`PipelineMember` descriptors and the :class:`SimResult`
carries per-member round accounting plus system aggregates; the single
``first_pid``/``last_pid`` form remains as the one-member special case.
Members carry the label of the workload (model) they run, so mixed-model
(multi-tenant) runs stay attributable — ``SimResult.fps_by_workload`` splits
the aggregate rate per tenant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .events import Kernel, Semaphore
from .icu import ICU, GroupStats
from .isa import Group
from .isu import ISUNetwork
from .program import PUProgram
from .pu import N_HBM_CHANNELS, PUSpec, SYS_CLK_HZ, make_u50_system, system_peak_tops

_FAULTS_ITEM = "the JAX package's faults/ is not copied into the port (ROADMAP queue 1 item 16)"


@dataclass(frozen=True)
class PipelineMember:
    """Entry/exit PUs of one member pipeline, for latency accounting.

    ``workload`` names the model this member runs (empty for legacy
    single-model deployments) so per-member results of a mixed-model run
    remain attributable to their tenant. ``slots`` names the decode
    sessions packed into this member (empty for unpacked members): one
    program round then advances *every* packed session by one token, so
    round accounting scales to token accounting by the slot count.
    ``pids`` lists every PU the member occupies (not just entry/exit, which
    need not bracket the set under kind-interleaved stage orders) — fault
    diagnostics attribute a stuck PU to its owning member through it; empty
    means unknown (legacy callers), which only degrades attribution."""

    first_pid: int
    last_pid: int
    label: str = ""
    workload: str = ""
    slots: tuple[str, ...] = ()
    pids: tuple[int, ...] = ()


def _steady_fps(round_ends: list[float], warmup: int, sys_clk_hz: float,
                fallback_rounds: int, end_cycles: float) -> float:
    """Steady-state rounds/s measured after ``warmup`` rounds."""
    if len(round_ends) <= warmup:
        if not round_ends:
            return 0.0
        if not end_cycles:
            # Rounds completed but no run-end timestamp was recorded:
            # estimate from the rounds themselves instead of reporting 0.
            if not round_ends[-1]:
                return 0.0
            return len(round_ends) / (round_ends[-1] / sys_clk_hz)
        return fallback_rounds / (end_cycles / sys_clk_hz)
    n = len(round_ends) - warmup
    if warmup > 0:
        dt = (round_ends[-1] - round_ends[warmup - 1]) / sys_clk_hz
    else:
        dt = round_ends[-1] / sys_clk_hz
    return n / dt if dt > 0 else 0.0


def _mean_latency(latencies: list[float], skip_warmup: int, sys_clk_hz: float) -> float:
    lats = latencies[skip_warmup:] or latencies
    if not lats:
        return 0.0
    return (sum(lats) / len(lats)) / sys_clk_hz


@dataclass
class MemberSimResult:
    """Round accounting of one member pipeline of a deployment."""

    member: PipelineMember
    sys_clk_hz: float
    end_cycles: float
    rounds: int
    # round r latency: first-PU LD round start -> last-PU ST round end
    round_latencies_cycles: list[float] = field(default_factory=list)
    round_end_cycles: list[float] = field(default_factory=list)

    @property
    def label(self) -> str:
        return self.member.label

    @property
    def workload(self) -> str:
        """Label of the workload (model) this member ran."""
        return self.member.workload

    def throughput_fps(self, warmup: int = 1) -> float:
        return _steady_fps(self.round_end_cycles, warmup, self.sys_clk_hz,
                           self.rounds, self.end_cycles)

    def latency_seconds(self, skip_warmup: int = 1) -> float:
        return _mean_latency(self.round_latencies_cycles, skip_warmup, self.sys_clk_hz)

    # -- slot-level accounting (packed decode members) -----------------------
    @property
    def n_slots(self) -> int:
        """Decode sessions packed into this member (1 when unpacked)."""
        return max(1, len(self.member.slots))

    @property
    def tokens(self) -> int:
        """Tokens produced: every round advances each packed slot by one."""
        return self.rounds * self.n_slots

    def token_rate(self, warmup: int = 1) -> float:
        """Steady-state tokens/s: the member round rate times the number of
        packed sessions (equals ``throughput_fps`` for unpacked members)."""
        return self.throughput_fps(warmup) * self.n_slots

    def slot_tokens(self) -> dict[str, int]:
        """Per-session token counts keyed by slot name."""
        return {slot: self.rounds for slot in self.member.slots}


@dataclass
class SimResult:
    sys_clk_hz: float
    end_cycles: float
    rounds: int
    pu_stats: dict[int, dict[Group, GroupStats]]
    tokens_sent: int
    deadlocked: bool
    # Merged over members (identical to the member's own lists when there is
    # only one member pipeline, which keeps the historical single-pipeline
    # semantics of these fields).
    round_latencies_cycles: list[float] = field(default_factory=list)
    round_end_cycles: list[float] = field(default_factory=list)
    members: list[MemberSimResult] = field(default_factory=list)
    # Watchdog detections (FaultReport of the fault package); a faulted run is not
    # "deadlocked" — the fault IS the diagnosis, and the run was halted by
    # detection rather than by draining the heap.
    faults: list = field(default_factory=list)
    # BlockedProc entries captured when the run deadlocked or faulted.
    blocked: list = field(default_factory=list)

    @property
    def faulted(self) -> bool:
        return bool(self.faults)

    # -- derived metrics -----------------------------------------------------
    @property
    def end_seconds(self) -> float:
        return self.end_cycles / self.sys_clk_hz

    def throughput_fps(self, warmup: int = 1) -> float:
        """Steady-state rounds/s measured after ``warmup`` rounds (over the
        merged round-completion stream of all member pipelines)."""
        return _steady_fps(self.round_end_cycles, warmup, self.sys_clk_hz,
                           self.rounds, self.end_cycles)

    def aggregate_fps(self, warmup: int = 1) -> float:
        """System throughput: the sum of the members' steady-state rates —
        the multi-batch metric of Fig. 6(b) / Table III."""
        if not self.members:
            return self.throughput_fps(warmup)
        return sum(m.throughput_fps(warmup) for m in self.members)

    def fps_by_workload(self, warmup: int = 1) -> dict[str, float]:
        """Aggregate throughput split per workload label — the per-tenant
        rates of a mixed-model (multi-tenant) deployment. Members without a
        workload label fall under ``""``."""
        out: dict[str, float] = {}
        for m in self.members:
            out[m.workload] = out.get(m.workload, 0.0) + m.throughput_fps(warmup)
        if not out:
            out[""] = self.throughput_fps(warmup)
        return out

    def aggregate_token_rate(self, warmup: int = 1) -> float:
        """System tokens/s: member round rates scaled by packed slot counts
        (equals ``aggregate_fps`` when nothing is slot-packed)."""
        if not self.members:
            return self.throughput_fps(warmup)
        return sum(m.token_rate(warmup) for m in self.members)

    def tokens_by_workload(self) -> dict[str, int]:
        """Token counts split per workload label (slot-aware rounds)."""
        out: dict[str, int] = {}
        for m in self.members:
            out[m.workload] = out.get(m.workload, 0) + m.tokens
        return out

    def latency_seconds(self, skip_warmup: int = 1) -> float:
        return _mean_latency(self.round_latencies_cycles, skip_warmup, self.sys_clk_hz)

    def member_latency_seconds(self, skip_warmup: int = 1) -> float:
        """System latency: the slowest member pipeline (paper Sec. V-A)."""
        if not self.members:
            return self.latency_seconds(skip_warmup)
        return max(m.latency_seconds(skip_warmup) for m in self.members)

    def busy_fraction(self, pid: int) -> float:
        cp = self.pu_stats[pid][Group.CP]
        return cp.busy / self.end_cycles if self.end_cycles else 0.0


class MultiPUSimulator:
    """Discrete-event execution of PUPrograms on the heterogeneous system."""

    def __init__(self, pus: Optional[list[PUSpec]] = None, trace: bool = False) -> None:
        self.pus = pus if pus is not None else make_u50_system()
        self._trace = trace
        self.reset()

    def reset(self) -> None:
        """Fresh kernel/ICU/ISU/HBM state on the *same fixed hardware*.

        This is the simulator analogue of the paper's headline feature: the
        PU array (the FPGA bitstream) never changes; switching deployment
        strategies only swaps the instruction programs loaded next."""
        self.kernel = Kernel()
        self.kernel.trace_enabled = self._trace
        self.isu = ISUNetwork(self.kernel, self.pus)
        self.hbm_channels: dict[int, Semaphore] = {
            c: self.kernel.semaphore(1, f"hbm{c}") for c in range(N_HBM_CHANNELS)
        }
        self.icus: dict[int, ICU] = {
            p.pid: ICU(self.kernel, p, self.isu, self.hbm_channels) for p in self.pus
        }
        self.isu.deliver = lambda dst, tok: self.icus[dst].deliver(tok)

    # -- fault injection: the JAX package's faults/ is not copied yet ------
    def inject(self, schedule) -> None:
        """Fault schedules come with the copy of the fault package."""
        raise NotImplementedError(f"fault injection: {_FAULTS_ITEM}")

    def clear_faults(self) -> None:
        raise NotImplementedError(f"fault injection: {_FAULTS_ITEM}")

    @property
    def peak_tops(self) -> float:
        return system_peak_tops(self.pus)

    def run(
        self,
        programs: list[PUProgram],
        *,
        until_cycles: float = float("inf"),
        first_pid: Optional[int] = None,
        last_pid: Optional[int] = None,
        members: Optional[list[PipelineMember]] = None,
        watchdog=None,
    ) -> SimResult:
        """Load + start all programs, run to completion (or ``until_cycles``).

        ``members`` lists the entry/exit PUs of each concurrent member
        pipeline for latency accounting. Without it, the programs form one
        pipeline whose entry/exit default to ``first_pid``/``last_pid`` (or
        the first/last program in the list).

        ``watchdog`` (the fault monitor) comes with the copy of the fault
        package and raises until then."""
        if watchdog is not None:
            raise NotImplementedError(f"watchdog: {_FAULTS_ITEM}")
        if not programs:
            raise ValueError("no programs")
        if members is not None and (first_pid is not None or last_pid is not None):
            raise ValueError("pass either members or first_pid/last_pid, not both")
        if members is None:
            first = first_pid if first_pid is not None else programs[0].pid
            last = last_pid if last_pid is not None else programs[-1].pid
            members = [PipelineMember(first_pid=first, last_pid=last,
                                      pids=tuple(p.pid for p in programs))]
        # pid -> owning member label, threaded onto every spawned process so
        # deadlock/fault diagnostics stay attributable to their tenant.
        label_of: dict[int, str] = {}
        for m in members:
            for pid in m.pids:
                label_of[pid] = m.workload or m.label
        for prog in programs:
            self.icus[prog.pid].start(prog, member=label_of.get(prog.pid, ""))
        faults: list = []
        end = self.kernel.run(until=until_cycles)

        stats = {p.pid: self.icus[p.pid].stats for p in self.pus}
        clk = self.pus[0].sys_clk_hz if self.pus else SYS_CLK_HZ

        member_results: list[MemberSimResult] = []
        for m in members:
            ld_starts = stats[m.first_pid][Group.LD].round_start_times
            st_ends = stats[m.last_pid][Group.ST].round_end_times
            nrounds = min(len(ld_starts), len(st_ends))
            latencies = [st_ends[r] - ld_starts[r] for r in range(nrounds)]
            member_results.append(
                MemberSimResult(
                    member=m,
                    sys_clk_hz=clk,
                    end_cycles=end,
                    rounds=len(st_ends),
                    round_latencies_cycles=latencies,
                    round_end_cycles=list(st_ends),
                )
            )

        # System-level view: the merged round-completion stream, with each
        # round's latency carried along so warmup skipping stays aligned.
        tagged: list[tuple[float, Optional[float]]] = []
        for mr in member_results:
            lats = mr.round_latencies_cycles
            for r, end_c in enumerate(mr.round_end_cycles):
                tagged.append((end_c, lats[r] if r < len(lats) else None))
        tagged.sort(key=lambda t: t[0])
        merged_ends = [t[0] for t in tagged]
        merged_lats = [t[1] for t in tagged if t[1] is not None]

        # Deadlock: processes still pending but no events left before horizon.
        # A watchdog-detected fault is its own diagnosis, not a deadlock.
        dead = (bool(self.kernel.deadlocked()) and end < until_cycles
                and not faults)

        return SimResult(
            sys_clk_hz=clk,
            end_cycles=end,
            rounds=len(merged_ends),
            pu_stats=stats,
            tokens_sent=self.isu.tokens_sent,
            deadlocked=dead,
            round_latencies_cycles=merged_lats,
            round_end_cycles=merged_ends,
            members=member_results,
            faults=faults,
            blocked=(self.kernel.blocked_procs() if (dead or faults) else []),
        )


def simulate(programs: list[PUProgram], pus: Optional[list[PUSpec]] = None,
             **kw) -> SimResult:
    return MultiPUSimulator(pus).run(programs, **kw)
