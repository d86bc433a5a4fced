"""Runtime fault detection: WAIT watchdogs and round-progress heartbeats.

A hung PU, a lost sync token or a dead HBM channel all look the same from
inside the event kernel: some process parks forever while simulated time
stops advancing for its member. The watchdog is a *daemon* monitor process
that ticks every ``check_interval_cycles`` and converts that silence into
structured :class:`~repro_torch.faults.FaultReport` diagnostics:

* **per-channel WAIT timeouts** — any non-daemon process parked longer
  than ``wait_timeout_cycles`` is classified by the effect it is parked
  on: the injected hang gate (PU_HANG), a REQ/ACK LUTRAM wait with its
  exact ``(src_pid, bid)`` channel (SYNC_TIMEOUT), an HBM channel
  semaphore (HBM_TIMEOUT), anything else (STALL);
* **per-member heartbeats** — a member whose exit PU completes no round
  for ``heartbeat_cycles`` (and has not halted) raises HEARTBEAT.

On the first non-empty scan the monitor appends its reports and halts the
kernel — detection bounds the simulation instead of ``max_events``.
Timeouts default generous (legitimate waits in deep pipelines reach tens
of thousands of cycles); because the simulation is event-driven, idle
watchdog ticks are nearly free.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.events import Acquire, WaitCond
from ..core.isa import Group
from .report import FaultCode, FaultReport, _parse_proc_name

_GROUPS = {g.name: g for g in Group}


@dataclass(frozen=True)
class Watchdog:
    """Detection thresholds, in sys_clk cycles."""

    wait_timeout_cycles: float = 1_000_000.0
    heartbeat_cycles: float = 5_000_000.0
    check_interval_cycles: float = 100_000.0


def _classify(sim, proc, waited: float, now: float) -> FaultReport:
    """One parked process -> one located FaultReport."""
    pid, group = _parse_proc_name(proc.name)
    index = None
    if pid is not None and group is not None:
        icu = sim.icus.get(pid)
        if icu is not None:
            index = icu.cur_index.get(_GROUPS[group])
    eff = proc.pending
    cycle = proc.blocked_since if proc.blocked_since is not None else now
    common = dict(member=proc.member, pid=pid, group=group, index=index,
                  cycle=cycle)
    if isinstance(eff, WaitCond):
        key = eff.key
        if isinstance(key, tuple) and key and key[0] == "fault":
            return FaultReport(
                code=FaultCode.PU_HANG,
                message=f"{proc.name} stopped decoding "
                        f"({waited:.0f} cycles ago): {eff.desc}",
                **common)
        if isinstance(key, tuple) and len(key) == 4 and key[0] == "lut":
            channel = key[3]  # the (src_pid, bid) LUTRAM address
            return FaultReport(
                code=FaultCode.SYNC_TIMEOUT,
                message=f"{proc.name} starved {waited:.0f} cycles in "
                        f"{eff.desc or 'a sync WAIT'}",
                channel=channel, **common)
        return FaultReport(
            code=FaultCode.STALL,
            message=f"{proc.name} parked {waited:.0f} cycles on "
                    f"{eff.desc or repr(key)}",
            **common)
    if isinstance(eff, Acquire):
        name = eff.sem.name or ""
        if name.startswith("hbm"):
            return FaultReport(
                code=FaultCode.HBM_TIMEOUT,
                message=f"{proc.name} waited {waited:.0f} cycles for HBM "
                        f"channel {name[3:]}",
                hbm_channel=int(name[3:]), **common)
        return FaultReport(
            code=FaultCode.STALL,
            message=f"{proc.name} waited {waited:.0f} cycles for "
                    f"semaphore {name or '<anon>'}",
            **common)
    return FaultReport(  # pragma: no cover - parked implies an effect
        code=FaultCode.STALL,
        message=f"{proc.name} unresponsive for {waited:.0f} cycles",
        **common)


def _scan(sim, wd: Watchdog, members, hb_state: dict) -> list[FaultReport]:
    now = sim.kernel.now
    reports: list[FaultReport] = []
    for p in sim.kernel._procs:
        if p.done or p.daemon or p.pending is None:
            continue
        since = p.blocked_since if p.blocked_since is not None else now
        waited = now - since
        if waited >= wd.wait_timeout_cycles:
            reports.append(_classify(sim, p, waited, now))
    # Round-progress heartbeats, one per member that has not halted.
    from ..core.isa import Group as G
    for m in members:
        st = sim.icus[m.last_pid].stats[G.ST]
        if st.halted_at is not None:
            continue
        rounds = st.rounds_done
        label = m.workload or m.label or f"member@pu{m.last_pid}"
        prev = hb_state.get(label)
        if prev is None or prev[0] != rounds:
            hb_state[label] = (rounds, now)
            continue
        if now - prev[1] >= wd.heartbeat_cycles:
            reports.append(FaultReport(
                code=FaultCode.HEARTBEAT,
                message=f"member {label!r} completed no round for "
                        f"{now - prev[1]:.0f} cycles "
                        f"(stuck after round {rounds})",
                member=label, pid=m.last_pid,
                cycle=prev[1]))
    return reports


def _monitor(sim, wd: Watchdog, members, out: list):
    from ..core.events import Delay

    hb_state: dict = {}
    while True:
        yield Delay(wd.check_interval_cycles)
        reports = _scan(sim, wd, members, hb_state)
        if reports:
            out.extend(sorted(reports, key=lambda r: (r.cycle, str(r))))
            sim.kernel.halt()
            return


def spawn_monitor(sim, wd: Watchdog, members, out: list) -> None:
    """Spawn the daemon watchdog into the simulator's current kernel.
    Detected faults are appended to ``out`` (the run's fault list) and the
    kernel is halted on first detection."""
    sim.kernel.spawn(_monitor(sim, wd, members, out), name="faults.watchdog",
                     daemon=True)
