"""Structured fault diagnostics: the runtime counterpart of
:class:`repro_torch.verify.Diagnostic`.

The static verifier proves properties of *programs*; the watchdog observes
*executions*. Both report through the same idiom — a typed code, a severity
and a precise location — so a serving operator reads "which PU, which
channel, which instruction" off a :class:`FaultReport` exactly like off a
compile-time diagnostic, and the recovery policy
(:meth:`repro_torch.serve.Server` quarantine) consumes ``suspect_pid`` /
``suspect_channel`` without parsing strings.
"""
from __future__ import annotations

import enum
import re
from dataclasses import dataclass
from typing import Optional

from ..verify.report import Severity


class FaultCode(enum.Enum):
    """Typed runtime fault codes, one per detection path.

    The first four come from the per-process WAIT watchdog (classified by
    the effect the stuck process is parked on), HEARTBEAT from the
    per-member round-progress monitor, DEADLOCK from a drained event heap
    or a ``DeadlockError`` converted into reports.
    """

    PU_HANG = "fault-pu-hang"            # injected/physical PU stops decoding
    SYNC_TIMEOUT = "fault-sync-timeout"  # WAIT_REQ/ACK starved on a channel
    HBM_TIMEOUT = "fault-hbm-timeout"    # HBM channel held beyond timeout
    STALL = "fault-stall"                # stuck on an intra-PU interlock
    HEARTBEAT = "fault-heartbeat"        # member made no round progress
    DEADLOCK = "fault-deadlock"          # event heap drained with parked procs


@dataclass(frozen=True)
class FaultReport:
    """One detected runtime fault, located as precisely as the watchdog can.

    ``pid``/``group``/``index`` locate the stuck decoder down to the
    instruction; ``channel`` is the starved REQ/ACK coordination channel
    ``(src_pid, bid)`` for sync timeouts; ``hbm_channel`` the stalled HBM
    channel; ``member`` the owning deployment member (tenant) label;
    ``cycle`` the simulated cycle the victim parked at.
    """

    code: FaultCode
    message: str
    severity: Severity = Severity.ERROR
    member: str = ""
    pid: Optional[int] = None
    group: Optional[str] = None          # "LD" | "CP" | "ST"
    index: Optional[int] = None          # instruction index within the group
    channel: Optional[tuple[int, int]] = None  # (src_pid, bid) sync channel
    hbm_channel: Optional[int] = None
    cycle: float = 0.0

    @property
    def location(self) -> str:
        parts = []
        if self.member:
            parts.append(self.member)
        if self.pid is not None:
            loc = f"pu{self.pid}"
            if self.group:
                loc += f".{self.group}"
            if self.index is not None:
                loc += f"[{self.index}]"
            parts.append(loc)
        if self.channel is not None:
            parts.append(f"channel(src_pid={self.channel[0]}, bid={self.channel[1]})")
        if self.hbm_channel is not None:
            parts.append(f"hbm{self.hbm_channel}")
        return ":".join(parts)

    @property
    def suspect_pid(self) -> Optional[int]:
        """The PU the recovery policy should quarantine: the source side of
        a starved sync channel (it stopped providing tokens), otherwise the
        stuck PU itself."""
        if self.channel is not None and self.code in (
                FaultCode.SYNC_TIMEOUT, FaultCode.DEADLOCK):
            return self.channel[0]
        return self.pid

    @property
    def suspect_hbm_channel(self) -> Optional[int]:
        return self.hbm_channel

    def __str__(self) -> str:
        loc = self.location
        where = f" at {loc}" if loc else ""
        return (f"[{self.severity.value}] {self.code.value}{where} "
                f"@cycle {self.cycle:.0f}: {self.message}")


_CHANNEL_RE = re.compile(r"\(src_pid=(\d+), bid=(\d+)\)")
_PROC_RE = re.compile(r"^pu(\d+)\.(\w+)$")


def _parse_proc_name(name: str) -> tuple[Optional[int], Optional[str]]:
    """``pu3.LD`` -> (3, "LD"); ``pu3.wadm`` -> (3, None); else (None, None)."""
    m = _PROC_RE.match(name)
    if not m:
        return None, None
    pid = int(m.group(1))
    group = m.group(2)
    return pid, group if group in ("LD", "CP", "ST") else None


def reports_from_blocked(blocked, *, code: FaultCode = FaultCode.DEADLOCK,
                         now: float = 0.0) -> list[FaultReport]:
    """Convert :class:`repro_torch.core.events.BlockedProc` entries (a drained
    heap or a ``DeadlockError``) into :class:`FaultReport` diagnostics, so
    deadlocks flow through the same recovery path as watchdog detections."""
    out: list[FaultReport] = []
    for b in blocked:
        pid, group = _parse_proc_name(b.name)
        channel = None
        m = _CHANNEL_RE.search(b.desc)
        if m:
            channel = (int(m.group(1)), int(m.group(2)))
        out.append(FaultReport(
            code=code,
            message=f"{b.name} parked: {b.desc}",
            member=b.member,
            pid=pid,
            group=group,
            channel=channel,
            cycle=b.cycle if b.cycle else now,
        ))
    return out
