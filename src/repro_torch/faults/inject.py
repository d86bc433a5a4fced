"""Fault injection into a :class:`repro_torch.core.simulator.MultiPUSimulator`.

The injector attaches a :class:`~repro_torch.faults.FaultSchedule` to the
*per-run* objects the simulator rebuilds on every ``reset()`` — hang gates
on the fresh ICUs, a fault hook on the fresh ISU fabric, daemon stall
processes in the fresh kernel. Nothing outlives a reset except the frozen
schedule itself, so a simulator whose schedule is cleared
(``clear_faults()``) is indistinguishable from one that was never faulted,
and re-arming the same schedule every window keeps seeded runs
deterministic.

All injector processes are *daemons*: they never count as pending work
(a stall holding an unused channel forever must not deadlock a healthy
run) and the watchdog skips them when scanning for victims.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional

from ..core.events import Acquire, Delay, Release, WaitCond
from ..core.isu import Token
from .spec import (FaultSchedule, HBMStall, LinkSpike, PUHang, TokenCorrupt,
                   TokenDrop)

# BID field width (Table I(b)): corrupted BIDs wrap inside the field.
_BID_SPACE = 1 << 12


class FaultInjector:
    """Arms one frozen schedule onto one simulator's current run state."""

    def __init__(self, sim, schedule: FaultSchedule) -> None:
        self.sim = sim
        self.schedule = schedule
        # (cycle, description) per engaged fault, for this run only.
        self.log: list[tuple[float, str]] = []

    def install(self) -> None:
        """Attach every spec to the simulator's *current* kernel/ICU/ISU
        (called from ``MultiPUSimulator.reset()``)."""
        token_faults: list[list] = []  # [spec, match_count, fired]
        for f in self.schedule:
            if isinstance(f, PUHang):
                icu = self.sim.icus.get(f.pid)
                if icu is not None:
                    icu.hang_at = f.at_cycle
            elif isinstance(f, HBMStall):
                self.sim.kernel.spawn(
                    self._hbm_stall(f), name=f"fault.hbm{f.channel}",
                    daemon=True)
            elif isinstance(f, (TokenDrop, TokenCorrupt, LinkSpike)):
                token_faults.append([f, 0, False])
            else:
                raise TypeError(f"unknown fault spec {f!r}")
        if token_faults:
            self.sim.isu.fault_hook = self._make_hook(token_faults)

    # -- HBM channel stall ---------------------------------------------------
    def _hbm_stall(self, f: HBMStall):
        if f.at_cycle > 0:
            yield Delay(f.at_cycle)
        chan = self.sim.hbm_channels[f.channel]
        yield Acquire(chan)
        self.log.append((self.sim.kernel.now,
                         f"hbm-stall engaged on channel {f.channel}"))
        if math.isinf(f.duration):
            # Hold the channel forever: park on a key nobody notifies.
            yield WaitCond(("fault", "hbm-stall", f.channel),
                           pred=lambda: False,
                           desc=f"injected HBM stall holding channel {f.channel}")
        yield Delay(f.duration)
        yield Release(chan)

    # -- token-level faults (drop / corrupt / link spike) --------------------
    def _make_hook(self, token_faults: list[list]):
        sim = self.sim

        def hook(token: Token, latency: float) -> tuple[Optional[Token], float]:
            now = sim.kernel.now
            for state in token_faults:
                f = state[0]
                if isinstance(f, LinkSpike):
                    if (token.src_pid == f.src_pid
                            and token.dst_pid == f.dst_pid
                            and f.at_cycle <= now < f.at_cycle + f.duration):
                        if not state[2]:
                            state[2] = True
                            self.log.append(
                                (now, f"link-spike engaged on "
                                      f"{f.src_pid}->{f.dst_pid} "
                                      f"(+{f.extra_cycles:.0f} cycles)"))
                        latency += f.extra_cycles
                    continue
                if state[2] or token.src_pid != f.src_pid:
                    continue
                if f.bid is not None and token.bid != f.bid:
                    continue
                if f.kind != "any" and token.kind != f.kind:
                    continue
                state[1] += 1
                if state[1] < f.nth:
                    continue
                state[2] = True  # one-shot within this run
                if isinstance(f, TokenDrop):
                    self.log.append((now, f"token-drop engaged: lost {token!r}"))
                    return None, latency
                bad_bid = (token.bid + f.bid_offset) % _BID_SPACE
                self.log.append(
                    (now, f"token-corrupt engaged: {token!r} "
                          f"BID rewritten to {bad_bid}"))
                token = replace(token, bid=bad_bid)
            return token, latency

        return hook
