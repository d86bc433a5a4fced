"""Sync-token flow checker: static deadlock-freedom for program bundles.

Abstracts every PU's LD/CP/ST instruction streams to their *sync skeleton*
— SEND/WAIT REQ/ACK per ``(pid, bid)`` channel (with BID cycling and the
ACK-bypass prologue), the intra-PU buffer interlocks (activation ping-pong
slots between LD and CP, output slots between CP and ST), and the URAM
weight-chunk interlock — then proves the bundle runs to completion without
simulating a single timed cycle:

1. **Abstract execution.** Token production/consumption is a Petri net in
   which every place (LUTRAM entry, buffer slot) has exactly one consumer
   stream (the ISA's group-legality table guarantees this: WAIT_REQ only in
   LD, WAIT_ACK only in ST, GEMM only in CP), so greedy maximal firing is
   confluent — if the greedy run finishes all rounds, *every* hardware
   interleaving does; if it stalls, every interleaving stalls at the same
   marking. Timing cannot change reachability, only ordering.
2. **Stall triage.** On a stall the checker builds the cross-PU wait-for
   graph (blocked stream -> streams able to produce what it awaits), finds
   cycles (deadlock: reported with the exact instruction index of every
   participant) and dead waits (starvation: no live producer remains).
3. **Per-round token balance.** Independently of execution, the per-round
   send and wait *rates* of every ``(dst, kind, src, bid)`` channel are
   compared as exact fractions (a BID-cycling sync instruction touches each
   bid in its range once per ``NC+1`` rounds; prologue sends are one-shot
   credits, not rates) — mismatches mean tokens leak (accumulate without
   bound) or starve (the one-shot credits run out mid-window).
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Iterable, Optional

from ..core.isa import Compute, DataMove, Group, Opcode, Sync, effective_opcode
from ..core.program import Program, PUProgram
from ..core.pu import PUSpec
from .report import Code, Severity, VerifyReport

#: Abstract-execution round cap: bounds work on huge decode windows while
#: staying far above every compiled loop count we emit (NR is 24 bits, but
#: real deployments run 16..decode_steps rounds).
ROUND_CAP = 1024

_WEIGHT_OPS = frozenset({Opcode.WEIGHTS_ADM})


def _sync_bids(inst: Sync) -> range:
    """The BID set a cycling sync instruction touches across rounds."""
    if inst.nc == 0:
        return range(inst.bid, inst.bid + 1)
    return range(inst.base_bid, inst.base_bid + inst.nc + 1)


@dataclass
class _Blocked:
    """Why a stream cannot advance: a token channel, a buffer slot, or the
    URAM weight interlock."""

    what: str  # "token" | "buf" | "wchunk"
    kind: str = ""  # token: "req"/"ack"; buf: semaphore name
    src_pid: int = -1
    bid: int = -1

    def describe(self, pid: int) -> str:
        if self.what == "token":
            return (f"WAIT_{self.kind.upper()} on channel "
                    f"(src_pid={self.src_pid}, bid={self.bid})")
        if self.what == "buf":
            return f"buffer slot {self.kind!r} of pu{pid}"
        return "URAM weight-chunk interlock"


class _PUState:
    """Abstract per-PU coordination state (counters, no data)."""

    def __init__(self, act_slots: int, out_slots: int) -> None:
        self.act_free = act_slots
        self.act_full = 0
        self.out_free = out_slots
        self.out_full = 0
        # (kind, src_pid, bid) -> outstanding token count
        self.lutram: dict[tuple[str, int, int], int] = {}
        self.weights_issued = 0

    def tokens(self, kind: str, src_pid: int, bid: int) -> int:
        return self.lutram.get((kind, src_pid, bid), 0)

    def take(self, kind: str, src_pid: int, bid: int) -> None:
        self.lutram[(kind, src_pid, bid)] -= 1

    def put(self, kind: str, src_pid: int, bid: int) -> None:
        key = (kind, src_pid, bid)
        self.lutram[key] = self.lutram.get(key, 0) + 1


class _Stream:
    """One ICU group's program, abstractly executed over its rounds."""

    def __init__(self, pid: int, group: Group, prog: Program) -> None:
        self.pid = pid
        self.group = group
        self.insts = prog.instructions
        ctrl = prog.progctrl
        self.nr = ctrl.nr
        self.icu_ba = ctrl.icu_ba
        self.pc = 0
        self.rounds_done = 0
        self.done = not self.insts
        self.capped = False
        self.blocked: Optional[_Blocked] = None
        self.gemm_wtarget = 0
        self.st_holding = False  # out slot held across a broadcast store

    @property
    def name(self) -> str:
        return f"pu{self.pid}.{self.group.value}"

    def round_limit(self) -> int:
        return min(self.nr, ROUND_CAP) if self.nr else ROUND_CAP

    def try_step(self, me: _PUState, world: dict[int, _PUState]) -> bool:
        """Fire one instruction if its abstract preconditions hold."""
        inst = self.insts[self.pc]

        if isinstance(inst, Sync):
            if inst.is_send:
                dst = world.get(inst.pid)
                if dst is not None:
                    dst.put(inst.kind, self.pid, inst.bid)
                inst.step()
            else:
                if me.tokens(inst.kind, inst.pid, inst.bid) <= 0:
                    self.blocked = _Blocked("token", inst.kind, inst.pid,
                                            inst.bid)
                    return False
                me.take(inst.kind, inst.pid, inst.bid)
                inst.step()

        elif isinstance(inst, DataMove):
            if self.group is Group.LD:
                if me.act_free <= 0:
                    self.blocked = _Blocked("buf", "act_free")
                    return False
                me.act_free -= 1
                me.act_full += 1
            elif self.group is Group.ST:
                # Broadcast stores (DataMove.hold): the node's first
                # transfer drains the slot, held transfers re-read it, and
                # only the final transfer (hold=0) frees it.
                if not self.st_holding:
                    if me.out_full <= 0:
                        self.blocked = _Blocked("buf", "out_full")
                        return False
                    me.out_full -= 1
                self.st_holding = inst.hold
                if not self.st_holding:
                    me.out_free += 1
            else:  # CP: async engines; issue completes in program order
                if effective_opcode(inst) in _WEIGHT_OPS:
                    me.weights_issued += 1

        elif isinstance(inst, Compute):
            self.gemm_wtarget += inst.wchunks
            if me.weights_issued < self.gemm_wtarget:
                self.gemm_wtarget -= inst.wchunks  # retry re-adds
                self.blocked = _Blocked("wchunk")
                return False
            if me.act_full <= 0:
                self.gemm_wtarget -= inst.wchunks
                self.blocked = _Blocked("buf", "act_full")
                return False
            if me.out_free <= 0:
                self.gemm_wtarget -= inst.wchunks
                self.blocked = _Blocked("buf", "out_free")
                return False
            me.act_full -= 1
            me.act_free += 1
            me.out_free -= 1
            me.out_full += 1

        # ProgCtrl / Config / AddrCyc / AddrLen: no coordination effect.

        self.blocked = None
        if inst.prg_end:
            self.rounds_done += 1
            if self.rounds_done >= self.round_limit():
                self.done = True
                self.capped = self.nr == 0 or self.rounds_done < self.nr
            else:
                self.pc = self.icu_ba
        else:
            self.pc += 1
        return True


def _build_streams(programs: Iterable[PUProgram]) -> list[_Stream]:
    streams = []
    for pu in programs:
        clone = pu.clone()  # abstract execution mutates Sync BID state
        for group, prog in ((Group.LD, clone.ld), (Group.CP, clone.cp),
                            (Group.ST, clone.st)):
            streams.append(_Stream(pu.pid, group, prog))
    return streams


def _providers(stream: _Stream, streams: list[_Stream]) -> list[_Stream]:
    """Streams whose remaining execution could unblock ``stream``."""
    b = stream.blocked
    assert b is not None
    out = []
    if b.what == "token":
        send_op = Opcode.SEND_REQ if b.kind == "req" else Opcode.SEND_ACK
        for t in streams:
            if t.pid != b.src_pid or t.done:
                continue
            for idx, inst in enumerate(t.insts):
                # A one-shot prologue send (index < ICU_BA) only counts if
                # it has not fired yet; body sends re-run every round.
                reachable = (idx >= t.icu_ba
                             or (t.rounds_done == 0 and t.pc <= idx))
                if (reachable and isinstance(inst, Sync)
                        and inst.op is send_op
                        and inst.pid == stream.pid
                        and b.bid in _sync_bids(inst)):
                    out.append(t)
                    break
    elif b.what == "buf":
        group = {"act_free": Group.CP, "act_full": Group.LD,
                 "out_free": Group.ST, "out_full": Group.CP}[b.kind]
        for t in streams:
            if t.pid == stream.pid and t.group is group and not t.done:
                out.append(t)
    else:  # wchunk: only this PU's own CP stream issues WEIGHTS_ADM — and
        # that is the blocked stream itself, so the interlock is dead.
        pass
    return out


def _find_cycles(blocked: list[_Stream],
                 edges: dict[int, list[int]]) -> list[list[int]]:
    """Cycles in the wait-for graph (one representative per node set)."""
    cycles: list[list[int]] = []
    seen_sets: set[frozenset[int]] = set()
    state: dict[int, int] = {}  # 0 unvisited / 1 on stack / 2 done

    def dfs(v: int, stack: list[int]) -> None:
        state[v] = 1
        stack.append(v)
        for w in edges.get(v, ()):
            if state.get(w, 0) == 0:
                dfs(w, stack)
            elif state.get(w) == 1:
                cyc = stack[stack.index(w):]
                key = frozenset(cyc)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(list(cyc))
        stack.pop()
        state[v] = 2

    for s in blocked:
        if state.get(id(s), 0) == 0:
            dfs(id(s), [])
    return cycles


def check_token_flow(programs: list[PUProgram], *,
                     pu_specs: Optional[dict[int, PUSpec]] = None,
                     member: str = "",
                     report: Optional[VerifyReport] = None) -> VerifyReport:
    """Abstract execution + stall triage over one program bundle."""
    rep = report if report is not None else VerifyReport(label=member)
    streams = _build_streams(programs)
    world: dict[int, _PUState] = {}
    for pu in programs:
        spec = (pu_specs or {}).get(pu.pid)
        world[pu.pid] = _PUState(spec.act_buf_slots if spec else 2,
                                 spec.out_buf_slots if spec else 2)

    # Greedy maximal firing: keep sweeping until no stream can advance.
    fuel = 4_000_000
    progress = True
    while progress and fuel > 0:
        progress = False
        for s in streams:
            me = world[s.pid]
            while not s.done and fuel > 0 and s.try_step(me, world):
                progress = True
                fuel -= 1
    if fuel <= 0:  # pragma: no cover - ROUND_CAP bounds total work
        rep.add(Code.SYNC_STALL, "abstract execution exceeded its fuel budget",
                severity=Severity.WARNING, member=member)
        return rep

    if any(s.capped for s in streams):
        rep.add(Code.SYNC_STALL,
                f"round count capped at {ROUND_CAP} for abstract execution",
                severity=Severity.INFO, member=member)

    blocked = [s for s in streams if not s.done]
    if not blocked:
        return rep

    by_id = {id(s): s for s in streams}
    edges = {id(s): [id(t) for t in _providers(s, streams)] for s in blocked}

    cycles = _find_cycles(blocked, edges)
    in_cycle: set[int] = set()
    for cyc in cycles:
        in_cycle.update(cyc)
        parts = []
        for sid in cyc:
            s = by_id[sid]
            parts.append(f"{s.name}[{s.pc}] awaits "
                         f"{s.blocked.describe(s.pid)}")
        rep.add(Code.SYNC_DEADLOCK,
                "wait-for cycle: " + " -> ".join(parts),
                member=member, pid=by_id[cyc[0]].pid,
                group=by_id[cyc[0]].group.value, index=by_id[cyc[0]].pc)

    for s in blocked:
        if id(s) in in_cycle:
            continue
        live = [by_id[w] for w in edges[id(s)] if not by_id[w].done]
        code = Code.SYNC_WCHUNK if s.blocked.what == "wchunk" else Code.SYNC_STALL
        if not live:
            rep.add(code,
                    f"{s.name}[{s.pc}] starved: awaits "
                    f"{s.blocked.describe(s.pid)} with no live producer "
                    f"(round {s.rounds_done + 1}/{s.round_limit()})",
                    member=member, pid=s.pid, group=s.group.value, index=s.pc)
        else:
            rep.add(Code.SYNC_STALL,
                    f"{s.name}[{s.pc}] blocked on "
                    f"{s.blocked.describe(s.pid)} behind "
                    + ", ".join(t.name for t in live),
                    severity=(Severity.INFO if cycles else Severity.ERROR),
                    member=member, pid=s.pid, group=s.group.value, index=s.pc)
    return rep


def check_token_balance(programs: list[PUProgram], *, member: str = "",
                        report: Optional[VerifyReport] = None) -> VerifyReport:
    """Exact per-round send/wait rate comparison per token channel."""
    rep = report if report is not None else VerifyReport(label=member)
    pids = {pu.pid for pu in programs}
    send_rate: dict[tuple, Fraction] = {}
    wait_rate: dict[tuple, Fraction] = {}
    credits: dict[tuple, int] = {}
    where: dict[tuple, tuple] = {}  # channel -> (pid, group, index) sample

    for pu in programs:
        for group, prog in ((Group.LD, pu.ld), (Group.CP, pu.cp),
                            (Group.ST, pu.st)):
            try:
                icu_ba = prog.progctrl.icu_ba
            except ValueError:
                continue
            for idx, inst in enumerate(prog.instructions):
                if not isinstance(inst, Sync):
                    continue
                per_bid = Fraction(1, 1 if inst.nc == 0 else inst.nc + 1)
                for b in _sync_bids(inst):
                    if inst.is_send:
                        key = (inst.pid, inst.kind, pu.pid, b)
                        if idx < icu_ba:  # one-shot prologue credit
                            credits[key] = credits.get(key, 0) + 1
                        else:
                            send_rate[key] = send_rate.get(key, 0) + per_bid
                    else:
                        key = (pu.pid, inst.kind, inst.pid, b)
                        wait_rate[key] = wait_rate.get(key, 0) + per_bid
                    where.setdefault(key, (pu.pid, group.value, idx))

    for key in sorted(set(send_rate) | set(wait_rate)):
        dst, kind, src, bid = key
        sends = send_rate.get(key, Fraction(0))
        waits = wait_rate.get(key, Fraction(0))
        if src not in pids or dst not in pids:
            # Half of the channel lives outside this bundle (partial
            # verification of a member slice) — rate comparison is moot.
            continue
        pid, group, idx = where[key]
        chan = f"(dst=pu{dst}, {kind}, src=pu{src}, bid={bid})"
        if waits and sends < waits:
            rep.add(Code.SYNC_TOKEN_STARVE,
                    f"channel {chan}: per-round sends {sends} < waits {waits}"
                    + (f" ({credits[key]} one-shot prologue credit(s) delay"
                       " the stall, they cannot prevent it)"
                       if key in credits else ""),
                    member=member, pid=pid, group=group, index=idx)
        elif waits and sends > waits:
            rep.add(Code.SYNC_TOKEN_LEAK,
                    f"channel {chan}: per-round sends {sends} > waits "
                    f"{waits} — tokens accumulate without bound",
                    member=member, pid=pid, group=group, index=idx)
        elif not waits and sends:
            # In this codegen every recurring token stream throttles a
            # peer; one nobody waits on means that throttle was removed
            # (e.g. a dropped WAIT_ACK in a multi-consumer fork, where the
            # store still looks guarded but one consumer no longer gates
            # the producer) — an error, not an oddity.
            rep.add(Code.SYNC_TOKEN_LEAK,
                    f"channel {chan}: sent at rate {sends} but never waited "
                    "on — the peer this stream throttled is no longer gated",
                    member=member, pid=pid, group=group, index=idx)
    return rep


def check_wchunk_interlock(programs: list[PUProgram], *, member: str = "",
                           report: Optional[VerifyReport] = None
                           ) -> VerifyReport:
    """The URAM read interlock must be satisfiable from *earlier* issues:
    at every GEMM the cumulative ``wchunks`` demand cannot exceed the
    WEIGHTS_ADM transfers already issued in program order (the CP stream is
    sequential, so later issues can never rescue an earlier blocked GEMM)."""
    rep = report if report is not None else VerifyReport(label=member)
    for pu in programs:
        issued = 0
        target = 0
        for idx, inst in enumerate(pu.cp.instructions):
            if isinstance(inst, DataMove) and effective_opcode(inst) in _WEIGHT_OPS:
                issued += 1
            elif isinstance(inst, Compute):
                target += inst.wchunks
                if target > issued:
                    rep.add(Code.SYNC_WCHUNK,
                            f"GEMM requires {target} cumulative weight "
                            f"chunk(s) but only {issued} WEIGHTS_ADM issued "
                            "before it",
                            member=member, pid=pu.pid, group="CP", index=idx)
    return rep
