"""Instruction Controller Unit (paper Sec. III-B, Fig. 2(d)).

Each PU's ICU holds three independent dual-port BRAMs (LD / CP / ST programs)
with a dedicated decoder FSM per group — memory access is decoupled from
compute, enabling overlapped pipelining inside the PU.

Coordination state lives in the REQ and ACK LUTRAMs, addressed by
(SRC_PID, BID). Incoming ISU tokens set entries; WAIT_* instructions act as
barriers polling an entry, then clear it. SEND_* instructions push tokens into
the local ISU through a small FIFO so the decoder never blocks on the fabric.

Intra-PU dataflow interlocks (all hardware-implicit, modeled with counting
semaphores):

  LD  --(act ping-pong BRAM slots)-->  CP  --(output buffer slots)-->  ST
  WEIGHTS_ADM / RES_ADD_ADM are issued asynchronously (the ADM engines run
  independently); a GEMM blocks until its ``wchunks`` weight chunks and any
  preceding residual transfers have landed (URAM/BRAM read interlock).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .events import Acquire, Delay, Kernel, Release, Semaphore, WaitCond
from .isa import (
    AddrCyc,
    AddrLen,
    Compute,
    Config,
    DataMove,
    Group,
    Opcode,
    ProgCtrl,
    Sync,
    effective_opcode,
)
from .isu import ISUNetwork, Token
from .program import Program, PUProgram
from .pu import PUSpec

DECODE_CYCLES = 1  # instruction issue overhead (sys_clk)


@dataclass
class GroupStats:
    busy: float = 0.0  # cycles in ADM transfers / GEMM execution
    sync_wait: float = 0.0  # cycles blocked in WAIT_REQ/WAIT_ACK
    buffer_wait: float = 0.0  # cycles blocked on intra-PU buffer slots
    rounds_done: int = 0
    round_start_times: list[float] = field(default_factory=list)
    round_end_times: list[float] = field(default_factory=list)
    instructions: int = 0
    halted_at: Optional[float] = None


class ICU:
    """Per-PU instruction controller: three decoder processes + LUTRAMs."""

    def __init__(
        self,
        kernel: Kernel,
        spec: PUSpec,
        isu: ISUNetwork,
        hbm_channels: dict[int, Semaphore],
    ) -> None:
        self.kernel = kernel
        self.spec = spec
        self.isu = isu
        self.hbm_channels = hbm_channels

        # REQ/ACK LUTRAMs: (src_pid, bid) -> outstanding token count.
        self.req_lutram: dict[tuple[int, int], int] = {}
        self.ack_lutram: dict[tuple[int, int], int] = {}

        # Intra-PU buffer interlocks.
        self.act_free = kernel.semaphore(spec.act_buf_slots, f"pu{spec.pid}.act_free")
        self.act_full = kernel.semaphore(0, f"pu{spec.pid}.act_full")
        self.out_free = kernel.semaphore(spec.out_buf_slots, f"pu{spec.pid}.out_free")
        self.out_full = kernel.semaphore(0, f"pu{spec.pid}.out_full")

        # Async ADM completion counters (weights / residual streams).
        self.weights_done = 0
        self.res_issued = 0
        self.res_done = 0
        # Expected stream-completion times of in-flight LD transfers, one
        # entry per filled act slot (FIFO pairing with GEMM consumption).
        self.ld_stream_ends: "deque[float]" = deque()

        self.stats: dict[Group, GroupStats] = {g: GroupStats() for g in Group}
        self.program: Optional[PUProgram] = None
        self.member = ""  # owning deployment member label (set by start)
        # Injected fault state (repro_torch.faults): when set, every decoder of
        # this PU parks forever once the clock reaches ``hang_at`` — the
        # model of a hardware PU that silently stops issuing instructions.
        self.hang_at: Optional[float] = None
        # pc of the instruction each decoder group is currently executing
        # (fault reports locate a stuck decoder down to the instruction).
        self.cur_index: dict[Group, int] = {}

    # -- token delivery (installed into ISUNetwork by the simulator) --------
    def deliver(self, token: Token) -> None:
        lut = self.req_lutram if token.kind == "req" else self.ack_lutram
        key = (token.src_pid, token.bid)
        lut[key] = lut.get(key, 0) + 1
        self.kernel.notify(("lut", self.spec.pid, token.kind, key))

    def preset_ack(self, src_pid: int, bid: int) -> None:
        """Host-side LUTRAM preset (used by tests; Fig. 3 instead uses the
        ACK-bypass prologue, which achieves the same effect in-band)."""
        key = (src_pid, bid)
        self.ack_lutram[key] = self.ack_lutram.get(key, 0) + 1

    # -- program start -------------------------------------------------------
    def start(self, program: PUProgram, member: str = "") -> None:
        self.program = program.clone()
        self.program.validate()
        self.member = member
        pid = self.spec.pid
        for group, prog in ((Group.LD, self.program.ld),
                            (Group.CP, self.program.cp),
                            (Group.ST, self.program.st)):
            self.kernel.spawn(self._decoder(group, prog),
                              name=f"pu{pid}.{group.name}", member=member)

    # -- decoder FSM ----------------------------------------------------------
    def _decoder(self, group: Group, prog: Program):
        st = self.stats[group]
        pc = 0
        rounds = 0
        weights_issued = 0  # monotone count of WEIGHTS_ADM issued by CP
        gemm_wtarget = 0  # cumulative weight chunks required by GEMMs so far
        st_holding = False  # ST holds an out slot across a broadcast store
        insts = prog.instructions

        at_round_start = True
        while True:
            if self.hang_at is not None and self.kernel.now >= self.hang_at:
                # Injected PU hang: the decoder stops issuing instructions
                # mid-round, silently — exactly what the watchdog must turn
                # into a structured FaultReport. The key is never notified
                # and the predicate never true, so the process parks forever.
                self.cur_index[group] = pc
                yield WaitCond(
                    ("fault", "hang", self.spec.pid, group.name),
                    pred=lambda: False,
                    desc=f"injected PU hang (pu{self.spec.pid} issues no "
                         "further instructions)",
                )
            inst = insts[pc]
            self.cur_index[group] = pc
            if at_round_start:
                st.round_start_times.append(self.kernel.now)
                at_round_start = False
            st.instructions += 1
            yield Delay(DECODE_CYCLES)
            op = effective_opcode(inst)

            if isinstance(inst, ProgCtrl):
                pass  # round bookkeeping handled at PRG_END below

            elif isinstance(inst, Config):
                pass  # context for the successor ADM; zero extra latency

            elif isinstance(inst, DataMove):
                if group is Group.CP:
                    # Async issue: the CP ADM engines run decoupled.
                    # length/channel snapshot at issue: a successor AddrCyc/
                    # AddrLen rewrites the BRAM fields for the *next* round
                    # and must not retroactively resize an in-flight transfer.
                    if op is Opcode.WEIGHTS_ADM:
                        weights_issued += 1
                        self.kernel.spawn(
                            self._async_adm(inst.length, inst.channel,
                                            kind="weights", addr=inst.cur_ba),
                            name=f"pu{self.spec.pid}.wadm",
                            member=self.member,
                        )
                    else:  # RES_ADD_* : residual shortcut stream
                        self.res_issued += 1
                        self.kernel.spawn(
                            self._async_adm(inst.length, inst.channel,
                                            kind="res", addr=inst.cur_ba),
                            name=f"pu{self.spec.pid}.radm",
                            member=self.member,
                        )
                elif group is Group.LD:
                    # Fill one input activation ping-pong slot, *streaming*:
                    # the slot is usable by the SA once the first tile lands
                    # (ld_stream_ends lets the GEMM rate-match the remainder).
                    t0 = self.kernel.now
                    yield Acquire(self.act_free)
                    st.buffer_wait += self.kernel.now - t0
                    chan = self.hbm_channels[inst.channel]
                    t0 = self.kernel.now
                    yield Acquire(chan)
                    st.buffer_wait += self.kernel.now - t0
                    total = self.spec.adm_sys_cycles(inst.length)
                    delta = min(total, self.spec.stream_tile_cycles(inst.length))
                    self.kernel.log(
                        f"pu{self.spec.pid}.LD",
                        ("xfer", "r", inst.channel, inst.cur_ba, inst.length,
                         self.kernel.now + total),
                    )
                    yield Delay(delta)
                    self.ld_stream_ends.append(self.kernel.now + (total - delta))
                    yield Release(self.act_full)
                    yield Delay(total - delta)
                    st.busy += total
                    yield Release(chan)
                else:  # ST: drain one output buffer slot.
                    # A broadcast store (multi-output node) re-reads the
                    # slot the node's first transfer acquired: HOLD keeps
                    # it, only the final transfer (hold=0) frees it.
                    if not st_holding:
                        t0 = self.kernel.now
                        yield Acquire(self.out_full)
                        st.buffer_wait += self.kernel.now - t0
                    yield from self._blocking_adm(inst, st)
                    st_holding = inst.hold
                    if not st_holding:
                        yield Release(self.out_free)

            elif isinstance(inst, AddrCyc):
                pred = insts[pc - 1]
                assert isinstance(pred, DataMove)
                pred.cur_ba = inst.step(pred.cur_ba)  # dynamic write-back

            elif isinstance(inst, AddrLen):
                # length-advance mode: the predecessor transfer grows per
                # round (append-only K/V region of autoregressive decode).
                pred = insts[pc - 1]
                assert isinstance(pred, DataMove)
                pred.length = inst.step(pred.length)

            elif isinstance(inst, Sync):
                if inst.is_send:
                    self.isu.send(
                        Token(self.spec.pid, inst.pid, inst.bid, inst.kind)
                    )
                else:
                    lut = self.req_lutram if inst.kind == "req" else self.ack_lutram
                    key = (inst.pid, inst.bid)
                    t0 = self.kernel.now
                    yield WaitCond(
                        ("lut", self.spec.pid, inst.kind, key),
                        pred=lambda lut=lut, key=key: lut.get(key, 0) > 0,
                        desc=(f"{op.name} on channel (src_pid={inst.pid}, "
                              f"bid={inst.bid})"),
                    )
                    lut[key] -= 1  # clear the entry, barrier passed
                    st.sync_wait += self.kernel.now - t0
                inst.step()  # BID cycling write-back (Table I(b))

            elif isinstance(inst, Compute):
                gemm_wtarget += inst.wchunks
                # URAM interlock: streamed weight chunks must have landed.
                t0 = self.kernel.now
                yield WaitCond(
                    ("weights", self.spec.pid),
                    pred=lambda t=gemm_wtarget: self.weights_done >= t,
                    desc=(f"URAM weight interlock ({gemm_wtarget} cumulative "
                          "chunk(s))"),
                )
                # Residual stream interlock.
                if inst.add_enable:
                    tgt = self.res_issued
                    yield WaitCond(
                        ("res", self.spec.pid),
                        pred=lambda t=tgt: self.res_done >= t,
                        desc=f"residual stream interlock ({tgt} transfer(s))",
                    )
                yield Acquire(self.act_full)  # consume one input slot
                yield Acquire(self.out_free)  # claim one output slot
                st.buffer_wait += self.kernel.now - t0
                dur = self.spec.gemm_sys_cycles(inst.m, inst.n, inst.k) * max(1, inst.rounds)
                # Rate-match a still-streaming input: the SA cannot finish
                # before the LD transfer delivers its last tile.
                if self.ld_stream_ends:
                    ld_end = self.ld_stream_ends.popleft()
                    dur = max(dur, ld_end - self.kernel.now)
                yield Delay(dur)
                st.busy += dur
                yield Release(self.act_free)
                yield Release(self.out_full)

            else:  # pragma: no cover
                raise TypeError(f"unhandled instruction {inst!r}")

            if inst.prg_end:
                rounds += 1
                st.rounds_done = rounds
                st.round_end_times.append(self.kernel.now)
                ctrl = prog.progctrl
                if ctrl.nr != 0 and rounds >= ctrl.nr:
                    st.halted_at = self.kernel.now
                    return
                pc = ctrl.icu_ba
                at_round_start = True
            else:
                pc += 1

    # -- ADM helpers ----------------------------------------------------------
    def _blocking_adm(self, inst: DataMove, st: GroupStats):
        chan = self.hbm_channels[inst.channel]
        t0 = self.kernel.now
        yield Acquire(chan)
        st.buffer_wait += self.kernel.now - t0
        dur = self.spec.adm_sys_cycles(inst.length)
        self.kernel.log(
            f"pu{self.spec.pid}.ST",
            ("xfer", "w", inst.channel, inst.cur_ba, inst.length,
             self.kernel.now + dur),
        )
        yield Delay(dur)
        st.busy += dur
        yield Release(chan)

    def _async_adm(self, length: int, channel: int, kind: str, addr: int = 0):
        chan = self.hbm_channels[channel]
        yield Acquire(chan)
        dur = self.spec.adm_sys_cycles(length)
        self.kernel.log(
            f"pu{self.spec.pid}.CP",
            ("xfer", "r", channel, addr, length, self.kernel.now + dur),
        )
        yield Delay(dur)
        yield Release(chan)
        if kind == "weights":
            self.weights_done += 1
            self.kernel.notify(("weights", self.spec.pid))
        else:
            self.res_done += 1
            self.kernel.notify(("res", self.spec.pid))
