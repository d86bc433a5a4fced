"""Defect-injection harness cross-validating the verifier vs the simulator.

Each mutator clones a compiled program bundle and plants one realistic
compiler bug — the classes the static analyzer claims to catch:

* :func:`drop_send_ack`  — a consumer stops acknowledging one tensor's
  reads; the producer's ACK credits run dry and the pipeline deadlocks.
* :func:`swap_bids`      — two WAIT instructions trade channels (the
  classic BID-allocation off-by-one); nobody sends on the waited channels.
* :func:`shrink_region`  — a ping-pong tensor's AddrCyc strides collapse
  to 0; producer round N overwrites the bytes consumer round N-1 reads.
* :func:`overflow_field` — a GEMM's M dimension exceeds its 12-bit field;
  hardware would silently truncate and execute a different GEMM.
* :func:`hijack_channel` — one member's store is redirected onto another
  member's HBM channel and address range (multi-tenant isolation breach).

The ``confirm_*`` helpers demonstrate the same defect *dynamically* with
verification bypassed: deadlock via the discrete-event simulator, data
corruption via the runtime transfer-overlap detector over the simulator's
trace (:func:`runtime_hazards`), and field truncation via the timing
divergence between the intended and the truncated instruction image.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..compiler.memory import MemoryPlan
from ..core.isa import AddrCyc, Compute, DataMove, Opcode, Sync
from ..core.program import PUProgram
from ..core.pu import PUSpec
from ..core.simulator import MultiPUSimulator, SimResult
from .report import VerifyReport
from . import verify_programs


@dataclass
class Mutation:
    """A mutated program bundle plus where the defect was planted."""

    name: str
    programs: list[PUProgram]
    detail: str


def _clone(programs: list[PUProgram]) -> list[PUProgram]:
    return [p.clone() for p in programs]


# ---------------------------------------------------------------- mutators --
def drop_send_ack(programs: list[PUProgram]) -> Mutation:
    """Remove the first loop-body SEND_ACK of some LD program."""
    muts = _clone(programs)
    for pu in muts:
        icu_ba = pu.ld.progctrl.icu_ba
        for idx in range(icu_ba, len(pu.ld.instructions)):
            inst = pu.ld.instructions[idx]
            if isinstance(inst, Sync) and inst.op is Opcode.SEND_ACK:
                del pu.ld.instructions[idx]
                return Mutation(
                    "drop_send_ack", muts,
                    f"removed SEND_ACK(dst=pu{inst.pid}, bid={inst.bid}) "
                    f"at pu{pu.pid}.LD[{idx}]")
    raise ValueError("no loop-body SEND_ACK found to drop")


def swap_bids(programs: list[PUProgram]) -> Mutation:
    """Swap the channel state of the first two distinct WAIT instructions."""
    muts = _clone(programs)
    waits: list[tuple[int, str, Sync]] = []
    for pu in muts:
        for gname, prog in (("LD", pu.ld), ("CP", pu.cp), ("ST", pu.st)):
            for inst in prog.instructions:
                if isinstance(inst, Sync) and not inst.is_send:
                    waits.append((pu.pid, gname, inst))
    for i in range(len(waits)):
        for j in range(i + 1, len(waits)):
            a, b = waits[i][2], waits[j][2]
            # The BID state itself must differ — swapping two waits that
            # happen to cover the same range (a multi-consumer fork) is a
            # no-op, not a defect.
            if (a.base_bid, a.bid, a.nc) != (b.base_bid, b.bid, b.nc):
                fields = ("bid", "base_bid", "nc", "ic")
                for f in fields:
                    va, vb = getattr(a, f), getattr(b, f)
                    setattr(a, f, vb)
                    setattr(b, f, va)
                return Mutation(
                    "swap_bids", muts,
                    f"swapped channels of {a.op.name}@pu{waits[i][0]}."
                    f"{waits[i][1]} and {b.op.name}@pu{waits[j][0]}."
                    f"{waits[j][1]}")
    raise ValueError("no two distinct WAIT instructions found to swap")


def shrink_region(programs: list[PUProgram], mem: MemoryPlan,
                  tid: Optional[int] = None) -> Mutation:
    """Collapse the region stride of a multi-region intermediate tensor on
    both its write and read sides (AOFFS := 0): all rounds then alias
    region 0, defeating the ping-pong. ``tid`` picks the tensor (default:
    first eligible). Whether the aliasing *manifests* at runtime depends on
    whether the producer ever runs a round ahead — iterate eligible tids to
    find one whose corruption the trace exhibits."""
    muts = _clone(programs)
    for plan in sorted(mem.tensors.values(), key=lambda p: p.tid):
        if plan.kind != "intermediate" or plan.beta <= 1:
            continue
        if tid is not None and plan.tid != tid:
            continue
        hit = 0
        for pu in muts:
            for prog in (pu.ld, pu.cp, pu.st):
                for inst in prog.instructions:
                    if isinstance(inst, AddrCyc) and inst.ba == plan.base_addr:
                        inst.aoffs = 0
                        hit += 1
        if hit:
            return Mutation(
                "shrink_region", muts,
                f"zeroed AOFFS of {hit} AddrCyc(s) over tensor {plan.tid} "
                f"(beta={plan.beta})")
    raise ValueError("no multi-region intermediate tensor found")


def overflow_field(programs: list[PUProgram]) -> tuple[Mutation, list[PUProgram]]:
    """Overflow the first GEMM's 12-bit M field. Returns the *intended*
    mutated bundle plus the *truncated* bundle — what hardware actually
    executes after the field wraps — so the two can be compared in
    simulation (they compute different GEMMs)."""
    muts = _clone(programs)
    for pu in muts:
        for inst in pu.cp.instructions:
            if isinstance(inst, Compute):
                inst.m += 1 << 12
                truncated = _clone(muts)
                for tpu in truncated:
                    for tinst in tpu.cp.instructions:
                        if isinstance(tinst, Compute):
                            tinst.m &= (1 << 12) - 1
                return (
                    Mutation("overflow_field", muts,
                             f"GEMM M={inst.m} exceeds 12 bits at "
                             f"pu{pu.pid}.CP"),
                    truncated,
                )
    raise ValueError("no Compute instruction found")


def hijack_channel(member_programs: list[list[PUProgram]]
                   ) -> tuple[list[list[PUProgram]], str]:
    """Redirect the second member's first store onto the first member's
    store channel *and* address range — the isolation breach a buggy
    resource partitioner would produce. Returns the mutated per-member
    bundles (member 0 untouched)."""
    if len(member_programs) < 2:
        raise ValueError("need at least two members")
    target: Optional[DataMove] = None
    for pu in member_programs[0]:
        for inst in pu.st.instructions:
            if isinstance(inst, DataMove):
                target = inst
                break
        if target:
            break
    if target is None:
        raise ValueError("member 0 has no store DataMove")
    muts = [member_programs[0]] + [_clone(ps) for ps in member_programs[1:]]
    for pu in muts[1]:
        for idx, inst in enumerate(pu.st.instructions):
            if isinstance(inst, DataMove):
                inst.channel = target.channel
                inst.cur_ba = target.cur_ba
                nxt = (pu.st.instructions[idx + 1]
                       if idx + 1 < len(pu.st.instructions) else None)
                if isinstance(nxt, AddrCyc):
                    nxt.ba = target.cur_ba
                return muts, (
                    f"member 1 pu{pu.pid}.ST[{idx}] redirected onto member "
                    f"0's channel {target.channel} @0x{target.cur_ba:x}")
    raise ValueError("member 1 has no store DataMove")


# ------------------------------------------------- dynamic confirmation ----
def verify_mutation(mut: Mutation, *, mem: Optional[MemoryPlan] = None,
                    pu_specs: Optional[dict[int, PUSpec]] = None
                    ) -> VerifyReport:
    """Run the full static verifier over a mutated bundle."""
    return verify_programs(mut.programs, mem=mem, pu_specs=pu_specs,
                           member=mut.name)


def simulate_raw(programs: list[PUProgram],
                 pus: Optional[list[PUSpec]] = None, *,
                 trace: bool = False,
                 until_cycles: float = float("inf"),
                 ) -> tuple[SimResult, list]:
    """Simulate with verification bypassed; returns (result, kernel trace).

    A deadlocked bundle simply drains the event heap — every ICU decoder
    parks on a WAIT with no wake-up pending — so ``SimResult.deadlocked``
    is exact, no event-count horizon needed."""
    sim = MultiPUSimulator(pus, trace=trace)
    res = sim.run(programs, until_cycles=until_cycles)
    return res, list(sim.kernel.trace)


def _trace_xfers(trace: list):
    xfers = []
    for t0, who, what in trace:
        if not (isinstance(what, tuple) and what and what[0] == "xfer"):
            continue
        _, mode, channel, addr, nbytes, t_end = what
        pid = int(who.split(".")[0][2:])
        xfers.append((t0, t_end, mode, channel, addr, addr + nbytes, pid, who))
    return xfers


def runtime_hazards(trace: list, *,
                    member_of: Optional[dict[int, int]] = None) -> list[str]:
    """Concurrent-overlap detector over the simulator's transfer trace.

    Same-member hazards need *temporal* + byte overlap with a writer on one
    side and a different PU on the other (same-PU pairs are excluded: the
    intra-PU write->read stream is tile-interlocked by design, with the
    same-PU SEND_REQ intentionally emitted before the store). Cross-member
    pairs (``member_of``: pid -> member index) are corruption on byte +
    channel overlap *alone* — one tenant's bytes in another's region is a
    breach regardless of timing (and the per-channel port serializes
    transfers, so requiring temporal overlap there would mask it)."""
    xfers = _trace_xfers(trace)
    hazards = []
    for i in range(len(xfers)):
        s0, e0, m0, c0, lo0, hi0, p0, w0 = xfers[i]
        for j in range(i + 1, len(xfers)):
            s1, e1, m1, c1, lo1, hi1, p1, w1 = xfers[j]
            if p0 == p1 or "w" not in (m0, m1):
                continue
            if not (lo0 < hi1 and lo1 < hi0):
                continue
            cross = (member_of is not None
                     and member_of.get(p0) != member_of.get(p1))
            if cross:
                if c0 != c1:
                    continue  # isolated channels: no physical conflict
            elif not (s0 < e1 and s1 < e0):
                continue  # same member: needs true temporal overlap
            hazards.append(
                f"{w0} {m0} [0x{lo0:x},0x{hi0:x})@[{s0:.0f},{e0:.0f}) vs "
                f"{w1} {m1} [0x{lo1:x},0x{hi1:x})@[{s1:.0f},{e1:.0f})")
    return hazards


def stale_reads(trace: list) -> list[str]:
    """Handshake-order corruption detector over the transfer trace.

    For every (byte range, writer PU, reader PU) stream pair, the k-th read
    of a range must complete before the (k+1)-th write rewrites it — the
    ping-pong ACK discipline guarantees exactly this. A violation means the
    reader observed round k+1 bytes (or a torn mix) where round k data was
    expected: the data corruption a shrunken/aliased region produces, even
    when the per-channel port serializes the transfers themselves."""
    xfers = _trace_xfers(trace)
    groups: dict[tuple, dict[str, list]] = {}
    for s, e, mode, _ch, lo, hi, pid, _who in xfers:
        groups.setdefault((lo, hi), {}).setdefault(mode, []).append((s, e, pid))
    out = []
    for (lo, hi), by_mode in groups.items():
        writes = sorted(by_mode.get("w", []))
        reads = sorted(by_mode.get("r", []))
        if not writes or not reads:
            continue
        if {p for _, _, p in writes} & {p for _, _, p in reads}:
            continue  # same-PU streaming pairs are interlocked by design
        for k, (rs, re, rpid) in enumerate(reads):
            if k + 1 < len(writes):
                ws, we, wpid = writes[k + 1]
                if ws < re:
                    out.append(
                        f"range [0x{lo:x},0x{hi:x}): write #{k + 1} by "
                        f"pu{wpid} starts at {ws:.0f} before read #{k} by "
                        f"pu{rpid} ends at {re:.0f} (stale/torn read)")
    return out
