"""Memory-hazard analyzer: static RAW/WAR and isolation checks.

Works on the compiled instruction streams *and* the memory plan that
produced them, so every DataMove can be mapped back to the
:class:`~repro_torch.compiler.memory.TensorPlan` whose region it touches:

* **Region bounds** — unrolling a DataMove's successor ``AddrCyc`` (address
  cycling) or ``AddrLen`` (append-only length growth) gives the exact HBM
  byte extent touched across a full window; it must stay inside the plan's
  allocated extent (``align(region_bytes) * n_regions``). This is what
  proves a K/V cache never overruns its ``kv_base_rows + decode window``
  allocation.
* **Ping-pong safety** — a multi-region tensor (``beta > 1``) must cycle
  over exactly ``beta`` regions with a stride covering the transfer length,
  otherwise producer-round N and consumer-round N-1 alias the same bytes
  (the RAW/WAR hazard the B-buffer scheme exists to prevent).
* **Handshake guards** — every ST write to a consumed tensor must be
  preceded by a ``WAIT_ACK`` over the plan's exact BID range and publish a
  matching ``SEND_REQ``; every LD read of a produced tensor must sit inside
  a ``WAIT_REQ`` / ``SEND_ACK`` pair. CP-side reads (weight streaming, the
  residual port, attention's second operand) are exempt by design: their
  ordering comes from the LD-held sync pair plus the URAM interlock.
* **Member isolation** — across deployment members, HBM *channels* are the
  isolation boundary (members share one address space by construction, each
  compiled with the same bump allocator base): any channel used by two
  members is an error, and an address overlap on such a channel with a
  write on either side is flagged as a concrete corruption witness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.isa import AddrCyc, AddrLen, DataMove, Group, Opcode, Sync, effective_opcode
from ..core.program import Program, PUProgram
from ..compiler.memory import MemoryPlan, TensorPlan
from .report import Code, Severity, VerifyReport


def _align(x: int, a: int = 4096) -> int:
    return (x + a - 1) // a * a


def _plan_extent(plan: TensorPlan) -> tuple[int, int]:
    """Allocated HBM byte range [lo, hi) — mirrors the bump allocator."""
    return plan.base_addr, plan.base_addr + _align(plan.region_bytes) * plan.n_regions


@dataclass
class _Access:
    """One DataMove's full byte extent over all its rounds."""

    mode: str  # "r" | "w"
    channel: int
    lo: int
    hi: int
    pid: int
    group: str
    index: int
    plan: Optional[TensorPlan]


def _succ_cycle(prog: Program, idx: int):
    nxt = prog.instructions[idx + 1] if idx + 1 < len(prog.instructions) else None
    return nxt if isinstance(nxt, (AddrCyc, AddrLen)) else None


def _extent(dm: DataMove, cyc) -> tuple[int, int]:
    """[lo, hi) bytes touched across the cycle (Table I(b) unrolled)."""
    if isinstance(cyc, AddrCyc):
        # addresses {ba + j*aoffs} for j in 0..nc, plus the latched start
        starts = [dm.cur_ba, cyc.ba, cyc.ba + cyc.nc * cyc.aoffs]
        return min(starts), max(starts) + dm.length
    if isinstance(cyc, AddrLen):
        # fixed address, growing length: max at len_base + nc*loffs
        max_len = max(dm.length, cyc.len_base + cyc.nc * cyc.loffs)
        return dm.cur_ba, dm.cur_ba + max_len
    return dm.cur_ba, dm.cur_ba + dm.length


def _find_plan(mem: MemoryPlan, addr: int) -> Optional[TensorPlan]:
    for plan in mem.tensors.values():
        lo, hi = _plan_extent(plan)
        if lo <= addr < hi:
            return plan
    return None


def _collect_accesses(programs: list[PUProgram],
                      mem: Optional[MemoryPlan]) -> list[_Access]:
    out = []
    for pu in programs:
        for group, prog in ((Group.LD, pu.ld), (Group.CP, pu.cp),
                            (Group.ST, pu.st)):
            for idx, inst in enumerate(prog.instructions):
                if not isinstance(inst, DataMove):
                    continue
                mode = "w" if group is Group.ST else "r"
                lo, hi = _extent(inst, _succ_cycle(prog, idx))
                plan = _find_plan(mem, lo) if mem is not None else None
                out.append(_Access(mode, inst.channel, lo, hi, pu.pid,
                                   group.value, idx, plan))
    return out


_SCRATCH_LIMIT = 0x0100_0000  # below the bump allocator: weight/host scratch


def check_region_bounds(programs: list[PUProgram], mem: MemoryPlan, *,
                        member: str = "",
                        report: Optional[VerifyReport] = None) -> VerifyReport:
    """AddrCyc/AddrLen unrolled extents stay inside their plan; cyclic
    multi-region access really cycles ``beta`` disjoint regions."""
    rep = report if report is not None else VerifyReport(label=member)

    # Plans must tile disjoint HBM ranges (bump-allocator invariant).
    spans = sorted((_plan_extent(p) + (p.tid,)) for p in mem.tensors.values())
    for (lo1, hi1, t1), (lo2, hi2, t2) in zip(spans, spans[1:]):
        if lo2 < hi1:
            rep.add(Code.HAZ_REGION_OVERRUN,
                    f"tensor plans {t1} and {t2} overlap in HBM "
                    f"([0x{lo1:x},0x{hi1:x}) vs [0x{lo2:x},0x{hi2:x}))",
                    member=member)

    for acc in _collect_accesses(programs, mem):
        if acc.plan is None:
            if acc.lo < _SCRATCH_LIMIT:
                continue  # weight-chunk streaming from low scratch space
            rep.add(Code.HAZ_REGION_OVERRUN,
                    f"transfer [0x{acc.lo:x},0x{acc.hi:x}) targets no "
                    "planned region",
                    severity=Severity.WARNING, member=member, pid=acc.pid,
                    group=acc.group, index=acc.index)
            continue
        lo, hi = _plan_extent(acc.plan)
        if acc.lo < lo or acc.hi > hi:
            rep.add(Code.HAZ_REGION_OVERRUN,
                    f"transfer extent [0x{acc.lo:x},0x{acc.hi:x}) overruns "
                    f"tensor {acc.plan.tid} plan [0x{lo:x},0x{hi:x}) "
                    f"(kind={acc.plan.kind}, beta={acc.plan.beta})",
                    member=member, pid=acc.pid, group=acc.group,
                    index=acc.index)

    # Ping-pong discipline on multi-region plans.
    for pu in programs:
        for group, prog in ((Group.LD, pu.ld), (Group.CP, pu.cp),
                            (Group.ST, pu.st)):
            for idx, inst in enumerate(prog.instructions):
                if not isinstance(inst, DataMove):
                    continue
                cyc = _succ_cycle(prog, idx)
                if not isinstance(cyc, AddrCyc):
                    continue
                plan = _find_plan(mem, cyc.ba)
                if plan is None or plan.n_regions <= 1:
                    continue
                if cyc.nc + 1 != plan.beta:
                    rep.add(Code.HAZ_PINGPONG,
                            f"tensor {plan.tid}: AddrCyc cycles {cyc.nc + 1} "
                            f"region(s) but the plan ping-pongs over "
                            f"beta={plan.beta}",
                            member=member, pid=pu.pid, group=group.value,
                            index=idx)
                if cyc.nc > 0 and cyc.aoffs < inst.length:
                    rep.add(Code.HAZ_PINGPONG,
                            f"tensor {plan.tid}: region stride AOFFS="
                            f"{cyc.aoffs} is smaller than the "
                            f"{inst.length}-byte transfer — adjacent "
                            "ping-pong regions alias (RAW/WAR hazard)",
                            member=member, pid=pu.pid, group=group.value,
                            index=idx)
    return rep


def _bid_range(plan: TensorPlan) -> set[int]:
    return set(range(plan.bid_base, plan.bid_base + plan.beta))


def _sync_bid_set(inst: Sync) -> set[int]:
    if inst.nc == 0:
        return {inst.bid}
    return set(range(inst.base_bid, inst.base_bid + inst.nc + 1))


def _segments(prog: Program):
    """Yield (idx, DataMove, pre_syncs, post_syncs): the Sync instructions
    between the previous DataMove and this one, and between this one and the
    next (guard instructions travel with the transfer they protect)."""
    dms = [i for i, inst in enumerate(prog.instructions)
           if isinstance(inst, DataMove)]
    for k, idx in enumerate(dms):
        lo = dms[k - 1] + 1 if k else 0
        hi = dms[k + 1] if k + 1 < len(dms) else len(prog.instructions)
        pre = [s for s in prog.instructions[lo:idx] if isinstance(s, Sync)]
        post = [s for s in prog.instructions[idx + 1:hi]
                if isinstance(s, Sync)]
        yield idx, prog.instructions[idx], pre, post


def check_handshake_guards(programs: list[PUProgram], mem: MemoryPlan, *,
                           member: str = "",
                           report: Optional[VerifyReport] = None
                           ) -> VerifyReport:
    """Every consumed-tensor write sits behind its ACK, every produced-
    tensor read inside its REQ/ACK pair, with BID ranges matching the plan."""
    rep = report if report is not None else VerifyReport(label=member)

    def guard(syncs: list[Sync], op: Opcode, plan: TensorPlan):
        """(present, matching) for guards of ``op`` against ``plan``."""
        cands = [s for s in syncs if effective_opcode(s) is op]
        match = any(_sync_bid_set(s) == _bid_range(plan) for s in cands)
        return bool(cands), match

    for pu in programs:
        # -- ST: writes to consumed tensors -------------------------------
        for idx, dm, pre, post in _segments(pu.st):
            plan = _find_plan(mem, dm.cur_ba)
            if (plan is None or plan.kind == "output"
                    or not plan.consumer_stages):
                continue
            present, match = guard(pre, Opcode.WAIT_ACK, plan)
            if not present:
                rep.add(Code.HAZ_UNGUARDED_WRITE,
                        f"write to consumed tensor {plan.tid} is not guarded "
                        "by a WAIT_ACK — peer may still be reading",
                        member=member, pid=pu.pid, group="ST", index=idx)
            elif not match:
                rep.add(Code.HAZ_BID_MISMATCH,
                        f"WAIT_ACK guard(s) before write to tensor "
                        f"{plan.tid} cover the wrong BID range (plan BIDs "
                        f"{sorted(_bid_range(plan))})",
                        member=member, pid=pu.pid, group="ST", index=idx)
            present, match = guard(pre + post, Opcode.SEND_REQ, plan)
            if not present:
                rep.add(Code.HAZ_UNGUARDED_WRITE,
                        f"write to consumed tensor {plan.tid} never "
                        "publishes a SEND_REQ — consumers starve",
                        member=member, pid=pu.pid, group="ST", index=idx)
            elif not match:
                rep.add(Code.HAZ_BID_MISMATCH,
                        f"SEND_REQ(s) around write to tensor {plan.tid} "
                        f"cover the wrong BID range (plan BIDs "
                        f"{sorted(_bid_range(plan))})",
                        member=member, pid=pu.pid, group="ST", index=idx)

        # -- LD: reads of produced tensors (skip the one-shot prologue) ---
        try:
            icu_ba = pu.ld.progctrl.icu_ba
        except ValueError:
            icu_ba = 0
        for idx, dm, pre, post in _segments(pu.ld):
            if idx < icu_ba:
                continue
            plan = _find_plan(mem, dm.cur_ba)
            if plan is None or plan.kind != "intermediate":
                continue
            present, match = guard(pre, Opcode.WAIT_REQ, plan)
            if not present:
                rep.add(Code.HAZ_UNGUARDED_READ,
                        f"read of produced tensor {plan.tid} is not guarded "
                        "by a WAIT_REQ — data may not have landed",
                        member=member, pid=pu.pid, group="LD", index=idx)
            elif not match:
                rep.add(Code.HAZ_BID_MISMATCH,
                        f"WAIT_REQ guard(s) before read of tensor "
                        f"{plan.tid} cover the wrong BID range (plan BIDs "
                        f"{sorted(_bid_range(plan))})",
                        member=member, pid=pu.pid, group="LD", index=idx)
            present, match = guard(post, Opcode.SEND_ACK, plan)
            if not present:
                rep.add(Code.HAZ_UNGUARDED_READ,
                        f"read of tensor {plan.tid} is never acknowledged "
                        "(missing SEND_ACK) — producer credits leak away",
                        member=member, pid=pu.pid, group="LD", index=idx)
            elif not match:
                rep.add(Code.HAZ_BID_MISMATCH,
                        f"SEND_ACK(s) after read of tensor {plan.tid} "
                        f"cover the wrong BID range (plan BIDs "
                        f"{sorted(_bid_range(plan))})",
                        member=member, pid=pu.pid, group="LD", index=idx)
    return rep


def check_kv_streams(programs: list[PUProgram], mem: MemoryPlan, *,
                     member: str = "",
                     report: Optional[VerifyReport] = None) -> VerifyReport:
    """Per-slot K/V stream consistency: every cache region's length-advancing
    reader and append cursor describe the *same* slot geometry.

    With slot-packed decode (several sessions at different cache depths in
    one member) each cache region carries its own AddrLen read stream and
    its own AddrCyc append stream. The bounds/ping-pong checks see each
    stream in isolation; this check cross-correlates the two per region, so
    a cross-slot mixup — one slot's append cursor pointed at another slot's
    region, or a read prefix compiled for a different slot's depth — is
    caught even when every individual extent stays in bounds:

    * the read stream must start at the region base, advance in whole rows
      (``len_base`` a multiple of ``loffs``), and imply a non-negative
      prefix that stays inside the region across all ``nc`` rounds;
    * exactly one append stream must target the region, writing one row
      (``length == aoffs == loffs``) starting right after the read prefix
      (``ba == base + base_rows*row``) over the same round count.
    """
    rep = report if report is not None else VerifyReport(label=member)

    kv_plans = {p.tid: p for p in mem.tensors.values() if p.kind == "kv"}
    if not kv_plans:
        return rep
    reads: dict[int, list] = {}
    appends: dict[int, list] = {}
    for pu in programs:
        for group, prog in ((Group.LD, pu.ld), (Group.CP, pu.cp),
                            (Group.ST, pu.st)):
            for idx, inst in enumerate(prog.instructions):
                if not isinstance(inst, DataMove):
                    continue
                cyc = _succ_cycle(prog, idx)
                plan = _find_plan(mem, inst.cur_ba)
                if plan is None or plan.kind != "kv":
                    continue
                loc = (pu.pid, group.value, idx, inst, cyc)
                if isinstance(cyc, AddrLen):
                    reads.setdefault(plan.tid, []).append(loc)
                elif group is Group.ST:
                    appends.setdefault(plan.tid, []).append(loc)

    for tid, plan in sorted(kv_plans.items()):
        rs = reads.get(tid, [])
        ws = appends.get(tid, [])
        if not rs and not ws:
            continue  # untouched region (dead tensor) — nothing to correlate
        if not ws:
            rep.add(Code.HAZ_KV_STREAM,
                    f"kv tensor {tid}: length-advancing read stream has no "
                    "append stream — the prefix never grows past round 0",
                    member=member)
            continue
        if not rs:
            rep.add(Code.HAZ_KV_STREAM,
                    f"kv tensor {tid}: append stream has no length-advancing "
                    "reader — appended rows are never consumed",
                    severity=Severity.WARNING, member=member)
        if len(ws) > 1:
            locs = ", ".join(f"pu{p}.{g}[{i}]" for p, g, i, _, _ in ws)
            rep.add(Code.HAZ_KV_STREAM,
                    f"kv tensor {tid}: {len(ws)} append streams target one "
                    f"slot region ({locs}) — cross-slot append mixup",
                    member=member)

        geom = None  # (row, base_rows, nc) implied by the read side
        for pid, grp, idx, dm, al in rs:
            row, len0, nc = al.loffs, al.len_base, al.nc
            if row <= 0 or len0 % row or len0 < row:
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: read stream advances by LOFFS="
                        f"{row} from LEN_BASE={len0} — not a whole-row "
                        "prefix", member=member, pid=pid, group=grp,
                        index=idx)
                continue
            base_rows = len0 // row - 1
            if dm.cur_ba != plan.base_addr:
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: prefix read starts at "
                        f"0x{dm.cur_ba:x}, not the region base "
                        f"0x{plan.base_addr:x}", member=member, pid=pid,
                        group=grp, index=idx)
            if len0 + nc * row > plan.region_bytes:
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: read prefix grows to "
                        f"{len0 + nc * row} bytes, past the "
                        f"{plan.region_bytes}-byte region — depth belongs "
                        "to a deeper slot", member=member, pid=pid,
                        group=grp, index=idx)
            if geom is None:
                geom = (row, base_rows, nc)
            elif geom != (row, base_rows, nc):
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: read streams disagree on slot "
                        f"geometry ({geom} vs {(row, base_rows, nc)})",
                        member=member, pid=pid, group=grp, index=idx)

        for pid, grp, idx, dm, ac in ws:
            if not isinstance(ac, AddrCyc):
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: append write carries no AddrCyc "
                        "cursor — every round overwrites one row",
                        member=member, pid=pid, group=grp, index=idx)
                continue
            if geom is None:
                continue  # read side already diagnosed (or absent)
            row, base_rows, nc = geom
            want_ba = plan.base_addr + base_rows * row
            if dm.length != row or ac.aoffs != row:
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: append writes {dm.length} bytes "
                        f"with stride {ac.aoffs}, but the read side's row "
                        f"is {row} bytes", member=member, pid=pid,
                        group=grp, index=idx)
            if ac.ba != want_ba or dm.cur_ba != want_ba:
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: append cursor starts at "
                        f"0x{ac.ba:x}, but the read prefix ends at "
                        f"0x{want_ba:x} ({base_rows} base rows) — append "
                        "and read disagree on the slot's depth",
                        member=member, pid=pid, group=grp, index=idx)
            if ac.nc != nc:
                rep.add(Code.HAZ_KV_STREAM,
                        f"kv tensor {tid}: append cursor covers "
                        f"{ac.nc + 1} round(s) but the read stream "
                        f"advances over {nc + 1}", member=member, pid=pid,
                        group=grp, index=idx)
    return rep


def check_isolation(members: list[tuple[str, list[PUProgram],
                                        Optional[MemoryPlan]]], *,
                    report: Optional[VerifyReport] = None) -> VerifyReport:
    """Cross-member isolation: no HBM channel serves two members; address
    overlaps on a shared channel with a writer are concrete corruption."""
    rep = report if report is not None else VerifyReport(label="deployment")
    accesses = [(label, _collect_accesses(progs, mem))
                for label, progs, mem in members]
    for i in range(len(accesses)):
        for j in range(i + 1, len(accesses)):
            li, ai = accesses[i]
            lj, aj = accesses[j]
            chans_i = {a.channel for a in ai}
            chans_j = {a.channel for a in aj}
            for ch in sorted(chans_i & chans_j):
                rep.add(Code.HAZ_CHANNEL_SHARED,
                        f"HBM channel {ch} is used by both member "
                        f"{li!r} and member {lj!r} — members must own "
                        "disjoint channel pools",
                        member=li)
                hits = [
                    (x, y)
                    for x in ai if x.channel == ch
                    for y in aj if y.channel == ch
                    if x.lo < y.hi and y.lo < x.hi
                    and ("w" in (x.mode, y.mode))
                ]
                for x, y in hits[:4]:  # cap the witness list
                    rep.add(Code.HAZ_MEMBER_OVERLAP,
                            f"member {li!r} pu{x.pid}.{x.group}[{x.index}] "
                            f"({x.mode} [0x{x.lo:x},0x{x.hi:x})) overlaps "
                            f"member {lj!r} pu{y.pid}.{y.group}[{y.index}] "
                            f"({y.mode} [0x{y.lo:x},0x{y.hi:x})) on channel "
                            f"{ch}",
                            member=li, pid=x.pid, group=x.group,
                            index=x.index)
    return rep
