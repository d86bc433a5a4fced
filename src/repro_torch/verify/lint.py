"""ISA lint tier: per-instruction encodability and structural checks.

Everything here is local to one instruction or one :class:`Program` — no
cross-PU reasoning. Catches the defects that would silently truncate on
hardware (field-width overflow like ``Compute.M``'s 12-bit limit,
misaligned beat addresses), violate the assembler conventions (missing
``PRG_END``, opcode illegal in its ICU group, Config without a successor
DataMove), corrupt round semantics (reserved-field violations: ``IC > NC``
counters that the decoder would never reset), or fail the encode/decode
round-trip.
"""
from __future__ import annotations

from ..core.isa import (
    BEAT,
    AddrCyc,
    AddrLen,
    DataMove,
    Group,
    Instruction,
    Sync,
    validate_group,
)
from ..core.program import Program, PUProgram
from .report import Code, Severity, VerifyReport


def _classify_encode_error(msg: str) -> Code:
    if "aligned" in msg:
        return Code.LINT_MISALIGNED
    return Code.LINT_FIELD_OVERFLOW


def _roundtrip_ok(inst: Instruction, word: int) -> bool:
    """decode(encode(inst)) must re-encode to the same 64-bit word and
    decode to the same instruction type (LEN round-up is part of the
    encoding contract, so word-level comparison is the right equality)."""
    decoded = Instruction.decode(word)
    if type(decoded) is not type(inst):
        return False
    return decoded.encode() == word


def _check_reserved(rep: VerifyReport, inst: Instruction, *, member: str,
                    pid: int, group: str, index: int) -> None:
    """Counter invariants the decoder relies on: IC initialises to NC
    (Table I(b)), so IC > NC — or a nonzero IC under the NC==0 bypass —
    means the cycling state machine starts outside its own cycle."""
    if isinstance(inst, Sync):
        if inst.nc == 0 and inst.ic != 0:
            rep.add(Code.LINT_RESERVED,
                    f"{inst.op.name} has IC={inst.ic} under the NC=0 bypass",
                    member=member, pid=pid, group=group, index=index)
        elif inst.ic > inst.nc:
            rep.add(Code.LINT_RESERVED,
                    f"{inst.op.name} IC={inst.ic} exceeds NC={inst.nc}",
                    member=member, pid=pid, group=group, index=index)
    elif isinstance(inst, (AddrCyc, AddrLen)):
        if inst.ic > inst.nc:
            rep.add(Code.LINT_RESERVED,
                    f"{type(inst).__name__} IC={inst.ic} exceeds NC={inst.nc}",
                    member=member, pid=pid, group=group, index=index)


def lint_program(prog: Program, *, pid: int, member: str = "",
                 report: VerifyReport | None = None) -> VerifyReport:
    rep = report if report is not None else VerifyReport(label=prog.name)
    group = prog.group.value

    if not prog.instructions:
        rep.add(Code.LINT_STRUCTURE, "empty program",
                member=member, pid=pid, group=group)
        return rep
    if not prog.instructions[-1].prg_end:
        rep.add(Code.LINT_MISSING_PRG_END,
                "last instruction does not set PRG_END",
                member=member, pid=pid, group=group,
                index=len(prog.instructions) - 1)

    try:
        prog.validate()
    except ValueError as e:
        # validate() also rejects a missing PRG_END; don't double-report.
        if "PRG_END" not in str(e):
            rep.add(Code.LINT_STRUCTURE, str(e),
                    member=member, pid=pid, group=group)

    for idx, inst in enumerate(prog.instructions):
        try:
            validate_group(inst, prog.group)
        except ValueError as e:
            rep.add(Code.LINT_GROUP, str(e),
                    member=member, pid=pid, group=group, index=idx)
        try:
            word = inst.encode()
        except ValueError as e:
            rep.add(_classify_encode_error(str(e)),
                    f"{type(inst).__name__}: {e}",
                    member=member, pid=pid, group=group, index=idx)
        else:
            if not _roundtrip_ok(inst, word):
                rep.add(Code.LINT_ROUNDTRIP,
                        f"{type(inst).__name__} does not survive "
                        f"encode/decode (word=0x{word:016x})",
                        member=member, pid=pid, group=group, index=idx)
        if isinstance(inst, DataMove) and inst.length % BEAT:
            # LEN encodes with round-up, so a ragged byte length silently
            # over-reads on hardware; flag it even though encode() accepts.
            rep.add(Code.LINT_MISALIGNED,
                    f"{inst.op.name} LEN={inst.length} is not a multiple of "
                    f"the {BEAT}-byte beat (encoder rounds up)",
                    severity=Severity.WARNING,
                    member=member, pid=pid, group=group, index=idx)
        _check_reserved(rep, inst, member=member, pid=pid, group=group,
                        index=idx)
    return rep


def lint_pu_program(pu_prog: PUProgram, *, member: str = "",
                    report: VerifyReport | None = None) -> VerifyReport:
    rep = report if report is not None else VerifyReport(
        label=pu_prog.label or f"pu{pu_prog.pid}")
    groups = [(Group.LD, pu_prog.ld), (Group.CP, pu_prog.cp),
              (Group.ST, pu_prog.st)]
    for _, prog in groups:
        lint_program(prog, pid=pu_prog.pid, member=member, report=rep)
    # Round counts must agree across the three groups, else the PU's
    # streams drift apart and the last round deadlocks on its peers.
    nrs = {}
    for grp, prog in groups:
        try:
            nrs[grp.value] = prog.progctrl.nr
        except ValueError:
            pass  # structure diagnostics already cover the missing ProgCtrl
    if len(set(nrs.values())) > 1:
        rep.add(Code.SYNC_ROUNDS,
                f"group round counts disagree: {nrs}",
                member=member, pid=pu_prog.pid)
    return rep
