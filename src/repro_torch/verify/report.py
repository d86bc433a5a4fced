"""Structured diagnostics for the static program verifier.

Every check in :mod:`repro_torch.verify` reports through a :class:`Diagnostic`
carrying a typed :class:`Code`, a severity, and the precise location
(member label, PU id, ICU group, instruction index) so a failing compile
points at the exact instruction. A :class:`VerifyReport` aggregates the
diagnostics of one deployment (or one bare program list) and is what
``compile_deployment(..., verify=True)`` raises from on errors.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


class Code(enum.Enum):
    """Typed diagnostic codes, grouped by analysis tier.

    SYNC_* come from the sync-token flow checker, HAZ_* from the
    memory-hazard analyzer, LINT_* from the ISA lint tier (all static;
    :mod:`repro_torch.verify.mutate` is the dynamic cross-check).
    """

    # -- sync-token flow checker -------------------------------------------
    SYNC_DEADLOCK = "sync-deadlock"          # cross-PU wait-for cycle
    SYNC_STALL = "sync-stall"                # blocked wait, no live provider
    SYNC_TOKEN_STARVE = "sync-token-starve"  # per-round waits exceed sends
    SYNC_TOKEN_LEAK = "sync-token-leak"      # per-round sends exceed waits
    SYNC_WCHUNK = "sync-wchunk"              # GEMM interlock never satisfiable
    SYNC_ROUNDS = "sync-rounds"              # LD/CP/ST round counts disagree
    # -- memory-hazard analyzer --------------------------------------------
    HAZ_MEMBER_OVERLAP = "haz-member-overlap"    # cross-member region overlap
    HAZ_CHANNEL_SHARED = "haz-channel-shared"    # cross-member channel share
    HAZ_REGION_OVERRUN = "haz-region-overrun"    # AddrCyc/AddrLen out of extent
    HAZ_PINGPONG = "haz-pingpong"                # cyclic regions collide
    HAZ_BID_MISMATCH = "haz-bid-mismatch"        # guard BID range != plan BIDs
    HAZ_UNGUARDED_WRITE = "haz-unguarded-write"  # store without WAIT_ACK guard
    HAZ_UNGUARDED_READ = "haz-unguarded-read"    # load without WAIT_REQ guard
    HAZ_KV_STREAM = "haz-kv-stream"              # per-slot K/V stream mismatch
    # -- ISA lint ----------------------------------------------------------
    LINT_FIELD_OVERFLOW = "lint-field-overflow"  # value exceeds field width
    LINT_MISALIGNED = "lint-misaligned"          # address not beat-aligned
    LINT_ROUNDTRIP = "lint-roundtrip"            # encode/decode mismatch
    LINT_MISSING_PRG_END = "lint-missing-prg-end"
    LINT_GROUP = "lint-group"                    # opcode illegal in ICU group
    LINT_RESERVED = "lint-reserved"              # reserved-field violation
    LINT_STRUCTURE = "lint-structure"            # Program.validate() failure


@dataclass
class Diagnostic:
    code: Code
    message: str
    severity: Severity = Severity.ERROR
    member: str = ""                 # deployment member label ("" = global)
    pid: Optional[int] = None        # PU id
    group: Optional[str] = None      # "LD" | "CP" | "ST"
    index: Optional[int] = None      # instruction index within the group

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
        return ":".join(parts)

    def __str__(self) -> str:
        loc = self.location
        where = f" at {loc}" if loc else ""
        return f"[{self.severity.value}] {self.code.value}{where}: {self.message}"


class VerificationError(RuntimeError):
    """Raised by :meth:`VerifyReport.raise_if_failed` on ERROR diagnostics."""

    def __init__(self, report: "VerifyReport") -> None:
        super().__init__(report.summary())
        self.report = report


@dataclass
class VerifyReport:
    """All diagnostics of one verification run, queryable by severity/code."""

    label: str = ""
    diagnostics: list[Diagnostic] = field(default_factory=list)

    def add(self, code: Code, message: str, *, severity: Severity = Severity.ERROR,
            member: str = "", pid: Optional[int] = None,
            group: Optional[str] = None, index: Optional[int] = None) -> Diagnostic:
        d = Diagnostic(code=code, message=message, severity=severity,
                       member=member, pid=pid, group=group, index=index)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "VerifyReport") -> None:
        self.diagnostics.extend(other.diagnostics)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_code(self, code: Code) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code is code]

    def has(self, code: Code) -> bool:
        return any(d.code is code for d in self.diagnostics)

    def summary(self) -> str:
        name = self.label or "programs"
        if self.ok and not self.warnings:
            return f"verify {name}: clean ({len(self.diagnostics)} notes)"
        head = (f"verify {name}: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")
        lines = [head] + [f"  {d}" for d in self.diagnostics
                          if d.severity is not Severity.INFO]
        return "\n".join(lines)

    def raise_if_failed(self) -> "VerifyReport":
        if not self.ok:
            raise VerificationError(self)
        return self
