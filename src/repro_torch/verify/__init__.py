"""Static program verification: the port's copy of the JAX package's
``verify/``, held to it report for report.

Three tiers over compiled :class:`~repro_torch.core.program.PUProgram` bundles,
none of which executes a simulated cycle:

* :mod:`repro_torch.verify.lint` — per-instruction encodability / structure;
* :mod:`repro_torch.verify.sync` — sync-token flow: abstract (untimed) execution
  with deadlock-cycle extraction plus exact per-round token-rate balance;
* :mod:`repro_torch.verify.hazard` — memory hazards: region bounds, ping-pong
  aliasing, handshake guards, cross-member isolation.

``verify_deployment`` is what ``compile_deployment(..., verify=True)``
(default) runs; ``python -m repro_torch.verify`` exposes the same checks over
any zoo model from the command line, and :mod:`repro_torch.verify.mutate` is the
defect-injection harness that cross-validates the analyzer against the
simulator.
"""
from __future__ import annotations

from typing import Optional

from ..core.program import PUProgram
from ..core.pu import PUSpec
from .hazard import (check_handshake_guards, check_isolation,
                     check_kv_streams, check_region_bounds)
from .lint import lint_program, lint_pu_program
from .report import Code, Diagnostic, Severity, VerificationError, VerifyReport
from .sync import check_token_balance, check_token_flow, check_wchunk_interlock

__all__ = [
    "Code",
    "Diagnostic",
    "Severity",
    "VerificationError",
    "VerifyReport",
    "check_handshake_guards",
    "check_isolation",
    "check_kv_streams",
    "check_region_bounds",
    "check_token_balance",
    "check_token_flow",
    "check_wchunk_interlock",
    "lint_program",
    "lint_pu_program",
    "verify_deployment",
    "verify_programs",
]


def verify_programs(
    programs: list[PUProgram],
    *,
    mem=None,
    pu_specs: Optional[dict[int, PUSpec]] = None,
    member: str = "",
    lint: bool = True,
    sync: bool = True,
    hazards: bool = True,
) -> VerifyReport:
    """Run every applicable static check over one program bundle.

    ``mem`` (a :class:`~repro_torch.compiler.memory.MemoryPlan`) enables the
    hazard tier; ``pu_specs`` gives the sync tier exact buffer-slot counts
    (defaults to the 2-slot ping-pong when omitted)."""
    rep = VerifyReport(label=member or "programs")
    if lint:
        for pu in programs:
            lint_pu_program(pu, member=member, report=rep)
    if sync:
        check_token_balance(programs, member=member, report=rep)
        check_wchunk_interlock(programs, member=member, report=rep)
        check_token_flow(programs, pu_specs=pu_specs, member=member,
                         report=rep)
    if hazards and mem is not None:
        check_region_bounds(programs, mem, member=member, report=rep)
        check_handshake_guards(programs, mem, member=member, report=rep)
        check_kv_streams(programs, mem, member=member, report=rep)
    return rep


def verify_deployment(dep) -> VerifyReport:
    """Verify every member of a :class:`~repro_torch.deploy.Deployment` plus the
    cross-member isolation invariant. Returns the merged report; call
    ``.raise_if_failed()`` to turn errors into :class:`VerificationError`."""
    rep = VerifyReport(label=dep.name)
    member_data = []
    for m in dep.members:
        label = f"m{m.index}:{m.workload.label}" if len(dep.members) > 1 else ""
        programs = m.compiled.programs
        mem = m.compiled.mem
        specs = m.compiled.pu_specs
        sub = verify_programs(programs, mem=mem, pu_specs=specs,
                              member=label)
        rep.extend(sub)
        member_data.append((label or dep.name, programs, mem))
    if len(member_data) > 1:
        check_isolation(member_data, report=rep)
    return rep
