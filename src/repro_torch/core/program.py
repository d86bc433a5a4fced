"""Instruction programs: per-ICU-group BRAM images + round semantics.

A :class:`Program` is the content of one ICU group's dual-port BRAM. A
*program round* iterates instructions sequentially until an instruction with
PRG_END set, then the ``ProgCtrl`` (which must be that terminal instruction in
our assembler convention, matching PRG_PRM placement in Table I(c)) decides:
jump to ICU_BA for the next round, or halt after NR rounds.

Programs are runtime-mutable: dynamic instructions (AddrCyc, Sync, DataMove
CUR_BA) write their state back into the BRAM, exactly as in the hardware.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Iterator

from .isa import (
    AddrCyc,
    AddrLen,
    Config,
    DataMove,
    Group,
    Instruction,
    ProgCtrl,
    validate_group,
)


@dataclass
class Program:
    group: Group
    instructions: list[Instruction] = field(default_factory=list)
    name: str = ""

    def __post_init__(self) -> None:
        for inst in self.instructions:
            validate_group(inst, self.group)

    # -- assembly -----------------------------------------------------------
    @classmethod
    def assemble(cls, group: Group, body: list[Instruction], *, rounds: int = 1,
                 loop_ba: int = 0, name: str = "") -> "Program":
        """Append the terminal ProgCtrl (PRG_END) controlling round looping.

        ``loop_ba`` is the instruction address execution jumps to at the end
        of each round — a nonzero value skips a one-shot prologue (e.g. the
        ACK-bypass pre-authorization of Fig. 3)."""
        insts = list(body) + [ProgCtrl(nr=rounds, icu_ba=loop_ba, prg_end=True)]
        return cls(group, insts, name=name)

    def encode(self) -> list[int]:
        return [i.encode() for i in self.instructions]

    @classmethod
    def decode(cls, group: Group, words: list[int], name: str = "") -> "Program":
        return cls(group, [Instruction.decode(w) for w in words], name=name)

    def clone(self) -> "Program":
        """Fresh runtime image (dynamic state will be mutated in place)."""
        return Program(self.group, copy.deepcopy(self.instructions), self.name)

    @property
    def progctrl(self) -> ProgCtrl:
        for inst in self.instructions:
            if isinstance(inst, ProgCtrl):
                return inst
        raise ValueError(f"program {self.name!r} has no ProgCtrl")

    def validate(self) -> None:
        if not self.instructions:
            raise ValueError("empty program")
        if not self.instructions[-1].prg_end:
            raise ValueError("last instruction must set PRG_END")
        pc = self.progctrl
        if not (0 <= pc.icu_ba < len(self.instructions)):
            raise ValueError("ICU_BA out of range")
        # Config instructions must precede a DataMove (mandatory sequence ->).
        for idx, inst in enumerate(self.instructions):
            if isinstance(inst, Config):
                nxt = self.instructions[idx + 1] if idx + 1 < len(self.instructions) else None
                if not isinstance(nxt, DataMove):
                    raise ValueError(f"Config at {idx} lacks successor DataMove")
            if isinstance(inst, (AddrCyc, AddrLen)):
                prev = self.instructions[idx - 1] if idx > 0 else None
                if not isinstance(prev, DataMove):
                    raise ValueError(
                        f"{type(inst).__name__} at {idx} lacks predecessor DataMove"
                    )

    def __len__(self) -> int:
        return len(self.instructions)

    def __iter__(self) -> Iterator[Instruction]:
        return iter(self.instructions)

    def disassemble(self) -> str:
        lines = [f"; {self.group.value} program {self.name!r}"]
        for i, inst in enumerate(self.instructions):
            end = " [PRG_END]" if inst.prg_end else ""
            lines.append(f"{i:4d}: {inst!r}{end}")
        return "\n".join(lines)


@dataclass
class PUProgram:
    """The full instruction image of one PU: LD + CP + ST programs."""

    pid: int
    ld: Program
    cp: Program
    st: Program
    label: str = ""

    def clone(self) -> "PUProgram":
        return PUProgram(self.pid, self.ld.clone(), self.cp.clone(), self.st.clone(), self.label)

    def validate(self) -> None:
        for prog in (self.ld, self.cp, self.st):
            prog.validate()

    def encode(self) -> dict[str, list[int]]:
        return {"LD": self.ld.encode(), "CP": self.cp.encode(), "ST": self.st.encode()}

    def total_instructions(self) -> int:
        return len(self.ld) + len(self.cp) + len(self.st)
