"""The port's copy of the instruction layer of ``repro.core``: the ISA
(``isa.py``, copied as it is) and the instruction programs (``program.py``,
``Program`` and ``PUProgram``). Both are framework-neutral; the port keeps its
own copy instead of importing the JAX package, and the tests hold the copies
to the originals by their encodings. The event simulator is not copied: the
tests run the port's programs on ``repro.core.MultiPUSimulator``."""
from .isa import (
    AddrCyc,
    AddrLen,
    Compute,
    Config,
    DataMove,
    Group,
    Instruction,
    Opcode,
    ProgCtrl,
    Sync,
)
from .program import Program, PUProgram

__all__ = [
    "AddrCyc",
    "AddrLen",
    "Compute",
    "Config",
    "DataMove",
    "Group",
    "Instruction",
    "Opcode",
    "ProgCtrl",
    "Sync",
    "Program",
    "PUProgram",
]
