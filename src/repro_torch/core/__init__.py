"""The port's copy of ``repro.core``, the paper's coordination layer: the
ISA (``isa.py``) and the instruction programs (``program.py``), the PU
timing model (``pu.py``), the ISU token network (``isu.py``), the ICU
decoders (``icu.py``) and the discrete-event simulator that runs them
(``events.py``, ``simulator.py``). All of it is framework-neutral Python,
copied as it is; the port keeps its own copy instead of importing the JAX
package, and the tests hold the copies to the originals (encodings word for
word, simulator results field for field). The FPGA constants of ``pu.py``
and ``isu.py`` (300 MHz, 14.4 GB/s a channel, SLR penalties) model the
paper's Alveo U50, not the card. The simulator's fault injection and
watchdog raise ``NotImplementedError``: the fault package is not copied
yet."""
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
from .pu import PUSpec, make_u50_system, system_peak_tops
from .isu import ISUNetwork, Token, latency_matrix, token_latency_cycles
from .icu import ICU
from .simulator import MemberSimResult, MultiPUSimulator, PipelineMember, SimResult, simulate

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
    "PUSpec",
    "make_u50_system",
    "system_peak_tops",
    "ISUNetwork",
    "Token",
    "latency_matrix",
    "token_latency_cycles",
    "ICU",
    "MemberSimResult",
    "MultiPUSimulator",
    "PipelineMember",
    "SimResult",
    "simulate",
]
