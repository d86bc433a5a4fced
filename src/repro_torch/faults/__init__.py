"""The port's copy of the JAX package's ``faults/``, fault tolerance for the
multi-PU machine: seeded deterministic fault injection into the event kernel
(hang a PU mid-round, drop/corrupt sync tokens, stall an HBM channel, spike
an ISU link), watchdog detection that turns silent hangs into structured
``FaultReport``s (PU/channel/instruction location, mirroring the
``repro_torch.verify`` diagnostic idiom), and the value types the serving
loop's quarantine/replan/replay recovery consumes. Host code over the
simulator copy; it touches no tensor."""
from .inject import FaultInjector
from .report import FaultCode, FaultReport, reports_from_blocked
from .spec import (FAULT_CLASSES, FaultSchedule, FaultSpec, HBMStall,
                   LinkSpike, PUHang, TokenCorrupt, TokenDrop)
from .watchdog import Watchdog, spawn_monitor

__all__ = [
    "FAULT_CLASSES",
    "FaultCode",
    "FaultInjector",
    "FaultReport",
    "FaultSchedule",
    "FaultSpec",
    "HBMStall",
    "LinkSpike",
    "PUHang",
    "TokenCorrupt",
    "TokenDrop",
    "Watchdog",
    "reports_from_blocked",
    "spawn_monitor",
]
