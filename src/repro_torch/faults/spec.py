"""Deterministic fault specifications and seeded fault schedules.

Each spec describes one injectable hardware failure of the paper's
machine model — a PU whose ICU decoders stop issuing (PUHang), a sync
token lost or corrupted in the ISU fabric (TokenDrop / TokenCorrupt), an
HBM pseudo-channel that stops serving transfers (HBMStall), a congested
ISU link (LinkSpike). A :class:`FaultSchedule` bundles specs; it is a
frozen value, so re-arming it on every ``MultiPUSimulator.reset()`` (the
serving loop resets per window) is idempotent and two runs with the same
schedule are byte-identical.

:meth:`FaultSchedule.random` derives a schedule from a seed alone
(``random.Random(seed)``), which is what the chaos-determinism tests and
the CI smoke drive: same seed, same faults, same event log.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Optional, Union

from ..core.pu import N_HBM_CHANNELS, PUSpec, make_u50_system


@dataclass(frozen=True)
class PUHang:
    """PU ``pid`` stops decoding instructions once the clock reaches
    ``at_cycle`` (mid-round: the gate is checked per instruction)."""

    pid: int
    at_cycle: float = 0.0


@dataclass(frozen=True)
class TokenDrop:
    """The ``nth`` matching sync token from ``src_pid`` is lost in the
    fabric. ``bid``/``kind`` narrow the match to one coordination channel
    (``None``/``"any"`` match every BID / both REQ and ACK)."""

    src_pid: int
    bid: Optional[int] = None
    kind: str = "any"  # "req" | "ack" | "any"
    nth: int = 1


@dataclass(frozen=True)
class TokenCorrupt:
    """The ``nth`` matching token arrives with its BID rewritten by
    ``bid_offset`` — it lands in the wrong LUTRAM entry, so the intended
    waiter starves while a bogus entry accumulates."""

    src_pid: int
    bid: Optional[int] = None
    kind: str = "any"
    nth: int = 1
    bid_offset: int = 1024


@dataclass(frozen=True)
class HBMStall:
    """HBM channel ``channel`` stops serving at ``at_cycle`` for
    ``duration`` cycles (infinite by default): the injector holds the
    channel semaphore, so every ADM transfer routed there parks."""

    channel: int
    at_cycle: float = 0.0
    duration: float = math.inf


@dataclass(frozen=True)
class LinkSpike:
    """Tokens on the directed ISU link ``src_pid -> dst_pid`` take
    ``extra_cycles`` additional latency while the clock is inside
    ``[at_cycle, at_cycle + duration)`` — a congested/flaky register
    slice rather than a dead one."""

    src_pid: int
    dst_pid: int
    extra_cycles: float
    at_cycle: float = 0.0
    duration: float = math.inf


FaultSpec = Union[PUHang, TokenDrop, TokenCorrupt, HBMStall, LinkSpike]

FAULT_CLASSES = ("pu-hang", "token-drop", "token-corrupt", "hbm-stall",
                 "link-spike")


def _describe(f: FaultSpec) -> str:
    if isinstance(f, PUHang):
        return f"pu-hang(pid={f.pid}, at={f.at_cycle:.0f})"
    if isinstance(f, TokenDrop):
        bid = "*" if f.bid is None else f.bid
        return f"token-drop(src={f.src_pid}, bid={bid}, {f.kind}, nth={f.nth})"
    if isinstance(f, TokenCorrupt):
        bid = "*" if f.bid is None else f.bid
        return (f"token-corrupt(src={f.src_pid}, bid={bid}, {f.kind}, "
                f"nth={f.nth}, +{f.bid_offset})")
    if isinstance(f, HBMStall):
        dur = "inf" if math.isinf(f.duration) else f"{f.duration:.0f}"
        return f"hbm-stall(ch={f.channel}, at={f.at_cycle:.0f}, dur={dur})"
    if isinstance(f, LinkSpike):
        return (f"link-spike({f.src_pid}->{f.dst_pid}, "
                f"+{f.extra_cycles:.0f}cyc, at={f.at_cycle:.0f})")
    return repr(f)  # pragma: no cover - exhaustive above


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable bundle of fault specs, optionally tagged with the seed
    that generated it. Frozen so the simulator can re-arm it on every
    reset without fired-once bookkeeping leaking across runs."""

    faults: tuple[FaultSpec, ...] = field(default_factory=tuple)
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "faults", tuple(self.faults))

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def describe(self) -> str:
        tag = f"seed={self.seed} " if self.seed is not None else ""
        return tag + "; ".join(_describe(f) for f in self.faults) or "empty"

    @classmethod
    def random(cls, seed: int, *, pus: Optional[list[PUSpec]] = None,
               n: int = 1, classes=FAULT_CLASSES,
               cycle_range: tuple[float, float] = (1_000.0, 50_000.0),
               spike_cycles: float = 5_000_000.0) -> "FaultSchedule":
        """A schedule derived from ``seed`` alone: ``n`` faults drawn
        uniformly over ``classes`` and over the machine's PUs / HBM
        channels / links, engaging at a cycle inside ``cycle_range``.
        Deterministic: same arguments, same schedule."""
        rng = random.Random(seed)
        pids = [p.pid for p in (pus if pus is not None else make_u50_system())]
        out: list[FaultSpec] = []
        for _ in range(n):
            klass = rng.choice(list(classes))
            at = rng.uniform(*cycle_range)
            if klass == "pu-hang":
                out.append(PUHang(pid=rng.choice(pids), at_cycle=at))
            elif klass == "token-drop":
                out.append(TokenDrop(src_pid=rng.choice(pids),
                                     nth=rng.randint(1, 8)))
            elif klass == "token-corrupt":
                out.append(TokenCorrupt(src_pid=rng.choice(pids),
                                        nth=rng.randint(1, 8)))
            elif klass == "hbm-stall":
                out.append(HBMStall(channel=rng.randrange(N_HBM_CHANNELS),
                                    at_cycle=at))
            elif klass == "link-spike":
                src = rng.choice(pids)
                dst = rng.choice([p for p in pids if p != src])
                out.append(LinkSpike(src_pid=src, dst_pid=dst,
                                     extra_cycles=spike_cycles, at_cycle=at))
            else:
                raise ValueError(f"unknown fault class {klass!r}")
        return cls(faults=tuple(out), seed=seed)
