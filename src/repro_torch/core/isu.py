"""Instruction Synchronization Unit network (paper Sec. III-A, Fig. 2(b,c)).

Distributed switch fabric routing single-beat control tokens (REQ/ACK)
between PUs over AXIS channels. Each ISU is an AXIS switch with local
injection (S0) / delivery (M0) ports and directional forwarding (S1,S2 /
M1,M2) — i.e. the PUs of one SLR form a chain, and chains are bridged by
SLR-crossing register slices.

Token latency model, calibrated to the measured matrix of Fig. 2(c):

  same PU                 : 2 cycles  (bypasses the switch fabric)
  same SLR                : 2 + ~1/2 per extra hop  -> 2-3 cycles
  cross SLR               : + 13-cycle SLR boundary penalty

Tokens are single-beat: TDATA = {BID, SRC_PID, type}, TDEST = DST_PID. With a
single token in transit the fabric is contention-free; one-transfer
round-robin arbitration resolves simultaneous injections (modeled as +1 cycle
per conflicting token ahead in the queue — negligible at DNN timescales, as
the paper argues).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .events import Delay, Kernel
from .pu import PUSpec

SLR_CROSS_PENALTY = 13
SAME_PU_LATENCY = 2
BASE_HOP_LATENCY = 2


@dataclass(frozen=True)
class Token:
    """Single-beat AXIS control token."""

    src_pid: int
    dst_pid: int
    bid: int
    kind: str  # "req" | "ack"

    def __repr__(self) -> str:
        return f"<{self.kind.upper()} {self.src_pid}->{self.dst_pid} BID={self.bid}>"


def token_latency_cycles(src: PUSpec, dst: PUSpec) -> int:
    """Deterministic token latency (sys_clk cycles), per Fig. 2(c)."""
    if src.pid == dst.pid:
        return SAME_PU_LATENCY
    hops = abs(src.pid - dst.pid)
    lat = BASE_HOP_LATENCY + (1 if hops > 2 else 0)
    if src.slr != dst.slr:
        lat += SLR_CROSS_PENALTY
    return lat


def latency_matrix(pus: list[PUSpec]) -> list[list[int]]:
    """The full PU-to-PU token latency matrix (benchmarks/isu_latency.py)."""
    return [[token_latency_cycles(s, d) for d in pus] for s in pus]


class ISUNetwork:
    """Routes tokens between ICUs with the deterministic latency model.

    ``deliver`` is installed by the simulator: deliver(dst_pid, token) updates
    the destination ICU's REQ/ACK LUTRAM and wakes waiting decoders.
    """

    def __init__(self, kernel: Kernel, pus: list[PUSpec]) -> None:
        self.kernel = kernel
        self.pus = {p.pid: p for p in pus}
        self.deliver: Optional[Callable[[int, Token], None]] = None
        self.tokens_sent = 0
        self.tokens_dropped = 0
        # Injected fault hook (repro_torch.faults): maps (token, latency) to a
        # possibly corrupted token and latency, or to (None, _) to drop the
        # token in the fabric. Installed per reset; None on a healthy fabric.
        self.fault_hook: Optional[
            Callable[[Token, float], tuple[Optional[Token], float]]] = None
        self._inflight: dict[tuple[int, int], int] = {}  # crude contention model

    def send(self, token: Token) -> None:
        """Inject a token at the source ISU (non-blocking for the ICU: the
        S0 FIFO decouples the decoder from the fabric)."""
        src = self.pus[token.src_pid]
        dst = self.pus[token.dst_pid]
        base = token_latency_cycles(src, dst)
        if self.fault_hook is not None:
            faulted, base = self.fault_hook(token, base)
            if faulted is None:  # dropped in the fabric
                self.tokens_dropped += 1
                return
            token = faulted
        # one-transfer round-robin: a token queued behind k in-flight tokens
        # on the same directed link waits k extra cycles.
        link = (token.src_pid, token.dst_pid)
        backlog = self._inflight.get(link, 0)
        self._inflight[link] = backlog + 1
        self.tokens_sent += 1
        self.kernel.spawn(self._transit(token, base + backlog, link), name=f"isu:{token}")

    def _transit(self, token: Token, cycles: float, link: tuple[int, int]):
        yield Delay(cycles)
        self._inflight[link] -= 1
        assert self.deliver is not None, "ISUNetwork.deliver not installed"
        self.kernel.log("isu", ("deliver", token))
        self.deliver(token.dst_pid, token)
