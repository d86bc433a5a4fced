"""Hand-coded instruction programs for the paper's two-PU pipeline example
(Sec. III-C, Fig. 3).

Two Conv layers (as GEMM) map to PU_a (producer) and PU_b (consumer):

  PU_a: LD reads input from the cyclic A-regions, CP computes, ST writes the
        intermediate tensor into ping-pong B-buffers (BID 0/1), guarded by
        WAIT_ACK / SEND_REQ.
  PU_b: LD waits REQ, reads B[bid], sends ACK (with the two-ACK *bypass
        prologue* pre-authorizing B0/B1 before the loop), CP computes, ST
        writes results to the cyclic C-regions.

The port's copy of the JAX package's ``core/demo.py``, used by the tests
(Fig. 3 cases 1-3: balanced / consumer-limited / producer-limited) and by
``repro_torch.benchmarks.paper_repro`` (``fig3_two_pu_pipeline``).
"""
from __future__ import annotations

from dataclasses import dataclass

from .isa import AddrCyc, Compute, DataMove, Opcode, Sync
from .program import Program, PUProgram
from .isa import Group


@dataclass(frozen=True)
class GemmShape:
    m: int  # output channels
    n: int  # spatial positions
    k: int  # reduction (in_ch * kh * kw)

    @property
    def out_bytes(self) -> int:
        return self.m * self.n  # INT8

    @property
    def in_bytes(self) -> int:
        return self.k * self.n  # upper bound (im2col view)


def build_two_pu_pipeline(
    pid_a: int,
    pid_b: int,
    shape_a: GemmShape,
    shape_b: GemmShape,
    *,
    rounds: int,
    n_io_regions: int = 4,
    a_region_base: int = 0x000_0000,
    b_region_base: int = 0x400_0000,
    c_region_base: int = 0x800_0000,
    chan_a: int = 0,
    chan_b_w: int = 1,
    chan_b_r: int = 2,
    chan_c: int = 3,
) -> list[PUProgram]:
    """Construct the Fig. 3 instruction programs. Intermediate tensor is
    shape_a's output == shape_b's input."""
    la = shape_a.in_bytes
    lb = shape_a.out_bytes
    lc = shape_b.out_bytes
    n = n_io_regions

    # ---- PU_a (producer) ----------------------------------------------------
    ld_a = Program.assemble(
        Group.LD,
        [
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=a_region_base, length=la, channel=chan_a),
            AddrCyc(ba=a_region_base, aoffs=la, nc=n - 1, ic=n - 1),
        ],
        rounds=rounds,
        name=f"pu{pid_a}.LD",
    )
    cp_a = Program.assemble(
        Group.CP,
        [Compute(m=shape_a.m, n=shape_a.n, k=shape_a.k, relu=True)],
        rounds=rounds,
        name=f"pu{pid_a}.CP",
    )
    st_a = Program.assemble(
        Group.ST,
        [
            Sync(op=Opcode.WAIT_ACK, pid=pid_b, bid=0, base_bid=0, nc=1, ic=1),
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=b_region_base, length=lb, channel=chan_b_w),
            AddrCyc(ba=b_region_base, aoffs=lb, nc=1, ic=1),
            Sync(op=Opcode.SEND_REQ, pid=pid_b, bid=0, base_bid=0, nc=1, ic=1),
        ],
        rounds=rounds,
        name=f"pu{pid_a}.ST",
    )

    # ---- PU_b (consumer) ----------------------------------------------------
    # ACK-bypass prologue at addresses {0,1}: pre-authorize both B buffers,
    # then loop from ICU_BA=2 (the prologue runs exactly once).
    ld_b = Program.assemble(
        Group.LD,
        [
            Sync(op=Opcode.SEND_ACK, pid=pid_a, bid=0, nc=0),  # bypass: BID fixed
            Sync(op=Opcode.SEND_ACK, pid=pid_a, bid=1, nc=0),
            Sync(op=Opcode.WAIT_REQ, pid=pid_a, bid=0, base_bid=0, nc=1, ic=1),
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=b_region_base, length=lb, channel=chan_b_r),
            AddrCyc(ba=b_region_base, aoffs=lb, nc=1, ic=1),
            Sync(op=Opcode.SEND_ACK, pid=pid_a, bid=0, base_bid=0, nc=1, ic=1),
        ],
        rounds=rounds,
        loop_ba=2,
        name=f"pu{pid_b}.LD",
    )
    cp_b = Program.assemble(
        Group.CP,
        [Compute(m=shape_b.m, n=shape_b.n, k=shape_b.k, relu=True)],
        rounds=rounds,
        name=f"pu{pid_b}.CP",
    )
    st_b = Program.assemble(
        Group.ST,
        [
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=c_region_base, length=lc, channel=chan_c),
            AddrCyc(ba=c_region_base, aoffs=lc, nc=n - 1, ic=n - 1),
        ],
        rounds=rounds,
        name=f"pu{pid_b}.ST",
    )

    return [
        PUProgram(pid_a, ld_a, cp_a, st_a, label="producer"),
        PUProgram(pid_b, ld_b, cp_b, st_b, label="consumer"),
    ]
