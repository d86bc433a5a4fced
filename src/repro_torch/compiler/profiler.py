"""Node execution-time profiling (paper Sec. IV-A, Fig. 4(c)).

Profiles each node under *conflict-free* conditions — weights preloaded in
URAMs, dedicated HBM channels — measuring complete node processing: activation
fetch from HBM, SA computation, output storage. With tile-grained streaming
the PU overlaps these, so the steady-state node time is the slowest of the
three decoupled instruction groups, each charged its own per-instruction
decode overhead (1 sys_clk cycle per instruction, matching the ICU decoder):

    t_node = max(t_residual + t_compute + cp_decode,
                 t_load     + ld_decode,
                 t_store    + st_decode)

Transfers are accounted per ADM DataMove — each transfer pays the
latency-dominated ~40-cycle floor individually (the profiler used to lump
all input bytes into one transfer, which under-counted tiny nodes whose
per-stream floors dominate). The LD group only ever moves the *primary*
input; residual shortcuts and second operands stream through the CP-issued
async ADM engines (``t_residual``) — and they *serialize* with the GEMM on
the CP path: codegen queues the RES_ADD issue together with the Compute, so
it decodes only after the previous node's GEMM releases the CP group, and
the Compute's residual interlock then blocks until the stream lands (the
model used to fold ``t_residual`` into the max as if it overlapped, which
under-predicted every stage containing a shortcut by up to one ADM floor
per node). The second operand of an attention GEMM goes through the SA
weight port instead, whose node-granular stall accounting lives in
``repro_torch.compiler.weights``.

Instruction counts mirror ``repro_torch.compiler.codegen`` (DataMove + AddrCyc +
optional PRM + REQ/ACK handshakes per stream); dynamic weight-chunk issue
decodes are added by the compile driver once the weight schedule is known.

Profiles are computed per PU *type* (PU1x / PU2x); weight-streaming stalls are
handled separately by ``repro_torch.compiler.weights`` (Sec. IV-B). Like fusion,
profiling is config-independent: ``repro_torch.compiler.analyze`` runs it once per
graph content and every (a, b) placement of a DSE sweep reads the same
profile table.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.icu import DECODE_CYCLES  # per-instruction issue overhead (sys_clk)
from ..core.pu import PUSpec
from .graph import Graph, Node, OpType

_ATTN_OPS = (OpType.ATTN_SCORE, OpType.ATTN_CONTEXT)
_IM2COL_OPS = (OpType.CONV, OpType.FUSED_CONV_ADD, OpType.PROJ,
               OpType.FUSED_PROJ_ADD)


@dataclass(frozen=True)
class NodeProfile:
    nid: int
    t_compute: float
    t_load: float
    t_store: float
    t_residual: float
    # per-group instruction decode time (seconds) — see module docstring
    t_ld_decode: float = 0.0
    t_cp_decode: float = 0.0
    t_st_decode: float = 0.0

    @property
    def t_node(self) -> float:
        return max(
            self.t_residual + self.t_compute + self.t_cp_decode,
            self.t_load + self.t_ld_decode,
            self.t_store + self.t_st_decode,
        )


def instruction_counts(g: Graph, nd: Node) -> tuple[int, int, int]:
    """Per-round (LD, CP, ST) instruction counts this node contributes,
    mirroring the emission rules of ``repro_torch.compiler.codegen``."""
    ld = 0
    if nd.inputs:
        ld += 2  # DataMove + AddrCyc for the primary input
        if nd.kernel != (1, 1) and nd.op in _IM2COL_OPS:
            ld += 1  # IM2COL_PRM
        elif nd.stride != (1, 1):
            ld += 1  # STRIDE_PRM
        if nd.inputs[0] not in g.input_tensors:
            ld += 2  # WAIT_REQ + SEND_ACK
        side = list(nd.inputs[1:])
        if nd.residual_input is not None:
            side.append(nd.residual_input)
        ld += 2 * sum(1 for t in side if t not in g.input_tensors)
    cp = 1  # Compute
    if nd.op in _ATTN_OPS:
        cp += 3  # URAM_PRM + WEIGHTS_ADM + AddrCyc (weight-port stream)
    elif nd.residual_input is not None or len(nd.inputs) > 1:
        cp += 3  # RES_ADD PRM + ADM + AddrCyc
    st = 0
    for out in nd.outputs:
        st += 2  # DataMove + AddrCyc
        if out not in g.output_tensors:
            st += 2 * len(g.consumers_of(out))  # WAIT_ACK + SEND_REQ each
    return ld, cp, st


def profile_node(g: Graph, nd: Node, pu: PUSpec) -> NodeProfile:
    t_cp = pu.gemm_seconds(nd.m, nd.n, nd.k) if (nd.m and nd.n and nd.k) else 0.0

    primary = nd.inputs[0] if nd.inputs else None
    t_ld = pu.adm_seconds(g.tensors[primary].nbytes_padded) if primary is not None else 0.0
    # per-round store bytes: a K/V-cache producer appends one row per round
    # (decode), everything else stores the whole tensor. One ADM per output
    # tensor, each paying its own transfer-latency floor (broadcast stores
    # drain the out slot with back-to-back transfers, not one big one).
    t_st = sum(pu.adm_seconds(g.tensors[t].write_bytes) for t in nd.outputs
               if g.tensors[t].write_bytes)

    # CP-issued async side streams, one ADM (with its own floor) each:
    # the residual shortcut plus — for non-attention two-input nodes — the
    # second operand. Attention second operands go through the SA weight
    # port instead (node-granular stall model in repro_torch.compiler.weights).
    side = [nd.residual_input] if nd.residual_input is not None else []
    if nd.op not in _ATTN_OPS and len(nd.inputs) > 1:
        side.append(nd.inputs[1])
    t_res = sum(pu.adm_seconds(g.tensors[t].nbytes_padded) for t in side)

    ld_i, cp_i, st_i = instruction_counts(g, nd)
    dec = DECODE_CYCLES / pu.sys_clk_hz
    return NodeProfile(nd.nid, t_cp, t_ld, t_st, t_res,
                       t_ld_decode=ld_i * dec, t_cp_decode=cp_i * dec,
                       t_st_decode=st_i * dec)


def profile_graph(g: Graph, pu_types: dict[str, PUSpec]) -> dict[str, dict[int, NodeProfile]]:
    """node profiles per PU kind: {kind: {nid: NodeProfile}}."""
    return {
        kind: {nd.nid: profile_node(g, nd, pu) for nd in g.nodes}
        for kind, pu in pu_types.items()
    }


def segment_time(profiles: dict[int, NodeProfile], nids: list[int]) -> float:
    """Steady-state round time of a contiguous node segment on one PU."""
    return sum(profiles[nid].t_node for nid in nids)
