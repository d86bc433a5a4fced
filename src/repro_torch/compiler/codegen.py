"""Instruction generation (paper Sec. IV-D, Fig. 4(f)).

Lowers the optimized node-to-PU assignment + memory plan into executable
LD/CP/ST instruction programs per PU:

  * cyclic buffering encoded as BID rotation in Sync instructions and
    AddrCyc region cycling on every DataMove;
  * inter- and intra-PU producer->consumer edges get WAIT_REQ/SEND_ACK
    (consumer LD) <-> WAIT_ACK/SEND_REQ (producer ST) handshakes — intra-PU
    tokens use the 2-cycle same-PU path, and intra-PU REQs are emitted
    *before* the store ADM (stream-start authorization, enabling the
    tile-grained write->read streaming through HBM);
  * consumers pre-authorize producers with an ACK-bypass prologue (one
    SEND_ACK per buffer region, addresses before the ProgCtrl loop base);
  * SMOF dynamic weight chunks are issued with one-node lookahead so chunk
    loads overlap the previous node's GEMM; the Compute.wchunks field
    carries the URAM interlock;
  * graph inputs/outputs use plain cyclic A/C-region access (PCIe host
    coordinated), per Sec. III-C.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.isa import (
    AddrCyc,
    AddrLen,
    Compute,
    Config,
    DataMove,
    Group,
    Instruction,
    Opcode,
    Sync,
)
from ..core.program import Program, PUProgram
from ..core.pu import PUSpec
from .graph import Graph, Node, OpType
from .memory import MemoryPlan, TensorPlan
from .partition import Partition
from .weights import CHUNK_BYTES, WeightSchedule


def _align(x: int, a: int = 4096) -> int:
    return (x + a - 1) // a * a


_IM2COL_OPS = (OpType.CONV, OpType.FUSED_CONV_ADD, OpType.PROJ,
               OpType.FUSED_PROJ_ADD)  # PROJ with a kernel = patch embedding


def _adm_op(nd: Node) -> Opcode:
    if nd.kernel != (1, 1) and nd.op in _IM2COL_OPS:
        return Opcode.IM2COL_ADM
    if nd.stride != (1, 1):
        return Opcode.STRIDE_ADM
    return Opcode.LINEAR_ADM


def _adm_prm(op: Opcode, nd: Node) -> Config | None:
    if op is Opcode.IM2COL_ADM:
        return Config(op=Opcode.IM2COL_PRM, param0=nd.kernel[0] * 16 + nd.kernel[1],
                      param1=nd.stride[0], param2=nd.padding[0], param3=0)
    if op is Opcode.STRIDE_ADM:
        return Config(op=Opcode.STRIDE_PRM, param0=nd.stride[0])
    return None


@dataclass
class StageCodegenCtx:
    pid: int
    spec: PUSpec
    ld: list[Instruction] = field(default_factory=list)
    ld_prologue: list[Instruction] = field(default_factory=list)
    cp: list[Instruction] = field(default_factory=list)
    st: list[Instruction] = field(default_factory=list)


def generate_programs(
    g: Graph,
    part: Partition,
    mem: MemoryPlan,
    wscheds: dict[int, WeightSchedule],
    pid_map: dict[int, int],
    pu_specs: dict[int, PUSpec],
    *,
    rounds: int,
) -> list[PUProgram]:
    """Emit one PUProgram per (non-empty) pipeline stage."""
    stage_of = part.stage_of_node()

    # ---- global BID allocation: one contiguous range per tensor -----------
    next_bid = 0
    for tid in sorted(mem.tensors):
        plan = mem.tensors[tid]
        plan.bid_base = next_bid
        next_bid += plan.beta

    producer_pid: dict[int, int] = {}  # tid -> producing PU
    for nd in g.nodes:
        for tid in nd.outputs:
            if nd.nid in stage_of:
                producer_pid[tid] = pid_map[stage_of[nd.nid]]

    ctxs: dict[int, StageCodegenCtx] = {}
    for s in part.stages:
        if not s.nids:
            continue
        pid = pid_map[s.index]
        ctx = StageCodegenCtx(pid=pid, spec=pu_specs[pid])
        ctxs[s.index] = ctx
        wsched = wscheds.get(s.index)
        dyn_chunks = wsched.node_dynamic_chunks() if wsched else {}

        nodes = [g.node_by_id(nid) for nid in s.nids]

        # ---------------- LD + ST streams -------------------------------
        for nd in nodes:
            primary = nd.inputs[0] if nd.inputs else None
            extra_inputs = list(nd.inputs[1:])
            residual = nd.residual_input

            # primary input
            if primary is not None:
                plan = mem.tensors[primary]
                if plan.kind != "input":
                    src = producer_pid[primary]
                    ctx.ld.append(_wait(Opcode.WAIT_REQ, src, plan))
                    _emit_read(ctx.ld, nd, plan)
                    ctx.ld.append(_sync(Opcode.SEND_ACK, src, plan))
                    _prologue_acks(ctx.ld_prologue, src, plan)
                else:
                    _emit_read(ctx.ld, nd, plan)

            # residual / second input: CP does the ADM; LD handles the sync.
            for rtid in ([residual] if residual is not None else []) + extra_inputs:
                plan = mem.tensors[rtid]
                if plan.kind != "input":
                    src = producer_pid[rtid]
                    ctx.ld.append(_wait(Opcode.WAIT_REQ, src, plan))
                    ctx.ld.append(_sync(Opcode.SEND_ACK, src, plan))
                    _prologue_acks(ctx.ld_prologue, src, plan)

            # output stores — every output tensor is written (and, unless it
            # is a graph output, handshaken) per round, matching the
            # profiler's instruction_counts / store-byte accounting.
            for i, out_tid in enumerate(nd.outputs):
                # Broadcast store: one compute result drains to several HBM
                # tensors; every transfer but the node's last HOLDs the
                # output-buffer slot (re-reading it) so the slot accounting
                # stays one-per-compute.
                hold = i < len(nd.outputs) - 1
                oplan = mem.tensors[out_tid]
                otinfo = g.tensors[out_tid]
                consumers = [c for c in g.consumers_of(out_tid) if c.nid in stage_of]
                if oplan.kind == "output" or not consumers:
                    _emit_write(ctx.st, oplan, otinfo, hold=hold)
                    continue
                cons_pids = [pid_map[stage_of[c.nid]] for c in consumers]
                for cpid in cons_pids:
                    ctx.st.append(_wait(Opcode.WAIT_ACK, cpid, oplan))
                # stream-start REQ for same-PU consumers (write->read stream)
                for cpid in cons_pids:
                    if cpid == pid:
                        ctx.st.append(_sync(Opcode.SEND_REQ, cpid, oplan))
                _emit_write(ctx.st, oplan, otinfo, hold=hold)
                for cpid in cons_pids:
                    if cpid != pid:
                        ctx.st.append(_sync(Opcode.SEND_REQ, cpid, oplan))

        # ---------------- CP stream (1-node weight lookahead) ------------
        pending_cp: list[list[Instruction]] = []
        for nd in nodes:
            # 1) issue this node's dynamic weight chunks now (they overlap
            #    the previous node's GEMM, which is still queued behind).
            nchunks = dyn_chunks.get(nd.nid, 0)
            wchan = mem.weight_channel[s.index]
            for c in range(nchunks):
                ctx.cp.append(Config(op=Opcode.URAM_PRM, param0=c))
                ctx.cp.append(
                    DataMove(op=Opcode.WEIGHTS_ADM, cur_ba=0, length=CHUNK_BYTES, channel=wchan)
                )
            # attention GEMMs: the second operand (K for the score GEMM, V
            # for the context GEMM) is an *activation* streamed through the
            # SA weight port — one WEIGHTS_ADM over the producer's cyclic
            # region, counted in Compute.wchunks so the URAM read interlock
            # holds the GEMM until the stream has landed. A K/V cache operand
            # (autoregressive decode) keeps a fixed base address but its
            # transfer *length* advances one row per round (AddrLen).
            if nd.op in (OpType.ATTN_SCORE, OpType.ATTN_CONTEXT):
                splan = mem.tensors[nd.inputs[1]]
                stinfo = g.tensors[nd.inputs[1]]
                ctx.cp.append(Config(op=Opcode.URAM_PRM, param0=0))
                if stinfo.is_kv_cache:
                    row = stinfo.kv_row_stride
                    len0 = (stinfo.kv_base_rows + 1) * row
                    steps = stinfo.kv_steps
                    ctx.cp.append(
                        DataMove(op=Opcode.WEIGHTS_ADM, cur_ba=splan.base_addr,
                                 length=len0, channel=splan.read_channel)
                    )
                    ctx.cp.append(AddrLen(len_base=len0, loffs=row,
                                          nc=steps - 1, ic=steps - 1))
                else:
                    ctx.cp.append(
                        DataMove(op=Opcode.WEIGHTS_ADM, cur_ba=splan.base_addr,
                                 length=splan.region_bytes,
                                 channel=splan.read_channel)
                    )
                    ctx.cp.append(_addrcyc(splan))
                nchunks += 1
            # 2) flush the previous node's compute ops.
            if pending_cp:
                ctx.cp.extend(pending_cp.pop(0))
            # 3) queue this node's compute ops.
            ops: list[Instruction] = []
            if nd.op in (OpType.ATTN_SCORE, OpType.ATTN_CONTEXT):
                rtid = None  # second input already streamed via WEIGHTS_ADM
            else:
                rtid = nd.residual_input if nd.residual_input is not None else (
                    nd.inputs[1] if len(nd.inputs) > 1 else None
                )
            if rtid is not None:
                rplan = mem.tensors[rtid]
                ops.append(Config(op=Opcode.RES_ADD_STRIDE_PRM, param0=1))
                ops.append(
                    DataMove(
                        op=Opcode.RES_ADD_STRIDE_ADM,
                        cur_ba=rplan.base_addr,
                        length=rplan.region_bytes,
                        channel=rplan.read_channel,
                    )
                )
                ops.append(_addrcyc(rplan))
            ops.append(
                Compute(
                    m=nd.m,
                    n=nd.n,
                    k=nd.k,
                    relu=nd.relu,
                    add_enable=rtid is not None,
                    scale_shift=nd.scale_shift,
                    rounds=1,
                    wchunks=nchunks,
                )
            )
            pending_cp.append(ops)
        while pending_cp:
            ctx.cp.extend(pending_cp.pop(0))

    # ---- assemble -----------------------------------------------------------
    programs: list[PUProgram] = []
    for s in part.stages:
        if s.index not in ctxs:
            continue
        ctx = ctxs[s.index]
        ld_body = ctx.ld_prologue + ctx.ld
        ld = Program.assemble(Group.LD, ld_body, rounds=rounds,
                              loop_ba=len(ctx.ld_prologue), name=f"pu{ctx.pid}.LD")
        cp = Program.assemble(Group.CP, ctx.cp, rounds=rounds, name=f"pu{ctx.pid}.CP")
        st = Program.assemble(Group.ST, ctx.st, rounds=rounds, name=f"pu{ctx.pid}.ST")
        prog = PUProgram(ctx.pid, ld, cp, st, label=f"stage{s.index}")
        prog.validate()
        programs.append(prog)
    return programs


# ---------------------------------------------------------------- helpers --
def _sync(op: Opcode, pid: int, plan: TensorPlan) -> Sync:
    return Sync(op=op, pid=pid, bid=plan.bid_base, base_bid=plan.bid_base,
                nc=plan.beta - 1, ic=plan.beta - 1)


_wait = _sync


def _prologue_acks(prologue: list[Instruction], src: int, plan: TensorPlan) -> None:
    """ACK-bypass pre-authorization: one bypass ACK per buffer region."""
    for i in range(plan.beta):
        prologue.append(Sync(op=Opcode.SEND_ACK, pid=src, bid=plan.bid_base + i, nc=0))


def _addrcyc(plan: TensorPlan) -> AddrCyc:
    return AddrCyc(
        ba=plan.base_addr,
        aoffs=_align(plan.region_bytes),
        nc=plan.beta - 1,
        ic=plan.beta - 1,
    )


def _emit_read(body: list[Instruction], nd: Node, plan: TensorPlan) -> None:
    op = _adm_op(nd)
    prm = _adm_prm(op, nd)
    if prm is not None:
        body.append(prm)
    body.append(
        DataMove(op=op, cur_ba=plan.base_addr, length=plan.region_bytes,
                 channel=plan.read_channel)
    )
    body.append(_addrcyc(plan))


def _emit_write(body: list[Instruction], plan: TensorPlan,
                tinfo=None, hold: bool = False) -> None:
    if tinfo is not None and tinfo.is_kv_cache:
        # append-only K/V region: one row per round, the address advancing
        # from the end of the prefill prefix across the decode window, then
        # wrapping for the next sequence.
        row = tinfo.kv_row_stride
        ba = plan.base_addr + tinfo.kv_base_rows * row
        steps = tinfo.kv_steps
        body.append(
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=ba, length=row,
                     channel=plan.write_channel, hold=hold)
        )
        body.append(AddrCyc(ba=ba, aoffs=row, nc=steps - 1, ic=steps - 1))
        return
    body.append(
        DataMove(op=Opcode.LINEAR_ADM, cur_ba=plan.base_addr,
                 length=plan.region_bytes, channel=plan.write_channel,
                 hold=hold)
    )
    body.append(_addrcyc(plan))
