"""Pipeline-parallel inference of the port: the paper's instruction-based
multi-PU coordination, executed on one card.

The planning side is that of ``repro.runtime.pipeline``: an analytic cost of
one layer, the balanced contiguous split of the layer stack into stages, and
the coordination pattern emitted as ISA programs, one PU per stage (LD:
WAIT_REQ, take the microbatch in, SEND_ACK; CP: compute; ST: WAIT_ACK, hand
the microbatch on, SEND_REQ; the B0/B1 ping-pong by BID and address cycling;
the two-ACK bypass prologue). The encoded programs are word for word the JAX
package's.

The executor runs those programs. Stage ``i`` walks its LD, CP and ST
programs once per microbatch (a program round): each Sync instruction is a
token operation, each DataMove a transfer of the microbatch's activation
(into or out of one of the two buffers of a stage boundary, the buffer picked
by the DataMove's cycled address), and the Compute instruction runs the
stage's layers. On the card each stage has its own CUDA stream and each token
is a CUDA event: SEND records it on the sender's stream, WAIT makes the
waiter's stream wait for it. On the CPU the same loop runs the same tokens
with no streams. On both, a token counts its sends not yet waited for (the
ICU's REQ/ACK LUTRAM entry), and a WAIT on a token with no such send raises:
the host runs the programs tick by tick (stage ``i`` runs microbatch
``t - i`` at tick ``t``), and a host order in which a WAIT comes before its
SEND would let a CUDA stream wait on nothing.

Unlike the JAX shard_map executor, which runs one program on every device of
a mesh, this one runs every stage on one card. ``pipeline_ranks`` runs one
stage a rank, its tokens as messages between processes; both executors walk
the programs with ``walk_stage``.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from .. import hw
from .._device import resolve_device
from ..tree import tree_map
from ..configs.base import ArchConfig
from ..core.isa import AddrCyc, Compute, DataMove, Group, Opcode, Sync
from ..core.program import Program, PUProgram
from ..models import transformer as tf
from ..models.layers import embed

SYNC_OPS = ("WAIT_REQ", "SEND_ACK", "WAIT_ACK", "SEND_REQ")
_ROADMAP_ITEM = "a deliberate difference, ROADMAP queue 3: uniform dense stacks only"


# ---------------------------------------------------------- analytic costs --
def layer_cost_seconds(cfg: ArchConfig, seq_len: int, batch: int, chips: int = 1, *,
                       peak_flops: float = hw.FP32_FLOPS,
                       hbm_bw: float = hw.HBM_BYTES_PER_S) -> float:
    """Roofline max(compute, memory) for one transformer layer: the formula of
    ``repro/runtime/pipeline.py:55-70`` (which counts 2 bytes a weight and an
    activation value), at the H100's rates. The default rate is fp32 on the
    CUDA cores (``hw.FP32_FLOPS``), since the port serves in fp32 with TF32
    off; pass ``hw.BF16_TENSOR_FLOPS`` for bf16 weights."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    H, G = cfg.num_heads, cfg.num_kv_heads
    tokens = seq_len * batch
    gate = 2 if cfg.mlp in ("swiglu", "geglu") else 1
    mlp_flops = 2 * tokens * d * f * (gate + 1)
    attn_proj = 2 * tokens * d * hd * (H + 2 * G) + 2 * tokens * H * hd * d
    attn_scores = 4 * tokens * min(seq_len, cfg.window if cfg.attn == "swa" else seq_len) * H * hd
    if cfg.family == "moe":
        mlp_flops *= cfg.top_k
    flops = (mlp_flops + attn_proj + attn_scores) / chips
    w_bytes = 2 * (d * f * (gate + 1) * (cfg.n_experts or 1) + d * hd * (H + 2 * G) + H * hd * d) / chips
    act_bytes = 2 * tokens * d * 6 / chips
    return max(flops / peak_flops, (w_bytes + act_bytes) / hbm_bw)


# ----------------------------------------------------------------- planner --
@dataclass
class PipelinePlan:
    cfg: ArchConfig
    n_stages: int
    microbatches: int
    layers_per_stage: int  # padded (uniform, as the JAX executor runs it)
    boundaries: list[int]  # balanced contiguous layer ranges
    stage_time_s: float  # analytic steady-state stage time (H100 rates)
    programs: list[PUProgram] = field(default_factory=list)

    @property
    def predicted_throughput(self) -> float:
        """Microbatches a second in the steady state."""
        return 1.0 / self.stage_time_s if self.stage_time_s else 0.0

    @property
    def predicted_latency(self) -> float:
        """Seconds from the first microbatch in to the last one out."""
        return (self.n_stages + self.microbatches - 1) * self.stage_time_s


def plan_pipeline(cfg: ArchConfig, *, n_stages: int, microbatches: int,
                  seq_len: int, microbatch_size: int) -> PipelinePlan:
    """Split the layer stack into contiguous stages (``repro/runtime/
    pipeline.py:92-123``): for uniform layers the balanced cut is optimal.
    Every stage runs on one card, so a layer's cost is that of one chip."""
    L = cfg.num_layers
    per = layer_cost_seconds(cfg, seq_len, microbatch_size)
    base = L // n_stages
    extra = L % n_stages
    boundaries, acc = [0], 0
    for s in range(n_stages):
        acc += base + (1 if s < extra else 0)
        boundaries.append(acc)
    lps = math.ceil(L / n_stages)
    plan = PipelinePlan(
        cfg=cfg,
        n_stages=n_stages,
        microbatches=microbatches,
        layers_per_stage=lps,
        boundaries=boundaries,
        stage_time_s=lps * per,
    )
    plan.programs = emit_stage_programs(plan)
    return plan


def emit_stage_programs(plan: PipelinePlan) -> list[PUProgram]:
    """The coordination pattern as ISA programs, one PU per stage
    (``repro/runtime/pipeline.py:126-179``, instruction for instruction)."""
    progs = []
    S, M = plan.n_stages, plan.microbatches
    cfg = plan.cfg
    mb_bytes = 64 * 1024  # symbolic microbatch activation footprint
    region = lambda s: 0x100_0000 * (s + 1)  # boundary tensor base per edge

    for s in range(S):
        first, last = s == 0, s == S - 1
        n_layers = plan.boundaries[s + 1] - plan.boundaries[s]

        ld_ops: list = []
        if not first:
            ld_ops.append(Sync(op=Opcode.WAIT_REQ, pid=s - 1, bid=0, base_bid=0, nc=1, ic=1))
        ld_ops += [
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=region(s), length=mb_bytes, channel=(2 * s) % 32),
            AddrCyc(ba=region(s), aoffs=mb_bytes, nc=1, ic=1),
        ]
        if not first:
            ld_ops.append(Sync(op=Opcode.SEND_ACK, pid=s - 1, bid=0, base_bid=0, nc=1, ic=1))

        # one aggregate GEMM per round (layer count folds into n)
        cp_ops = [
            Compute(
                m=min(cfg.d_model, 4095),
                n=min(1024 * max(1, n_layers), 65535),
                k=min(cfg.d_ff, 16383),
            )
        ]

        st_ops: list = []
        if not last:
            st_ops.append(Sync(op=Opcode.WAIT_ACK, pid=s + 1, bid=0, base_bid=0, nc=1, ic=1))
        st_ops += [
            DataMove(op=Opcode.LINEAR_ADM, cur_ba=region(s + 1), length=mb_bytes, channel=(2 * s + 1) % 32),
            AddrCyc(ba=region(s + 1), aoffs=mb_bytes, nc=1, ic=1),
        ]
        if not last:
            st_ops.append(Sync(op=Opcode.SEND_REQ, pid=s + 1, bid=0, base_bid=0, nc=1, ic=1))

        # ACK-bypass prologue: this stage pre-authorizes its upstream
        # producer's two boundary buffers (Fig. 3 pattern).
        prologue = (
            [Sync(op=Opcode.SEND_ACK, pid=s - 1, bid=b, nc=0) for b in (0, 1)]
            if not first
            else []
        )
        ld = Program.assemble(Group.LD, prologue + ld_ops, rounds=M,
                              loop_ba=len(prologue), name=f"stage{s}.LD")
        cp = Program.assemble(Group.CP, cp_ops, rounds=M, name=f"stage{s}.CP")
        st = Program.assemble(Group.ST, st_ops, rounds=M, name=f"stage{s}.ST")
        progs.append(PUProgram(s, ld, cp, st, label=f"stage{s}"))
    return progs


def program_sync_counts(plan: PipelinePlan) -> list[dict[str, int]]:
    """The token operations each stage's programs prescribe over all their
    rounds: the instructions before ``ICU_BA`` run once, the rest once a round."""
    out = []
    for pu in plan.programs:
        counts = dict.fromkeys(SYNC_OPS, 0)
        for prog in (pu.ld, pu.cp, pu.st):
            pc = prog.progctrl
            for k, inst in enumerate(prog.instructions):
                if isinstance(inst, Sync):
                    counts[inst.op.name] += 1 if k < pc.icu_ba else pc.nr
        out.append(counts)
    return out


# ---------------------------------------------------------------- executor --
def _check_uniform_dense(cfg: ArchConfig) -> None:
    """The JAX executor takes one uniform stack (``assert len(blocks) == 1``,
    ``repro/runtime/pipeline.py:190``) and runs every layer as ``dense``; the
    port refuses any other stack by name instead of running it wrongly."""
    plan = tf.layer_plan(cfg)
    if cfg.frontend != "tokens" or len(plan) != 1 or plan[0].kind != "dense":
        kinds = [b.kind for b in plan]
        raise ValueError(f"{cfg.name}: blocks {kinds}, frontend {cfg.frontend!r}; the "
                         f"pipeline executor takes one uniform dense stack ({_ROADMAP_ITEM})")


def stack_stage_params(cfg: ArchConfig, params: dict, plan: PipelinePlan) -> dict:
    """Restack the layer params (L, ...) -> (S, layers_per_stage, ...), zero
    padding a ragged last stage (``repro/runtime/pipeline.py:186-203``). With
    no padding the stacked leaves are views of ``params``'s."""
    _check_uniform_dense(cfg)
    S, lps = plan.n_stages, plan.layers_per_stage

    def restack(x: torch.Tensor) -> torch.Tensor:
        pad = S * lps - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        return x.reshape(S, lps, *x.shape[1:])

    out = dict(params)
    out["blocks"] = [tree_map(restack, params["blocks"][0])]
    return out


def walk_stage(pu: PUProgram, prologue: bool, counts: dict[str, int], *, sync, move,
               compute) -> None:
    """One pass over a stage's LD, CP and ST programs, in that order: the
    instructions before ``ICU_BA`` (the prologue, run once) or those from
    ``ICU_BA`` on (one round). Each Sync is a token operation, ``sync(inst)``,
    counted by name in ``counts``; each DataMove, with the AddrCyc after it,
    hands the round's activation in or on, ``move(group, bid)``, the buffer
    picked by the DataMove's cycled address; the Compute instruction runs the
    stage's layers, ``compute()``. The programs' dynamic state (BIDs and
    addresses) steps as the ICU's does, so ``pu`` is a clone the caller owns."""
    for prog in (pu.ld, pu.cp, pu.st):
        insts = prog.instructions
        icu_ba = prog.progctrl.icu_ba
        k, end = (0, icu_ba) if prologue else (icu_ba, len(insts))
        while k < end:
            inst = insts[k]
            if isinstance(inst, Sync):
                sync(inst)
                counts[inst.op.name] += 1
                inst.step()
            elif isinstance(inst, DataMove):
                cyc = insts[k + 1] if k + 1 < end else None
                if not isinstance(cyc, AddrCyc):
                    raise ValueError(f"{prog.name}[{k}]: a DataMove without the "
                                     "AddrCyc that picks its buffer")
                move(prog.group, (inst.cur_ba - cyc.ba) // cyc.aoffs)
                inst.cur_ba = cyc.step(inst.cur_ba)
                k += 1
            elif isinstance(inst, Compute):
                compute()
            k += 1


def check_programs(plan: PipelinePlan) -> None:
    """A program for each stage, each valid, each running one round a
    microbatch."""
    if len(plan.programs) != plan.n_stages:
        raise ValueError(f"{len(plan.programs)} programs for {plan.n_stages} stages")
    for pu in plan.programs:
        pu.validate()
        for prog in (pu.ld, pu.cp, pu.st):
            if prog.progctrl.nr != plan.microbatches:
                raise ValueError(f"{prog.name} runs {prog.progctrl.nr} rounds, not "
                                 f"{plan.microbatches} microbatches")


class _Token:
    """One REQ or ACK token of a (sender, receiver, BID): the number of sends
    not yet waited for and, on the card, the event of the latest send."""

    def __init__(self, name: str, event: Optional[torch.cuda.Event]):
        self.name, self.event, self.pending = name, event, 0

    def send(self, stream: Optional[torch.cuda.Stream]) -> None:
        if self.event is not None:
            self.event.record(stream)
        self.pending += 1

    def wait(self, stream: Optional[torch.cuda.Stream]) -> None:
        if self.pending == 0:
            raise RuntimeError(f"WAIT on {self.name}, which was not sent: the programs' "
                               "host order is broken")
        self.pending -= 1
        if self.event is not None:
            stream.wait_event(self.event)


class PipelineForward:
    """``fn(stage_params, tokens (M, mb, s)) -> logits (M, mb, s, V)`` fp32,
    as ``repro/runtime/pipeline.py:206-292`` computes them.

    Stage ``i`` runs layers ``i * lps ... min((i + 1) * lps, L)`` of the
    restacked params, the split of the JAX stage body (``layer_base =
    stage_id * lps``, padded layers skipped). It is the split of
    ``plan.boundaries`` only where ``L % S`` is 0 or ``S - 1``; the logits
    are the same either way. After a call, ``counts[i]`` holds the token
    operations stage ``i`` performed (by name, ``SYNC_OPS``) and, on the card,
    ``stage_ms[i]`` the device time of its Compute instruction in each round
    (CUDA events on its stream)."""

    def __init__(self, cfg: ArchConfig, plan: PipelinePlan, device=None):
        _check_uniform_dense(cfg)
        check_programs(plan)
        self.cfg, self.plan, self.device = cfg, plan, resolve_device(device)
        self.counts: list[dict[str, int]] = []
        self.stage_ms: list[list[float]] = []

    def __call__(self, stage_params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg, plan, dev = self.cfg, self.plan, self.device
        S, M, lps, L = plan.n_stages, plan.microbatches, plan.layers_per_stage, cfg.num_layers
        if tokens.dim() != 3 or tokens.shape[0] != M:
            raise ValueError(f"want tokens (M, mb, s) with M = {M}; got {tuple(tokens.shape)}")
        if tokens.device.type != dev.type:
            raise ValueError(f"tokens on {tokens.device}, the executor runs on {dev}")
        mb, s = tokens.shape[1], tokens.shape[2]
        dev = tokens.device
        cuda = dev.type == "cuda"
        dtype = stage_params["embed"].dtype
        blocks = stage_params["blocks"][0]
        layers = tree_map(lambda x: x.flatten(0, 1), blocks)  # (S * lps, ...) views

        # everything that crosses streams is allocated here, on the caller's
        # stream, before the stage streams start, and freed only after they
        # have joined it: the boundary buffers (B0/B1 of each edge), each
        # stage's input buffer and the logits
        caller = torch.cuda.current_stream(dev) if cuda else None
        streams = [torch.cuda.Stream(dev) for _ in range(S)] if cuda else [None] * S
        bufs = [[torch.empty((mb, s, cfg.d_model), dtype=dtype, device=dev) for _ in range(2)]
                for _ in range(S - 1)]
        inbuf = [None] + [torch.empty((mb, s, cfg.d_model), dtype=dtype, device=dev)
                          for _ in range(S - 1)]
        logits = torch.empty((M, mb, s, cfg.vocab_size), dtype=torch.float32, device=dev)
        if cuda:
            for st in streams:
                st.wait_stream(caller)

        tokens_of: dict[tuple, _Token] = {}
        counts = [dict.fromkeys(SYNC_OPS, 0) for _ in range(S)]
        events: list[list[tuple]] = [[] for _ in range(S)]
        progs = [pu.clone() for pu in plan.programs]  # dynamic state is rewritten per round
        h: list[Optional[torch.Tensor]] = [None] * S

        def token(kind: str, src: int, dst: int, bid: int) -> _Token:
            key = (kind, src, dst, bid)
            if key not in tokens_of:
                tokens_of[key] = _Token(f"{kind.upper()} {src}->{dst} B{bid}",
                                        torch.cuda.Event() if cuda else None)
            return tokens_of[key]

        def sync(i: int, inst: Sync) -> None:
            src, dst = (i, inst.pid) if inst.is_send else (inst.pid, i)
            tok = token(inst.kind, src, dst, inst.bid)
            if inst.is_send:
                tok.send(streams[i])
            else:
                tok.wait(streams[i])

        def move(i: int, r: int, group: Group, b: int) -> None:
            if group == Group.LD:  # take microbatch r in
                if i == 0:
                    h[i] = embed(stage_params["embed"], tokens[r])
                else:
                    h[i] = inbuf[i].copy_(bufs[i - 1][b])
            elif i == S - 1:  # hand it on: the last stage writes the logits
                logits[r].copy_(tf.final_logits(cfg, stage_params, h[i]).float())
            else:
                bufs[i][b].copy_(h[i])

        def compute(i: int) -> None:
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record(streams[i])
            h[i] = tf.forward_layers(cfg, layers, i * lps, min((i + 1) * lps, L), h[i])
            if cuda:
                ev[1].record(streams[i])
                events[i].append(ev)

        def run(i: int, r: int, prologue: bool) -> None:
            """Stage i's programs: the prologue (once), or round r."""
            walk_stage(progs[i], prologue, counts[i], sync=lambda inst: sync(i, inst),
                       move=lambda group, b: move(i, r, group, b),
                       compute=lambda: compute(i))

        def on(i: int):
            return torch.cuda.stream(streams[i]) if cuda else contextlib.nullcontext()

        # every PU starts its programs together: the prologues (the two-ACK
        # bypass) run first, then tick t runs round t - i on stage i
        for i in range(S):
            with on(i):
                run(i, 0, prologue=True)
        for t in range(M + S - 1):
            for i in range(S):
                if 0 <= t - i < M:
                    with on(i):
                        run(i, t - i, prologue=False)
        if cuda:
            for st in streams:
                caller.wait_stream(st)
            torch.cuda.synchronize(dev)
        self.counts = counts
        self.stage_ms = [[a.elapsed_time(b) for a, b in evs] for evs in events]
        return logits


def make_pipeline_forward(cfg: ArchConfig, plan: PipelinePlan, device=None) -> PipelineForward:
    """The pipelined forward of ``plan`` (see ``PipelineForward``); ``device``
    None means CUDA, as for every entry point of the port."""
    return PipelineForward(cfg, plan, device)
