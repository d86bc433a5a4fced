"""Pipeline memory optimization (paper Sec. IV-C, Fig. 4(e)).

1. Buffer requirement analysis (stage-distance method): for each tensor T,
   map producer/consumer PUs to pipeline stages and compute

       beta(T) = max over consumers (stage_c - stage_p) + 1

   The +1 buffer lets producers write new data while consumers read
   previously loaded data. Graph inputs/outputs (A/C-regions) get ``n_io``
   cyclic regions coordinated with the PCIe host. K/V cache tensors
   (autoregressive decode) keep the stage-distance *credit* depth for the
   REQ/ACK handshake but occupy a single append-only region sized for the
   full window — per-round writes append one row while reads cover the
   growing valid prefix, so no region copies are needed.

2. Tensor liveness analysis: simulate the steady-state pipeline schedule
   (node-to-PU mappings x profiled times) to find the temporal access window
   of every tensor; tensors with overlapping same-type accesses (read-read /
   write-write) — and cross-PU forks feeding one consumer — must land on
   different HBM channels [33]. Greedy interval-graph coloring assigns
   channels; each PU also gets a dedicated weight-streaming channel.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

from ..core.pu import N_HBM_CHANNELS
from .graph import Graph
from .partition import Partition
from .profiler import NodeProfile


@dataclass
class TensorPlan:
    tid: int
    beta: int  # number of cyclic buffer regions (sync credit depth)
    region_bytes: int  # 64B-aligned size of one region
    base_addr: int = 0  # HBM base of region 0
    bid_base: int = 0  # global BID range [bid_base, bid_base+beta-1]
    read_channel: int = 0
    write_channel: int = 0
    producer_stage: Optional[int] = None
    consumer_stages: tuple[int, ...] = ()
    kind: str = "intermediate"  # "input" | "output" | "intermediate" | "kv"

    @property
    def n_regions(self) -> int:
        """Physical HBM regions. A K/V cache is *one* append-only region
        regardless of its sync credit depth: rows written this round are
        disjoint from the prefix earlier rounds read, so the REQ/ACK credits
        (beta) pipeline producer and consumer without region copies."""
        return 1 if self.kind == "kv" else self.beta


@dataclass
class MemoryPlan:
    tensors: dict[int, TensorPlan]
    weight_channel: dict[int, int]  # stage index -> dedicated channel
    total_hbm_bytes: int
    n_channels_used: int

    def plan_of(self, tid: int) -> TensorPlan:
        return self.tensors[tid]


def buffer_requirements(g: Graph, part: Partition, n_io: int = 4) -> dict[int, TensorPlan]:
    stage_of = part.stage_of_node()
    plans: dict[int, TensorPlan] = {}
    for tid, tinfo in g.tensors.items():
        producer = g.producer_of(tid)
        consumers = g.consumers_of(tid)
        if tinfo.is_kv_cache and (tid in g.input_tensors or tid in g.output_tensors):
            # host A/C-region cycling (n_io regions) and append-only
            # single-region addressing are mutually exclusive
            raise ValueError(
                f"K/V cache tensor {tinfo.name!r} cannot be a graph input/output"
            )
        if tid in g.input_tensors:
            beta, kind = n_io, "input"
            pstage = None
            cstages = tuple(sorted({stage_of[c.nid] for c in consumers}))
        elif tid in g.output_tensors:
            beta, kind = n_io, "output"
            pstage = stage_of[producer.nid] if producer else None
            cstages = ()
        else:
            if producer is None or not consumers:
                continue  # dead tensor (fused away)
            pstage = stage_of[producer.nid]
            cstages = tuple(sorted({stage_of[c.nid] for c in consumers}))
            dist = max(cs - pstage for cs in cstages)
            beta = dist + 1
            kind = "kv" if tinfo.is_kv_cache else "intermediate"
        plans[tid] = TensorPlan(
            tid=tid,
            beta=beta,
            region_bytes=tinfo.kv_region_bytes if tinfo.is_kv_cache
            else tinfo.nbytes_padded,
            producer_stage=pstage,
            consumer_stages=cstages,
            kind=kind,
        )
    return plans


@dataclass(frozen=True)
class _Access:
    tid: int
    mode: str  # "r" | "w"
    start: float
    end: float
    stage: int


def _steady_state_accesses(
    g: Graph, part: Partition, profiles: dict[str, dict[int, NodeProfile]]
) -> list[_Access]:
    """Per-round access windows, all stages concurrent (steady state).

    Within a stage, node j's LD window precedes its compute; its ST window
    follows. Windows are folded modulo the round time (the max stage time)."""
    accesses: list[_Access] = []
    t_round = part.max_stage_time or 1e-9
    for s in part.stages:
        prof = profiles[s.pu_kind]
        t = 0.0
        for nid in s.nids:
            nd = g.node_by_id(nid)
            p = prof[nid]
            t_next = t + p.t_node
            for tid in nd.inputs:
                accesses.append(_Access(tid, "r", t % t_round, min(t + p.t_load, t_next) % t_round or t_round, s.index))
            if nd.residual_input is not None:
                accesses.append(_Access(nd.residual_input, "r", t % t_round, t_next % t_round or t_round, s.index))
            for tid in nd.outputs:
                st_start = max(t, t_next - p.t_store)
                accesses.append(_Access(tid, "w", st_start % t_round, t_next % t_round or t_round, s.index))
            t = t_next
    return accesses


def _windows_overlap(a: _Access, b: _Access, t_round: float) -> bool:
    """Overlap of two (possibly wrapped) circular intervals."""

    def unwrap(x: _Access) -> list[tuple[float, float]]:
        if x.end >= x.start:
            return [(x.start, x.end)]
        return [(x.start, t_round), (0.0, x.end)]

    for sa, ea in unwrap(a):
        for sb, eb in unwrap(b):
            if sa < eb and sb < ea:
                return True
    return False


def assign_channels(
    g: Graph,
    part: Partition,
    plans: dict[int, TensorPlan],
    profiles: dict[str, dict[int, NodeProfile]],
    n_channels: int = N_HBM_CHANNELS,
    channel_pool: Optional[list[int]] = None,
) -> MemoryPlan:
    """Liveness-driven channel coloring + address allocation.

    ``channel_pool`` restricts this deployment to a subset of the HBM
    channels — multi-batch schedules give each member pipeline a disjoint
    pool so that concurrent batches never contend (Sec. V-A)."""
    chans = channel_pool if channel_pool is not None else list(range(n_channels))
    n_stages = len(part.stages)
    # Dedicated weight-stream channel per stage (PU), from the pool front.
    n_wchan = max(1, min(n_stages, len(chans) // 2))
    weight_channel = {s.index: chans[s.index % n_wchan] for s in part.stages}
    first_tensor_channel = n_wchan if n_wchan < len(chans) - 4 else len(chans) // 2

    accesses = _steady_state_accesses(g, part, profiles)
    t_round = part.max_stage_time or 1e-9

    # Conflict graph over (tid, mode) access streams.
    streams = sorted({(a.tid, a.mode) for a in accesses if a.tid in plans})
    by_stream: dict[tuple[int, str], list[_Access]] = {s: [] for s in streams}
    for a in accesses:
        if (a.tid, a.mode) in by_stream:
            by_stream[(a.tid, a.mode)].append(a)

    conflicts: dict[tuple[int, str], set[tuple[int, str]]] = {s: set() for s in streams}
    for s1, s2 in itertools.combinations(streams, 2):
        # An HBM channel is one port: concurrent transfers serialize on it
        # regardless of direction, so *any* two streams with overlapping
        # steady-state windows — read-read, write-write, or read-write
        # (e.g. a stage's input fetch against its own output store, or a
        # producer's store against the consumer's load of the same tensor)
        # — must land on different channels or the round period stretches
        # by the full transfer time of whichever stream loses arbitration.
        hit = any(
            _windows_overlap(a, b, t_round)
            for a in by_stream[s1]
            for b in by_stream[s2]
        )
        if hit:
            conflicts[s1].add(s2)
            conflicts[s2].add(s1)

    # Cross-PU forks: tensors read by one consumer node from different
    # producers (primary + residual) must use distinct channels.
    for nd in g.nodes:
        ins = [t for t in nd.inputs if t in plans]
        if nd.residual_input is not None and nd.residual_input in plans:
            ins.append(nd.residual_input)
        for t1, t2 in itertools.combinations(ins, 2):
            s1, s2 = (t1, "r"), (t2, "r")
            if s1 in conflicts and s2 in conflicts:
                conflicts[s1].add(s2)
                conflicts[s2].add(s1)

    # Greedy coloring (highest degree first).
    color: dict[tuple[int, str], int] = {}
    pool = chans[first_tensor_channel:]
    if not pool:
        pool = list(chans)
    for s in sorted(streams, key=lambda s: -len(conflicts[s])):
        used = {color[o] for o in conflicts[s] if o in color}
        pick = next((c for c in pool if c not in used), None)
        if pick is None:
            # channel pressure: fall back to least-loaded color
            loads = {c: sum(1 for v in color.values() if v == c) for c in pool}
            pick = min(pool, key=lambda c: loads[c])
        color[s] = pick

    # Address allocation: bump allocator over the HBM space.
    addr = 0x0100_0000  # leave low space for weights/host scratch

    def align(x: int) -> int:
        return (x + 4095) // 4096 * 4096

    for tid, plan in sorted(plans.items()):
        plan.base_addr = addr
        addr += align(plan.region_bytes) * plan.n_regions
        plan.read_channel = color.get((tid, "r"), pool[0])
        plan.write_channel = color.get((tid, "w"), pool[-1])

    return MemoryPlan(
        tensors=plans,
        weight_channel=weight_channel,
        total_hbm_bytes=addr,
        n_channels_used=len(set(color.values())) if color else 0,
    )
