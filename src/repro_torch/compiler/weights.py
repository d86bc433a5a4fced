"""Weight-transfer scheduling (paper Sec. IV-B, Fig. 4(d2)), SMOF-inspired.

A PU's assigned subgraph often needs more weight data than its URAM capacity.
Weights are split per computational *tile* (64 output channels — the first SA
dimension) into fixed-size chunks; some chunks are allocated *offline*
(resident in URAM), the rest stream *dynamically* from HBM during execution,
scheduled so that chunks for tile t+1 load during tile t's execution.

Greedy deficit-based allocation: iteratively pin chunks of the node with the
highest *deficit* — the stall its dynamic loads would cause after overlap
hiding — until the capacity constraint binds:

    static_bytes + max over adjacent tile pairs (dyn(t) + dyn(t+1)) <= URAM

(dynamic chunks are evicted after their tile completes, so at most two
adjacent tiles' dynamic footprints coexist).

Stall accounting is *node*-granular, matching the instruction generator: all
of a node's dynamic chunks are issued with one-node lookahead and the node's
single Compute holds the URAM interlock, so the overlap window for node j's
chunk loads is node j-1's SA execution (zero for the first node: its loads
issue at round start, after the previous round's last GEMM has already
drained the CP group). Attention score/context GEMMs additionally stream
their second
operand through the SA weight port under the same interlock; that fixed,
non-pinnable load joins the node's chunk loads in the stall model. A
schedule built without node context (``node_order`` empty) falls back to the
older per-tile overlap estimate.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace

from ..core.pu import PUSpec, URAM_BYTES
from .graph import Graph, OpType

CHUNK_BYTES = URAM_BYTES  # one URAM per chunk

_ATTN_OPS = (OpType.ATTN_SCORE, OpType.ATTN_CONTEXT)


@dataclass
class Tile:
    nid: int
    tile_idx: int  # index within the node (64-out-channel slices)
    weight_bytes: int
    t_exec: float  # SA execution time of this tile
    n_chunks: int = 0
    static_chunks: int = 0  # allocated offline in URAM

    @property
    def dynamic_chunks(self) -> int:
        return self.n_chunks - self.static_chunks

    def dynamic_bytes(self) -> int:
        return self.dynamic_chunks * CHUNK_BYTES


def _node_stalls(
    order: list[int],
    node_exec: dict[int, float],
    node_stream: dict[int, float],
    node_dyn: dict[int, int],
    t_chunk_load: float,
) -> dict[int, float]:
    """Execution stall before each node's GEMM, per the codegen issue order:
    node j's dynamic chunks (and weight-port streams) load during node j-1's
    SA execution; whatever does not fit stalls node j. The *first* node has
    no overlap window at all: its loads are issued at round start, after the
    previous round's final Compute has already released the CP group (the
    Compute instruction holds the group until the GEMM drains, so nothing is
    "still queued behind" across the round boundary). Shared by the analytic
    model (`WeightSchedule.node_stalls`) and the greedy allocator's inner
    loop so the two can never drift."""
    stalls: dict[int, float] = {}
    for j, nid in enumerate(order):
        load = node_dyn.get(nid, 0) * t_chunk_load + node_stream.get(nid, 0.0)
        if load <= 0.0:
            continue
        overlap = node_exec.get(order[j - 1], 0.0) if j > 0 else 0.0
        s = load - overlap
        if s > 0.0:
            stalls[nid] = s
    return stalls


@dataclass
class WeightSchedule:
    tiles: list[Tile]
    pu_kind: str
    capacity_bytes: int
    t_chunk_load: float  # HBM->URAM time per chunk on the weight channel
    # node-granular stall context (the segment's full node order, each
    # node's SA execution time, and fixed weight-port streams — attention
    # second operands); empty for schedules built without node context.
    node_order: list[int] = field(default_factory=list)
    node_exec: dict[int, float] = field(default_factory=dict)
    node_stream: dict[int, float] = field(default_factory=dict)

    # -- derived -------------------------------------------------------------
    def stall_of(self, idx: int) -> float:
        """Per-tile overlap estimate (legacy; used when no node context is
        attached): tile idx's dynamic chunks load during tile idx-1's
        execution (cyclically across rounds for idx==0)."""
        t = self.tiles[idx]
        load = t.dynamic_chunks * self.t_chunk_load
        prev_exec = self.tiles[idx - 1].t_exec if self.tiles else 0.0
        return max(0.0, load - prev_exec)

    def node_stalls(self) -> dict[int, float]:
        """Execution stall before each node's GEMM (see ``_node_stalls``)."""
        return _node_stalls(self.node_order, self.node_exec, self.node_stream,
                            self.node_dynamic_chunks(), self.t_chunk_load)

    def total_stall(self) -> float:
        if self.node_order:
            return sum(self.node_stalls().values())
        return sum(self.stall_of(i) for i in range(len(self.tiles)))

    def static_bytes(self) -> int:
        return sum(t.static_chunks * CHUNK_BYTES for t in self.tiles)

    def worst_adjacent_dynamic(self) -> int:
        if not self.tiles:
            return 0
        n = len(self.tiles)
        if n == 1:
            return self.tiles[0].dynamic_bytes()
        return max(
            self.tiles[i].dynamic_bytes() + self.tiles[(i + 1) % n].dynamic_bytes()
            for i in range(n)
        )

    def feasible(self) -> bool:
        return self.static_bytes() + self.worst_adjacent_dynamic() <= self.capacity_bytes

    def fully_static(self) -> bool:
        return all(t.dynamic_chunks == 0 for t in self.tiles)

    def node_dynamic_chunks(self) -> dict[int, int]:
        """Dynamic chunk count per node (for Compute.wchunks interlocks)."""
        out: dict[int, int] = {}
        for t in self.tiles:
            out[t.nid] = out.get(t.nid, 0) + t.dynamic_chunks
        return out

    def rebound(self, nids: "list[int] | tuple[int, ...]") -> "WeightSchedule":
        """A copy positionally re-keyed onto ``nids`` — valid when the new
        segment's node shapes match this one's (same
        :func:`segment_shape_key`), in which case tiling, allocation and
        times are identical up to nid relabeling."""
        if len(nids) != len(self.node_order):
            raise ValueError("rebound() needs a same-length node segment")
        mapping = dict(zip(self.node_order, nids))
        return WeightSchedule(
            tiles=[replace(t, nid=mapping[t.nid]) for t in self.tiles],
            pu_kind=self.pu_kind,
            capacity_bytes=self.capacity_bytes,
            t_chunk_load=self.t_chunk_load,
            node_order=list(nids),
            node_exec={mapping[n]: v for n, v in self.node_exec.items()},
            node_stream={mapping[n]: v for n, v in self.node_stream.items()},
        )


def segment_shape_key(g: Graph, nids: "list[int] | tuple[int, ...]") -> tuple:
    """Shape signature of a node segment: exactly what ``schedule_weights``
    reads per node (GEMM dims, weight bytes, attention stream-operand
    bytes). Equal keys on the same PU kind yield identical schedules up to
    nid relabeling — the basis of the analysis-level shape cache that makes
    a 28-block transformer pay for one block's SMOF allocation."""
    parts = []
    for nid in nids:
        nd = g.node_by_id(nid)
        stream = (g.tensors[nd.inputs[1]].stream_bytes
                  if nd.op in _ATTN_OPS else None)
        parts.append((nd.m, nd.n, nd.k, nd.weight_bytes, stream))
    return tuple(parts)


def node_tile_shapes(m: int, k: int, sa_rows: int) -> list[tuple[int, int, int]]:
    """The 64-out-channel weight tiling of one node: ``(m_here,
    weight_bytes, n_chunks)`` per tile (int8 weights + int32 bias per
    slice). Single source of the tiling math, shared by :func:`build_tiles`
    and the dense-array export (``repro_torch.compiler.tables``) so the
    vectorized DSE engine can never drift from the schedule builder.
    Returns ``[]`` for weight-less nodes."""
    if m * k + 4 * m == 0:
        return []
    n_tiles = max(1, math.ceil(m / sa_rows))
    out = []
    for ti in range(n_tiles):
        m_here = min(sa_rows, m - ti * sa_rows)
        wb = m_here * k + 4 * m_here
        out.append((m_here, wb, max(1, math.ceil(wb / CHUNK_BYTES))))
    return out


def build_tiles(g: Graph, nids: list[int], pu: PUSpec) -> list[Tile]:
    tiles: list[Tile] = []
    for nid in nids:
        nd = g.node_by_id(nid)
        if nd.weight_bytes == 0:
            continue
        for ti, (m_here, wb, n_chunks) in enumerate(
                node_tile_shapes(nd.m, nd.k, pu.sa_rows)):
            tiles.append(
                Tile(
                    nid=nid,
                    tile_idx=ti,
                    weight_bytes=wb,
                    t_exec=pu.gemm_seconds(m_here, nd.n, nd.k),
                    n_chunks=n_chunks,
                )
            )
    return tiles


def schedule_weights(g: Graph, nids: list[int], pu: PUSpec) -> WeightSchedule:
    """Greedy deficit-based offline allocation under the URAM capacity."""
    tiles = build_tiles(g, nids, pu)
    node_exec: dict[int, float] = {}
    node_stream: dict[int, float] = {}
    for nid in nids:
        nd = g.node_by_id(nid)
        node_exec[nid] = (
            pu.gemm_seconds(nd.m, nd.n, nd.k) if (nd.m and nd.n and nd.k) else 0.0
        )
        if nd.op in _ATTN_OPS:
            # stream_bytes is the average valid prefix for decode K/V caches
            # (the per-round AddrLen lengths average to it over the window)
            # and the whole tensor for prefill attention operands.
            node_stream[nid] = pu.adm_seconds(
                g.tensors[nd.inputs[1]].stream_bytes)
    sched = WeightSchedule(
        tiles=tiles,
        pu_kind=pu.kind,
        capacity_bytes=pu.uram_capacity_bytes,
        t_chunk_load=pu.adm_seconds(CHUNK_BYTES),
        node_order=list(nids),
        node_exec=node_exec,
        node_stream=node_stream,
    )
    if not tiles:
        return sched

    total_chunks = sum(t.n_chunks for t in tiles)
    if total_chunks * CHUNK_BYTES <= pu.uram_capacity_bytes:
        # Everything fits: preload all weights offline.
        for t in tiles:
            t.static_chunks = t.n_chunks
        return sched

    # Iteratively pin one chunk of the most deficit-prone node (the node
    # whose remaining dynamic loads stall its GEMM the longest). The loop
    # below replays exactly the greedy decisions of the straightforward
    # implementation (stable sorts, most-dynamic-tile-first, first feasible
    # pin wins) but keeps the capacity invariant incrementally: per-tile
    # dynamic counts, per-node totals, and a lazy max-heap over the
    # adjacent-pair dynamic footprints replace the O(tiles) rescans that
    # used to dominate DSE sweeps over weight-heavy graphs.
    n = len(tiles)
    dyn = [t.n_chunks for t in tiles]  # all chunks start dynamic
    idx_of_node: dict[int, list[int]] = {}
    for i, t in enumerate(tiles):
        idx_of_node.setdefault(t.nid, []).append(i)
    node_dyn = {nid: sum(dyn[i] for i in ixs) for nid, ixs in idx_of_node.items()}
    static_total = 0
    if n > 1:
        pair = [dyn[i] + dyn[(i + 1) % n] for i in range(n)]
        heap = [(-pair[i], i) for i in range(n)]
        heapq.heapify(heap)

    def worst_pair() -> int:
        if n == 1:
            return dyn[0]
        while heap and -heap[0][0] != pair[heap[0][1]]:
            heapq.heappop(heap)  # stale entry
        return -heap[0][0] if heap else 0

    def feasible_now() -> bool:
        return (static_total + worst_pair()) * CHUNK_BYTES <= sched.capacity_bytes

    def bump(i: int, delta: int) -> None:
        dyn[i] += delta
        if n > 1:
            for p in {i, (i - 1) % n}:
                pair[p] += delta
                heapq.heappush(heap, (-pair[p], p))

    def pin_one(nid: int) -> bool:
        """Pin one chunk of ``nid`` (from its most dynamic tile) if the
        capacity constraint allows it."""
        nonlocal static_total
        for i in sorted(idx_of_node[nid], key=lambda i: -dyn[i]):
            if dyn[i] == 0:
                continue
            bump(i, -1)
            static_total += 1
            if feasible_now():
                tiles[i].static_chunks += 1
                node_dyn[nid] -= 1
                return True
            bump(i, +1)  # revert; capacity bound hit
            static_total -= 1
        return False

    t_load = sched.t_chunk_load
    while True:
        stalls = _node_stalls(nids, node_exec, node_stream, node_dyn, t_load)
        candidates = sorted(
            (nid for nid in stalls if node_dyn.get(nid, 0) > 0),
            key=lambda nid: stalls[nid],
            reverse=True,
        )
        if not any(pin_one(nid) for nid in candidates):
            break  # no pinnable stalls remain, or capacity bound everywhere
    assert sched.feasible()
    return sched
