"""Dense-array export of the config-independent compile analysis.

``AnalysisTables`` is the batched-evaluation artifact of ``analyze()``
(paper Sec. V-A): everything ``place()`` reads per (a, b) configuration —
per-(segment, PU-kind) profiled times, SMOF weight-schedule costs, the
partition-DP value table, and the cross-stage tensor-edge geometry of the
credit-loop coupling model — exported once as dense numpy arrays so the
DSE scoring engine (``repro_torch.dse.batched``) can evaluate whole config
batches as array programs instead of one Python ``place()`` call at a
time.

Numerical contract: every value in these tables is produced by the *same*
scalar helpers the per-config path uses (``PUSpec.gemm_seconds`` /
``adm_seconds``, ``NodeProfile.t_node``, the shared
``partition.reconstruct_stages`` and ``weights.node_tile_shapes``), and
every reduction the batched engine performs over them replicates the
scalar op order (sequential left-to-right sums via ``np.cumsum``,
order-free min/max) — which is what makes the batched engine's Pareto
frontiers byte-identical to the scalar engine's, not merely close.

Three exports:

* ``partition_values`` / ``reconstruct`` — the f(i, u1, u2) DP table as a
  dense ``(n+1, U1+1, U2+1)`` array (filled bottom-up with vectorized
  min/max over exactly the scalar recursion's candidate sets) plus the
  shared greedy reconstruction over it.
* ``segment_overheads`` — SMOF weight-schedule stage overheads (stall +
  dynamic-chunk decode) for a batch of node segments, solved by a
  vectorized replica of the greedy deficit allocator of
  ``repro_torch.compiler.weights`` (one chunk pinned per round, identical
  candidate/tile orderings and capacity tests), deduplicated by segment
  shape exactly like the analysis-level shape cache.
* edge tables — per cross-potential tensor edge: producer/consumer node
  positions, per-kind store/load ADM times, and the tensor slot used to
  reduce per-config buffer depths (stage-distance beta).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np

from ..core.icu import DECODE_CYCLES
from ..core.pu import PUSpec
from .graph import Graph, OpType
from .partition import INF, Stage, reconstruct_stages
from .profiler import NodeProfile
from .weights import CHUNK_BYTES, node_tile_shapes

_ATTN_OPS = (OpType.ATTN_SCORE, OpType.ATTN_CONTEXT)


@dataclasses.dataclass
class _KindTables:
    """Per-PU-kind dense node/tile arrays (config-independent)."""

    kind: str
    spec: PUSpec
    # cumulative profiled node time over the topological order; Python
    # floats (list) for exact, fast scalar indexing in the reconstruction
    prefix: list
    node_exec: np.ndarray  # (n,) full-node SA execution seconds
    node_stream: np.ndarray  # (n,) weight-port stream (attention 2nd operand)
    tile_chunks: np.ndarray  # (total_tiles,) URAM chunks per weight tile
    tile_node: np.ndarray  # (total_tiles,) node *position* owning each tile
    tile_prefix: np.ndarray  # (n+1,) tiles of nodes[i:j] = [tp[i], tp[j])
    t_chunk_load: float
    cap_chunks: int


class AnalysisTables:
    """Dense-array view of one ``GraphAnalysis`` (see module docstring).

    Build it via ``GraphAnalysis.tables()``; all arrays are derived from
    the analysis' own fused graph and profiles, so byte-identity with the
    scalar path holds per analysis instance."""

    def __init__(
        self,
        graph: Graph,
        profiles: dict[str, dict[int, NodeProfile]],
        pu_kinds: dict[str, PUSpec],
    ) -> None:
        self.graph = graph
        self.pu_kinds = pu_kinds
        self.order: list[int] = [nd.nid for nd in graph.nodes]
        self.n = len(self.order)
        self.pos: dict[int, int] = {nid: i for i, nid in enumerate(self.order)}
        self.kinds: tuple[str, ...] = tuple(profiles.keys())

        self.by_kind: dict[str, _KindTables] = {}
        nodes = graph.nodes
        # per-node shape rows: what ``schedule_weights`` reads per node —
        # the dedup key of the SMOF cost solver (mirrors segment_shape_key)
        self._shape_rows: list[tuple] = []
        for nd in nodes:
            stream_b = (graph.tensors[nd.inputs[1]].stream_bytes
                        if nd.op in _ATTN_OPS else None)
            self._shape_rows.append((nd.m, nd.n, nd.k, nd.weight_bytes, stream_b))

        for kind, prof in profiles.items():
            spec = pu_kinds[kind]
            acc, run = [0.0], 0.0
            for nid in self.order:
                run += prof[nid].t_node
                acc.append(run)
            n_exec = np.zeros(self.n)
            n_stream = np.zeros(self.n)
            t_chunks: list[int] = []
            t_node_pos: list[int] = []
            t_prefix = np.zeros(self.n + 1, dtype=np.int64)
            for i, nd in enumerate(nodes):
                n_exec[i] = (spec.gemm_seconds(nd.m, nd.n, nd.k)
                             if (nd.m and nd.n and nd.k) else 0.0)
                if nd.op in _ATTN_OPS:
                    n_stream[i] = spec.adm_seconds(
                        graph.tensors[nd.inputs[1]].stream_bytes)
                if nd.weight_bytes:
                    for _, _, n_chunks in node_tile_shapes(nd.m, nd.k, spec.sa_rows):
                        t_chunks.append(n_chunks)
                        t_node_pos.append(i)
                t_prefix[i + 1] = len(t_chunks)
            self.by_kind[kind] = _KindTables(
                kind=kind,
                spec=spec,
                prefix=acc,
                node_exec=n_exec,
                node_stream=n_stream,
                tile_chunks=np.asarray(t_chunks, dtype=np.int64),
                tile_node=np.asarray(t_node_pos, dtype=np.int64),
                tile_prefix=t_prefix,
                t_chunk_load=spec.adm_seconds(CHUNK_BYTES),
                cap_chunks=spec.uram_capacity_bytes // CHUNK_BYTES,
            )

        self._build_edges()

        # partition DP: dense f-table, grown to the largest requested budget
        self._F: Optional[np.ndarray] = None
        self._F_list = None  # .tolist() view for fast scalar indexing
        self._F_budget = (0, 0)
        self._stages_cache: dict[tuple[int, int], list[Stage]] = {}
        # SMOF cost caches: per (i, j, kind) segment and per segment shape
        self._seg_cost: dict[tuple[int, int, str], tuple[float, int]] = {}
        self._shape_cost: dict[tuple, tuple[float, int]] = {}

    # -- coupling edge tables -------------------------------------------------
    def _build_edges(self) -> None:
        """One row per (tensor, consumer-node) pair that can couple stages:
        graph I/O tensors are host-coordinated (no PU-to-PU credit loop)
        and dead tensors carry no edge — the same skips as
        ``buffer_requirements`` + ``coupling_bounds``."""
        g = self.graph
        t_slot: list[int] = []
        prod_pos: list[int] = []
        cons_pos: list[int] = []
        primary: list[bool] = []
        write_bytes: list[int] = []
        read_bytes: list[int] = []
        n_slots = 0
        io = set(g.input_tensors) | set(g.output_tensors)
        for tid, tinfo in g.tensors.items():
            if tinfo.is_kv_cache and tid in io:
                # same invalid-graph contract as buffer_requirements()
                raise ValueError(
                    f"K/V cache tensor {tinfo.name!r} cannot be a graph input/output"
                )
            if tid in io:
                continue
            producer = g.producer_of(tid)
            consumers = g.consumers_of(tid)
            if producer is None or not consumers:
                continue  # dead tensor (fused away)
            slot = n_slots
            n_slots += 1
            for c in consumers:
                t_slot.append(slot)
                prod_pos.append(self.pos[producer.nid])
                cons_pos.append(self.pos[c.nid])
                primary.append(bool(c.inputs) and c.inputs[0] == tid)
                write_bytes.append(tinfo.write_bytes)
                read_bytes.append(tinfo.nbytes_padded)
        self.n_edges = len(t_slot)
        self.n_tensor_slots = n_slots
        self.edge_tensor = np.asarray(t_slot, dtype=np.int64)
        self.edge_prod = np.asarray(prod_pos, dtype=np.int64)
        self.edge_cons = np.asarray(cons_pos, dtype=np.int64)
        prim = np.asarray(primary, dtype=bool)
        # per-kind ADM times: producer store / consumer (primary) load
        self.edge_t_write: dict[str, np.ndarray] = {}
        self.edge_t_read: dict[str, np.ndarray] = {}
        for kind in self.kinds:
            spec = self.pu_kinds[kind]
            tw = np.array([spec.adm_seconds(b) for b in write_bytes])
            tr = np.array([spec.adm_seconds(b) for b in read_bytes])
            self.edge_t_write[kind] = tw
            self.edge_t_read[kind] = np.where(prim, tr, 0.0)

    # -- partition DP ---------------------------------------------------------
    def partition_values(self, n_pu1x: int, n_pu2x: int) -> np.ndarray:
        """Dense DP value table F[i, u1, u2] == the scalar recursion's
        f(i, u1, u2) (min over the same candidate sets with exact float
        min/max), filled bottom-up. Budget-independent subproblems mean
        one table built for the largest requested budget serves all
        smaller (a, b)."""
        u1, u2 = self._F_budget
        if self._F is None or n_pu1x > u1 or n_pu2x > u2:
            U1, U2 = max(n_pu1x, u1), max(n_pu2x, u2)
            n = self.n
            F = np.full((n + 1, U1 + 1, U2 + 1), INF)
            F[n, :, :] = 0.0
            pre = {k: np.asarray(t.prefix) for k, t in self.by_kind.items()}
            for i in range(n - 1, -1, -1):
                best = np.full((U1 + 1, U2 + 1), INF)
                if U1 and "PU1x" in pre:
                    c = pre["PU1x"][i:] - pre["PU1x"][i]
                    cand = np.maximum(c[:, None, None], F[i:, :U1, :]).min(axis=0)
                    np.minimum(best[1:, :], cand, out=best[1:, :])
                if U2 and "PU2x" in pre:
                    c = pre["PU2x"][i:] - pre["PU2x"][i]
                    cand = np.maximum(c[:, None, None], F[i:, :, :U2]).min(axis=0)
                    np.minimum(best[:, 1:], cand, out=best[:, 1:])
                best[0, 0] = INF
                F[i] = best
            self._F = F
            self._F_list = F.tolist()
            self._F_budget = (U1, U2)
            self._stages_cache.clear()
        return self._F

    def reconstruct(self, n_pu1x: int, n_pu2x: int) -> list[Stage]:
        """Optimal stage list for one (a, b) config — the shared greedy
        reconstruction of ``repro_torch.compiler.partition`` reading the dense
        table, so stage boundaries match ``partition()`` exactly."""
        key = (n_pu1x, n_pu2x)
        hit = self._stages_cache.get(key)
        if hit is not None:
            return hit
        self.partition_values(n_pu1x, n_pu2x)
        flist = self._F_list
        prefix = {k: t.prefix for k, t in self.by_kind.items()}

        def f(i: int, u1: int, u2: int) -> float:
            return flist[i][u1][u2]

        def seg_cost(kind: str, i: int, j: int) -> float:
            row = prefix[kind]
            return row[j] - row[i]

        stages = reconstruct_stages(self.order, seg_cost, f, n_pu1x, n_pu2x)
        self._stages_cache[key] = stages
        return stages

    # -- SMOF segment costs ---------------------------------------------------
    def segment_overheads(
        self, segs: Iterable[tuple[int, int, str]]
    ) -> dict[tuple[int, int, str], float]:
        """Stage overhead seconds (weight-stream stall + two CP decodes per
        dynamic chunk) for each ``(i, j, kind)`` node-range segment.

        All segments missing from the cache are deduplicated by shape
        (the ``segment_shape_key`` analog) and solved in one vectorized
        greedy pass; results are exact replicas of
        ``GraphAnalysis.stage_overhead``."""
        segs = list(segs)
        todo: dict[tuple, tuple[int, int, str]] = {}
        for s in segs:
            if s in self._seg_cost:
                continue
            i, j, kind = s
            skey = (kind, tuple(self._shape_rows[i:j]))
            if skey in self._shape_cost:
                self._seg_cost[s] = self._shape_cost[skey]
            elif skey not in todo:
                todo[skey] = s
        if todo:
            solved = _solve_smof_batch(
                [(self.by_kind[kind], i, j) for (i, j, kind) in todo.values()])
            for skey, res in zip(todo, solved):
                self._shape_cost[skey] = res
        out: dict[tuple[int, int, str], float] = {}
        for s in segs:
            res = self._seg_cost.get(s)
            if res is None:
                i, j, kind = s
                skey = (kind, tuple(self._shape_rows[i:j]))
                res = self._shape_cost[skey]
                self._seg_cost[s] = res
            stall, n_dyn = res
            spec = self.by_kind[s[2]].spec
            # exact op order of GraphAnalysis.stage_overhead
            out[s] = stall + 2 * n_dyn * DECODE_CYCLES / spec.sys_clk_hz
        return out


# -- vectorized SMOF greedy ---------------------------------------------------
#
# Replicates schedule_weights() exactly: one chunk pinned per round, to the
# highest-stall node (ties: node order) that has a feasible tile, from that
# node's most-dynamic tile (ties: tile order). The capacity test after a
# trial pin — static+1 plus the worst adjacent dynamic pair after the
# decrement — collapses to a 3-way case split because pair values are
# integers and a pin decrements exactly the two pairs adjacent to the tile:
# the post-pin worst pair is gmax (some untouched pair attains the max) or
# gmax-1 (every argmax pair is adjacent to the pinned tile). With
# slack = cap - static - 1:
#   gmax     <= slack : every tile with dynamic chunks is feasible
#   gmax - 1 >  slack : no tile is feasible -> the segment is done
#   gmax - 1 == slack : tile t feasible iff all argmax pairs are in
#                       {prev(t), t}  (count test, two gathers)
# A single-tile segment has worst = dyn[0]; modeling it as one "pair" of
# value dyn[0] that every pin decrements by one makes the same split apply
# (at the border it is always feasible, matching the scalar allocator).


def _solve_smof_batch(
    items: list[tuple[_KindTables, int, int]]
) -> list[tuple[float, int]]:
    """(total_stall_seconds, n_dynamic_chunks) per (kind-tables, i, j)
    segment. Buckets by tile count so short segments do not pay the
    widest segment's padding."""
    order = sorted(range(len(items)),
                   key=lambda s: int(items[s][0].tile_prefix[items[s][2]]
                                     - items[s][0].tile_prefix[items[s][1]]))
    results: list[Optional[tuple[float, int]]] = [None] * len(items)
    bucket: list[int] = []
    for s in order:
        kt, i, j = items[s]
        n_tiles = int(kt.tile_prefix[j] - kt.tile_prefix[i])
        if bucket:
            kt0, i0, j0 = items[bucket[0]]
            lo = int(kt0.tile_prefix[j0] - kt0.tile_prefix[i0])
            if n_tiles > max(2 * lo, lo + 64) or len(bucket) >= 256:
                for idx, res in zip(bucket, _solve_smof_bucket(
                        [items[b] for b in bucket])):
                    results[idx] = res
                bucket = []
        bucket.append(s)
    if bucket:
        for idx, res in zip(bucket, _solve_smof_bucket(
                [items[b] for b in bucket])):
            results[idx] = res
    return results  # type: ignore[return-value]


def _solve_smof_bucket(
    items: list[tuple[_KindTables, int, int]]
) -> list[tuple[float, int]]:
    S = len(items)
    L = max(j - i for _, i, j in items)
    n_tiles = np.zeros(S, dtype=np.int64)
    n_nodes = np.zeros(S, dtype=np.int64)
    tchunk = np.zeros(S)
    cap = np.zeros(S, dtype=np.int64)
    for s, (kt, i, j) in enumerate(items):
        n_tiles[s] = kt.tile_prefix[j] - kt.tile_prefix[i]
        n_nodes[s] = j - i
        tchunk[s] = kt.t_chunk_load
        cap[s] = kt.cap_chunks
    T = max(1, int(n_tiles.max()))

    nexec = np.zeros((S, L))
    nstream = np.zeros((S, L))
    dyn = np.zeros((S, T), dtype=np.int64)
    tnode = np.zeros((S, T), dtype=np.int64)
    for s, (kt, i, j) in enumerate(items):
        nn = j - i
        nexec[s, :nn] = kt.node_exec[i:j]
        nstream[s, :nn] = kt.node_stream[i:j]
        lo, hi = int(kt.tile_prefix[i]), int(kt.tile_prefix[j])
        nt = hi - lo
        dyn[s, :nt] = kt.tile_chunks[lo:hi]
        tnode[s, :nt] = kt.tile_node[lo:hi] - i

    cols_L = np.arange(L)
    cols_T = np.arange(T)
    nmask = cols_L[None, :] < n_nodes[:, None]
    tmask = cols_T[None, :] < n_tiles[:, None]
    node_dyn = np.zeros((S, L), dtype=np.int64)
    np.add.at(node_dyn, (np.repeat(np.arange(S), T), tnode.ravel()),
              np.where(tmask, dyn, 0).ravel())

    # everything fits -> all chunks static, no greedy pass
    total = dyn.sum(axis=1)
    fits = total <= cap
    dyn[fits] = 0
    node_dyn[fits] = 0
    active = ~fits & (total > 0)

    nt_eff = np.maximum(n_tiles, 1)
    nxt = (cols_T[None, :] + 1) % nt_eff[:, None]
    prv = (cols_T[None, :] - 1) % nt_eff[:, None]
    single = n_tiles == 1
    pair = dyn + np.take_along_axis(dyn, nxt, axis=1)
    pair[single, 0] = dyn[single, 0]  # single-tile: worst = dyn[0]
    # One iteration pins one chunk per still-active row (the scalar
    # allocator's outer loop). Two cost levers keep iterations cheap:
    #   * ``stall``/``load``/``cand`` change only at the pinned node, so
    #     they are maintained incrementally (the recompute uses the exact
    #     expression of the cold build, so floats stay byte-identical);
    #   * ``margin = slack - gmax`` is a lower bound maintained by
    #     decrementing one per pin (slack drops exactly one, gmax by at
    #     most one). While margin >= 0 every dynamic tile is feasible and
    #     the whole (S, T) pair/argmax feasibility machinery is skipped;
    #     rows whose bound goes negative get an exact gmax refresh and,
    #     only at the border, the count-test tile filter.
    overlap = np.concatenate([np.zeros((S, 1)), nexec[:, :-1]], axis=1)
    load = node_dyn * tchunk[:, None] + nstream
    stall = load - overlap
    cand = (load > 0.0) & (stall > 0.0) & (node_dyn > 0) & nmask
    margin = (cap - 1) - np.where(tmask, pair, -1).max(axis=1)

    while active.any():
        border_state = None  # (rows, tile_ok, K, per-node best K)
        need = active & (margin < 0)
        if need.any():
            nb = np.nonzero(need)[0]
            pv_b = np.where(tmask[nb], pair[nb], -1)
            gmax_b = pv_b.max(axis=1)
            margin[nb] = (cap[nb] - 1) - gmax_b
            active[nb[margin[nb] < -1]] = False  # no feasible tile at all
            bsel = margin[nb] == -1
            if bsel.any():
                rb = nb[bsel]
                at_max = pv_b[bsel] == gmax_b[bsel][:, None]
                cnt = (at_max & tmask[rb]).sum(axis=1)
                ok_border = ((np.take_along_axis(at_max, prv[rb], axis=1)
                              .astype(np.int64) + at_max.astype(np.int64))
                             == cnt[:, None])
                ok_border |= single[rb][:, None]
                tile_ok_b = tmask[rb] & (dyn[rb] > 0) & ok_border
                K_b = np.where(tile_ok_b,
                               dyn[rb] * (T + 1) + (T - cols_T[None, :]), 0)
                kbest_b = np.zeros((rb.size, L), dtype=np.int64)
                np.maximum.at(
                    kbest_b,
                    (np.repeat(np.arange(rb.size), T), tnode[rb].ravel()),
                    K_b.ravel())
                border_state = (rb, tile_ok_b, K_b, kbest_b)

        valid = cand & active[:, None]
        if border_state is not None:
            valid[border_state[0]] &= border_state[3] > 0
        stallv = np.where(valid, stall, -np.inf)
        m = stallv.max(axis=1)
        found = m > -np.inf
        active = found
        rows = np.nonzero(found)[0]
        if rows.size == 0:
            break
        wn = np.where(stallv == m[:, None], cols_L[None, :], L).min(axis=1)
        wnode = wn[rows]
        wtile = np.zeros(rows.size, dtype=np.int64)
        is_b = (np.isin(rows, border_state[0]) if border_state is not None
                else np.zeros(rows.size, dtype=bool))
        rs = rows[~is_b]
        if rs.size:  # all-feasible rows: best tile = max dyn, lowest index
            Ks = np.where((tnode[rs] == wn[rs][:, None]) & (dyn[rs] > 0),
                          dyn[rs] * (T + 1) + (T - cols_T[None, :]), 0)
            wtile[~is_b] = Ks.argmax(axis=1)
        if is_b.any():
            rb, tile_ok_b, K_b, kbest_b = border_state
            rbw = rows[is_b]
            loc = np.searchsorted(rb, rbw)
            wnb = wn[rbw]
            kb = kbest_b[loc, wnb]
            match = (tile_ok_b[loc] & (tnode[rbw] == wnb[:, None])
                     & (K_b[loc] == kb[:, None]))
            wtile[is_b] = match.argmax(axis=1)

        dyn[rows, wtile] -= 1
        cap[rows] -= 1  # static_total += 1
        node_dyn[rows, wnode] -= 1
        pt = prv[rows, wtile]
        np.subtract.at(pair, (rows, wtile), 1)
        np.subtract.at(pair, (rows, pt), 1)
        sing = single[rows]
        pair[rows[sing], 0] += 1  # single-tile rows: one decrement only
        margin[rows] -= 1
        ld = node_dyn[rows, wnode] * tchunk[rows] + nstream[rows, wnode]
        st = ld - overlap[rows, wnode]
        load[rows, wnode] = ld
        stall[rows, wnode] = st
        cand[rows, wnode] = (ld > 0.0) & (st > 0.0) & (node_dyn[rows, wnode] > 0)

    load = node_dyn * tchunk[:, None] + nstream
    overlap = np.concatenate([np.zeros((S, 1)), nexec[:, :-1]], axis=1)
    stall = load - overlap
    contrib = np.where((load > 0.0) & (stall > 0.0) & nmask, stall, 0.0)
    # sequential left-to-right sum in node order == the scalar total_stall()
    totals = np.cumsum(contrib, axis=1)[:, -1] if L else np.zeros(S)
    n_dyn = dyn.sum(axis=1)
    return [(float(totals[s]), int(n_dyn[s])) for s in range(S)]
