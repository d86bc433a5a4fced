"""Node-to-PU partitioning (paper Sec. IV-B, Fig. 4(d1)).

Dynamic programming partitions the topological order of the fused node DAG
into *contiguous* subgraphs, each mapped to one PU, minimizing the maximum
per-PU completion time (the pipeline stage time) while accounting for the
PU1x / PU2x heterogeneity via the profiled execution times.

State: f(i, u1, u2) = minimal achievable max-stage-time for nodes[i:] given
u1 PU1x and u2 PU2x units still available. Transition: give the next stage
nodes[i:j] on either PU type. O(N^2 * a * b) — trivially fast at DNN scale.

The state value is independent of the *total* budget a configuration starts
from, so one memo table serves every (a, b) of a DSE sweep: callers may pass
a shared ``memo`` dict (``repro_torch.compiler.GraphAnalysis`` does) and config
(a', b') reuses every subproblem config (a, b) already solved.

The returned stage order interleaves PU types optimally; empty stages are
allowed (a configuration may leave PUs idle if that is optimal).
"""
from __future__ import annotations

from dataclasses import dataclass

from .graph import Graph
from .profiler import NodeProfile

INF = float("inf")


@dataclass(frozen=True)
class Stage:
    index: int  # pipeline stage position
    pu_kind: str  # "PU1x" | "PU2x"
    nids: tuple[int, ...]  # contiguous node ids (topological order)
    time: float  # profiled steady-state round time


@dataclass
class Partition:
    stages: list[Stage]
    node_order: list[int]

    @property
    def max_stage_time(self) -> float:
        return max((s.time for s in self.stages if s.nids), default=0.0)

    @property
    def n_used(self) -> int:
        return sum(1 for s in self.stages if s.nids)

    def stage_of_node(self) -> dict[int, int]:
        return {nid: s.index for s in self.stages for nid in s.nids}

    def pbe(self, capacity: dict[str, float]) -> float:
        """Pipeline balance efficiency (balance-factor form of [24]): the
        capacity-weighted busy fraction of the used PUs at steady state."""
        used = [s for s in self.stages if s.nids]
        if not used:
            return 0.0
        tmax = self.max_stage_time
        num = sum(s.time * capacity[s.pu_kind] for s in used)
        den = tmax * sum(capacity[s.pu_kind] for s in used)
        return num / den if den else 0.0


def partition(
    g: Graph,
    profiles: dict[str, dict[int, NodeProfile]],
    n_pu1x: int,
    n_pu2x: int,
    *,
    memo: dict | None = None,
) -> Partition:
    """DP partition of the fused graph onto (n_pu1x, n_pu2x) PUs.

    ``memo`` is an optional shared f(i, u1, u2) table; pass the same dict
    for repeated calls over the same (graph, profiles) — e.g. a Step-1
    enumeration — to reuse every overlapping subproblem across configs."""
    order = [nd.nid for nd in g.nodes]
    n = len(order)

    # prefix[kind][i] = cumulative node time of order[:i] on PU kind
    prefix: dict[str, list[float]] = {}
    for kind, prof in profiles.items():
        acc, run = [0.0], 0.0
        for nid in order:
            run += prof[nid].t_node
            acc.append(run)
        prefix[kind] = acc

    def seg_cost(kind: str, i: int, j: int) -> float:
        return prefix[kind][j] - prefix[kind][i]

    cache: dict[tuple[int, int, int], float] = memo if memo is not None else {}

    def f(i: int, u1: int, u2: int) -> float:
        if i >= n:
            return 0.0
        if u1 == 0 and u2 == 0:
            return INF
        key = (i, u1, u2)
        hit = cache.get(key)
        if hit is not None:
            return hit
        best = INF
        for kind, avail in (("PU1x", u1), ("PU2x", u2)):
            if not avail:
                continue
            nu1, nu2 = (u1 - 1, u2) if kind == "PU1x" else (u1, u2 - 1)
            row = prefix[kind]
            base = row[i]
            # j = end of this stage (exclusive); empty stages allowed.
            for j in range(i, n + 1):
                c = row[j] - base
                if c >= best:
                    break  # costs are monotone in j
                val = f(j, nu1, nu2)
                if c > val:
                    val = c
                if val < best:
                    best = val
        cache[key] = best
        return best

    stages = reconstruct_stages(order, seg_cost, f, n_pu1x, n_pu2x)
    return Partition(stages=stages, node_order=order)


def reconstruct_stages(
    order: list[int],
    seg_cost,
    f,
    n_pu1x: int,
    n_pu2x: int,
) -> list[Stage]:
    """Greedy reconstruction of an optimal stage list from the DP value
    function ``f(i, u1, u2)`` and segment costs ``seg_cost(kind, i, j)``.

    Shared by :func:`partition` (memoized recursive ``f``) and the
    dense-table path of ``repro_torch.compiler.tables`` (``f`` reads a
    pre-filled array), so the two engines reconstruct byte-identical
    stage boundaries by construction."""
    n = len(order)
    stages: list[Stage] = []
    i, u1, u2 = 0, n_pu1x, n_pu2x
    target = f(0, u1, u2)
    if target is INF or target == INF:
        raise ValueError("infeasible partition (no PUs?)")
    idx = 0
    while i < n and u1 + u2 > 0:
        placed = False
        # Prefer the faster PU2x and the longest feasible segment, provided
        # the remainder stays on an optimal path (checked against f()).
        for kind, avail in (("PU2x", u2), ("PU1x", u1)):
            if not avail or placed:
                continue
            nu1, nu2 = (u1 - 1, u2) if kind == "PU1x" else (u1, u2 - 1)
            for j in range(n, i, -1):  # prefer the longest feasible segment
                c = seg_cost(kind, i, j)
                if c <= target + 1e-15 and max(c, f(j, nu1, nu2)) <= target + 1e-12:
                    stages.append(Stage(idx, kind, tuple(order[i:j]), c))
                    i, u1, u2 = j, nu1, nu2
                    idx += 1
                    placed = True
                    break
        if not placed:
            # The optimal path may *skip* a PU (empty stage), e.g. when one
            # heavy node dominates and fewer, bigger stages win.
            for kind, avail in (("PU1x", u1), ("PU2x", u2)):
                if not avail:
                    continue
                nu1, nu2 = (u1 - 1, u2) if kind == "PU1x" else (u1, u2 - 1)
                if f(i, nu1, nu2) <= target + 1e-12:
                    u1, u2 = nu1, nu2
                    placed = True
                    break
        if not placed:
            raise RuntimeError("DP reconstruction failed")
    # Drop trailing empty stages; they carry no program.
    stages = [s for s in stages if s.nids]
    return [Stage(i, s.pu_kind, s.nids, s.time) for i, s in enumerate(stages)]
