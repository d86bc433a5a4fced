"""Pareto analysis for the DSE methodology (paper Sec. V-A, step 3).

Step 2 of the DSE produces thousands of multi-batch schedules, so the
frontier extraction is on the interactive path. For the common 2-objective
case (throughput vs. -latency) ``pareto_front`` runs a sort-based
O(n log n) sweep; the O(n²) pairwise scan is kept for >= 3 objectives (the
multi-tenant per-tenant-rate vectors) and — as
``pareto_front_bruteforce`` — serves as the oracle for the equivalence
property tests. Both paths return the kept points in input order and agree
bit-for-bit, including the tolerance semantics and exact-tie handling
(mutually non-dominating duplicates are all kept).
"""
from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")


def _threshold(v: float, tolerance: float) -> float:
    """The value a dominator must reach in one objective: relative
    ``tolerance`` scales away from ``v`` (sign-aware, as in Fig. 6(b)'s
    'applied with a small tolerance')."""
    return v * (1 + tolerance) if v >= 0 else v * (1 - tolerance)


def _vectorized_keep(vals: list[list[float]], tolerance: float) -> list[int]:
    """NumPy pairwise dominance scan — the same O(n²·k) comparisons as
    ``_bruteforce_keep`` as array ops (identical float arithmetic and
    comparison semantics, NaN/inf included), for the >= 3-objective path
    (multi-tenant rate vectors) where n reaches the thousands. Blocked over
    the candidate axis to bound the broadcast to ~n·512·k."""
    import numpy as np

    n = len(vals)
    V = np.asarray(vals, dtype=np.float64)
    T = np.where(V >= 0.0, V * (1.0 + tolerance), V * (1.0 - tolerance))
    keep: list[int] = []
    for j0 in range(0, n, 512):
        ge = (V[:, None, :] >= T[None, j0:j0 + 512, :]).all(axis=2)
        gt = (V[:, None, :] > V[None, j0:j0 + 512, :]).any(axis=2)
        dom = (ge & gt).any(axis=0)
        keep.extend(int(j0 + k) for k in np.nonzero(~dom)[0])
    return keep


def _bruteforce_keep(vals: list[list[float]], tolerance: float) -> list[int]:
    """O(n²) pairwise dominance scan; returns kept indices in input order."""
    n = len(vals)
    n_obj = len(vals[0]) if vals else 0

    def dominates(i: int, j: int) -> bool:
        ge = all(vals[i][k] >= _threshold(vals[j][k], tolerance)
                 for k in range(n_obj))
        gt = any(vals[i][k] > vals[j][k] for k in range(n_obj))
        return ge and gt

    return [j for j in range(n)
            if not any(dominates(i, j) for i in range(n) if i != j)]


def _sorted_keep_2d(vals: list[list[float]], tolerance: float) -> list[int]:
    """O(n log n) keep-set for exactly two maximizing objectives.

    Sort by (f1 desc, f2 desc); a point's potential dominators in f1 are a
    prefix of that order (everything with f1 >= its tolerance-scaled
    threshold), so one prefix-max array of f2 answers the ge-condition and
    the per-f1-group maxima resolve the strict-inequality tie cases exactly
    as the pairwise oracle does."""
    n = len(vals)
    order = sorted(range(n), key=lambda i: (-vals[i][0], -vals[i][1]))
    f1_desc = [vals[i][0] for i in order]
    neg_f1 = [-x for x in f1_desc]  # ascending, for bisect

    # prefix_max[k] = max f2 over the first k points of ``order``
    prefix_max = [-math.inf] * (n + 1)
    for k, i in enumerate(order):
        prefix_max[k + 1] = max(prefix_max[k], vals[i][1])

    # per-f1-group f2 maxima and the max f2 of strictly-greater-f1 points
    group_max: dict[float, float] = {}
    best_before: dict[float, float] = {}
    running = -math.inf
    k = 0
    while k < n:
        f1 = f1_desc[k]
        j = k
        gmax = -math.inf
        while j < n and f1_desc[j] == f1:
            gmax = max(gmax, vals[order[j]][1])
            j += 1
        best_before[f1] = running
        group_max[f1] = gmax
        running = max(running, gmax)
        k = j

    keep = []
    for j in range(n):
        f1_j, f2_j = vals[j]
        thr1 = _threshold(f1_j, tolerance)
        thr2 = _threshold(f2_j, tolerance)
        if thr1 > f1_j:
            # every candidate with f1 >= thr1 is strictly greater in f1, so
            # the gt-condition holds via f1 and only the ge-check remains.
            cnt = bisect_right(neg_f1, -thr1)
            dominated = prefix_max[cnt] >= thr2
        else:
            # thr1 == f1_j (tolerance 0 or f1_j == 0): strictly-greater-f1
            # dominators need f2 >= thr2; equal-f1 dominators additionally
            # need strictly greater f2.
            gmax = group_max[f1_j]
            dominated = (best_before[f1_j] >= thr2
                         or (gmax >= thr2 and gmax > f2_j))
        if not dominated:
            keep.append(j)
    return keep


def pareto_front(
    points: Sequence[T],
    objectives: Sequence[Callable[[T], float]],
    *,
    tolerance: float = 0.0,
) -> list[T]:
    """Maximizing Pareto frontier over ``objectives`` (negate for minimize).

    ``tolerance`` (relative) admits near-frontier points, as in Fig. 6(b)
    ("applied with a small tolerance"). Two objectives take the sort-based
    O(n log n) path; anything else (or a negative tolerance, or non-finite
    values) falls back to the pairwise scan. Output order is input order."""
    vals = [[obj(p) for obj in objectives] for p in points]
    if (len(objectives) == 2 and tolerance >= 0.0
            and all(math.isfinite(v) for row in vals for v in row)):
        keep = _sorted_keep_2d(vals, tolerance)
    elif (len(vals) >= 32
          and all(isinstance(v, float) for row in vals for v in row)):
        # float64 round-trips losslessly, so the numpy scan's comparisons
        # are the exact Python ones; non-float objectives (e.g. huge ints)
        # stay on the pure-Python scan to avoid conversion rounding.
        keep = _vectorized_keep(vals, tolerance)
    else:
        keep = _bruteforce_keep(vals, tolerance)
    return [points[j] for j in keep]


def pareto_front_bruteforce(
    points: Sequence[T],
    objectives: Sequence[Callable[[T], float]],
    *,
    tolerance: float = 0.0,
) -> list[T]:
    """Reference O(n²) frontier — the property-test oracle the sort-based
    path is verified against (and the ≥3-objective workhorse)."""
    vals = [[obj(p) for obj in objectives] for p in points]
    return [points[j] for j in _bruteforce_keep(vals, tolerance)]


def constrained(
    points: Iterable[T],
    *,
    max_latency: float | None = None,
    min_throughput: float | None = None,
    max_batch: int | None = None,
    latency_of: Callable[[T], float] = lambda p: p.latency,
    throughput_of: Callable[[T], float] = lambda p: p.throughput,
    batch_of: Callable[[T], int] = lambda p: p.batch,
) -> list[T]:
    """Application-constraint filtering (max latency / min throughput /
    target batch), per the paper's configuration-selection step."""
    out = []
    for p in points:
        if max_latency is not None and latency_of(p) > max_latency:
            continue
        if min_throughput is not None and throughput_of(p) < min_throughput:
            continue
        if max_batch is not None and batch_of(p) > max_batch:
            continue
        out.append(p)
    return out
