"""Batched placement scoring — the vectorized DSE evaluation engine.

Scores a whole batch of (a, b) pipeline configurations against one shared
``GraphAnalysis`` as array programs over the dense ``AnalysisTables``
export (``repro_torch.compiler.tables``), instead of one Python ``place()`` call
per config. This is the engine behind ``explore(engine="batched")`` /
``explore_multi(engine="batched")`` — the default — and the piece that
makes fleet-scale sweeps and in-the-loop re-exploration viable.

Per config the evaluation replicates ``place()``'s analytic path end to
end: partition lookup from the dense DP table, stage-time assembly
(profiled segment times + SMOF weight-stream overheads), the credit-loop
coupling bound of ``repro_torch.compiler.coupling`` over the config-independent
edge tables, and the derived point metrics (fps, latency, used TOPS, PBE).

Two backends:

* ``backend="numpy"`` (default) — byte-identical to the scalar path. All
  reductions replicate the scalar op order (``np.cumsum`` for sequential
  left-to-right sums, order-exact min/max, no fused multiply-adds — numpy
  ufuncs never FMA-contract), so the resulting ``SingleBatchPoint``s, and
  therefore every frontier and design point downstream, compare equal
  with ``==`` against ``engine="scalar"`` and ``engine="reference"``.
  Frontiers and ties are defined by this backend.
* ``backend="torch"`` — the scoring step (coupling bound, forward latency,
  the point metrics) as float64 / int64 tensor programs over the whole
  config batch at once, on ``device`` (``None`` = the card, as every entry
  point of the port; the tests pass ``"cpu"``). The host assembles the same
  per-config arrays as the numpy path and takes them to the device. The
  device reduces in its own order (``sum`` is not a left-to-right
  ``cumsum``, the card may FMA-contract), so this path is
  *tolerance*-accurate: it is held to the numpy backend at rtol 1e-9 /
  atol 1e-12, never to byte equality. It exists to offload very large
  candidate batches to the card and is never the default: the card is used
  by asking for it. With no scorable edges (``E == 0``) the numpy result is
  returned, as the reference does for that degenerate case.

``PROFILE`` accumulates per-phase wall times (table build / partition DP /
reconstruction / SMOF solve / the host assembly of the per-config arrays /
scoring) across calls; the torch backend's ``score`` includes the copies to
and from the device, and on the card it adds ``score_device``, the seconds
between two CUDA events around its scoring kernels.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..compiler.compile import STATS, GraphAnalysis
from ..core.icu import DECODE_CYCLES
from ..core.isu import BASE_HOP_LATENCY, SAME_PU_LATENCY, SLR_CROSS_PENALTY
from ..core.pu import PUSpec, make_u50_system

# wall-seconds per evaluation phase, accumulated across calls; reset with
# reset_profile()
PROFILE: dict[str, float] = {}


def reset_profile() -> None:
    PROFILE.clear()


def _tick(phase: str, t0: float) -> float:
    now = time.perf_counter()
    PROFILE[phase] = PROFILE.get(phase, 0.0) + (now - t0)
    return now


@dataclass
class BatchedScores:
    """Dense per-config results of one batched scoring call (config order
    preserved). ``binding_bound``/``uncoupled_seconds`` expose the coupling
    decomposition for the equivalence property tests."""

    configs: list[tuple[int, int]]
    fps: np.ndarray
    latency: np.ndarray
    tops: np.ndarray
    pbe: np.ndarray
    round_seconds: np.ndarray
    uncoupled_seconds: np.ndarray
    binding_bound: np.ndarray  # worst credit-loop bound; 0.0 when no edges


def _stage_pid_tables(pus: list[PUSpec], kinds: Sequence[str]):
    """Canonical per-(kind, rank) PU attributes: the k-th same-kind stage in
    pipeline order gets the k-th free PU of that kind (``assign_pids``)."""
    pid, slr, clk, peak = {}, {}, {}, {}
    for ki, kind in enumerate(kinds):
        specs = [p for p in pus if p.kind == kind]
        pid[ki] = np.array([p.pid for p in specs], dtype=np.int64)
        slr[ki] = np.array([p.slr for p in specs], dtype=np.int64)
        clk[ki] = np.array([p.sys_clk_hz for p in specs])
        peak[ki] = np.array([p.peak_tops for p in specs])
    return pid, slr, clk, peak


def score_details(
    analysis: GraphAnalysis,
    configs: Sequence[tuple[int, int]],
    *,
    pus: Optional[list[PUSpec]] = None,
    backend: str = "numpy",
    device=None,
) -> BatchedScores:
    """Evaluate every (a, b) in ``configs`` in one vectorized pass.

    Returns the full metric decomposition; ``score_single_batch`` is the
    ``SingleBatchPoint``-producing wrapper the explorer uses. ``device`` is
    read by ``backend="torch"`` only (``None`` = CUDA; raises where there
    is no card)."""
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device) if backend == "torch" else None
    pus = pus if pus is not None else make_u50_system()
    configs = [(int(a), int(b)) for a, b in configs]
    STATS.batched_score_calls += 1

    t0 = time.perf_counter()
    tab = analysis.tables()
    t0 = _tick("tables_build", t0)
    tab.partition_values(max(a for a, _ in configs), max(b for _, b in configs))
    t0 = _tick("partition_dp", t0)

    kinds = tab.kinds
    kidx = {k: i for i, k in enumerate(kinds)}
    stage_lists = [tab.reconstruct(a, b) for a, b in configs]
    t0 = _tick("reconstruct", t0)

    # one batched SMOF solve for every segment any config uses
    segs = []
    seen = set()
    for stages in stage_lists:
        for s in stages:
            i = tab.pos[s.nids[0]]
            key = (i, i + len(s.nids), s.pu_kind)
            if key not in seen:
                seen.add(key)
                segs.append(key)
    overheads = tab.segment_overheads(segs)
    t0 = _tick("smof", t0)

    B = len(configs)
    S = max((len(st) for st in stage_lists), default=0)
    n = tab.n
    st_time = np.zeros((B, S))
    st_kind = np.zeros((B, S), dtype=np.int64)
    st_rank = np.zeros((B, S), dtype=np.int64)
    st_mask = np.zeros((B, S), dtype=bool)
    stage_of = np.zeros((B, n), dtype=np.int64)
    for bi, stages in enumerate(stage_lists):
        seen_k = [0] * len(kinds)
        for s in stages:
            i = tab.pos[s.nids[0]]
            j = i + len(s.nids)
            ki = kidx[s.pu_kind]
            # stage time: profiled segment time + SMOF overhead (one add,
            # matching place()'s `s.time + stage_overhead(...)`)
            st_time[bi, s.index] = s.time + overheads[(i, j, s.pu_kind)]
            st_kind[bi, s.index] = ki
            st_rank[bi, s.index] = seen_k[ki]
            seen_k[ki] += 1
            st_mask[bi, s.index] = True
            stage_of[bi, i:j] = s.index

    pid_t, slr_t, clk_t, peak_t = _stage_pid_tables(pus, kinds)
    for ki in range(len(kinds)):
        need = int(np.where(st_kind == ki, st_rank + 1, 0).max(initial=0))
        if need > len(pid_t[ki]):
            raise ValueError(f"no free {kinds[ki]} for stage (budget exceeds "
                             f"the {len(pid_t[ki])} available)")
    st_pid = np.zeros((B, S), dtype=np.int64)
    st_slr = np.zeros((B, S), dtype=np.int64)
    st_clk = np.ones((B, S))
    st_peak = np.zeros((B, S))
    for ki in range(len(kinds)):
        m = st_mask & (st_kind == ki)
        st_pid[m] = pid_t[ki][st_rank[m]]
        st_slr[m] = slr_t[ki][st_rank[m]]
        st_clk[m] = clk_t[ki][st_rank[m]]
        st_peak[m] = peak_t[ki][st_rank[m]]

    t0 = _tick("assemble", t0)

    caps_kind = np.array([analysis.pu_kinds[k].peak_tops for k in kinds])
    if backend == "torch" and tab.n_edges:
        out = _score_torch(tab, configs, st_time, st_kind, st_mask, stage_of,
                           st_pid, st_slr, st_clk, st_peak, caps_kind, dev)
        _tick("score", t0)
        return out

    # -- numpy scoring (byte-identical to the scalar path) -------------------
    uncoupled = np.where(st_mask, st_time, -np.inf).max(axis=1, initial=-np.inf)
    uncoupled = np.where(np.isfinite(uncoupled), uncoupled, 0.0)

    E = tab.n_edges
    if E:
        ps = np.take_along_axis(stage_of, tab.edge_prod[None, :].repeat(B, 0), 1)
        cs = np.take_along_axis(stage_of, tab.edge_cons[None, :].repeat(B, 0), 1)
        dist = cs - ps
        # credit depth = stage-distance beta of the tensor (max over all of
        # its consumer edges, same-stage ones included), never below 1
        beta = np.zeros((B, tab.n_tensor_slots), dtype=np.int64)
        rowsB = np.repeat(np.arange(B), E)
        colsE = np.tile(tab.edge_tensor, B)
        np.maximum.at(beta, (rowsB, colsE), dist.ravel())
        depth = (beta + 1)[np.arange(B)[:, None], tab.edge_tensor[None, :]]

        pk = np.take_along_axis(st_kind, ps, 1)
        ck = np.take_along_axis(st_kind, cs, 1)
        ppid = np.take_along_axis(st_pid, ps, 1)
        cpid = np.take_along_axis(st_pid, cs, 1)
        pslr = np.take_along_axis(st_slr, ps, 1)
        cslr = np.take_along_axis(st_slr, cs, 1)
        pclk = np.take_along_axis(st_clk, ps, 1)
        cclk = np.take_along_axis(st_clk, cs, 1)

        tw = np.stack([tab.edge_t_write[k] for k in kinds])  # (K, E)
        tr = np.stack([tab.edge_t_read[k] for k in kinds])
        t_write = np.take_along_axis(tw, pk, 0)
        t_read = np.take_along_axis(tr, ck, 0)

        # token_latency_cycles, vectorized (symmetric in src/dst)
        hops = np.abs(ppid - cpid)
        lat_cyc = np.where(
            hops == 0, SAME_PU_LATENCY,
            BASE_HOP_LATENCY + (hops > 2).astype(np.int64)
            + SLR_CROSS_PENALTY * (pslr != cslr).astype(np.int64))
        l_req = lat_cyc / pclk
        l_ack = lat_cyc / cclk
        t_dec = (4 * DECODE_CYCLES) / pclk  # _HANDSHAKE_DECODES
        # exact left-to-right op order of coupling_bounds()
        cycle = (((t_write + l_req) + t_read) + l_ack) + t_dec
        bound = cycle / depth
        cross = dist > 0
        worst = np.where(cross, bound, 0.0).max(axis=1)  # max(bounds, 0.0)
        round_s = np.maximum(uncoupled, worst)

        # forward latency: min one-way REQ latency per distinct stage hop,
        # summed in canonical ascending (producer, consumer) order
        req_lat = l_req + (2 * DECODE_CYCLES) / pclk
        H = (S + 1) * (S + 1)
        hid = ps * (S + 1) + cs
        hop_min = np.full((B, H), np.inf)
        np.minimum.at(hop_min, (rowsB, hid.ravel()),
                      np.where(cross, req_lat, np.inf).ravel())
        fwd = np.cumsum(np.where(np.isfinite(hop_min), hop_min, 0.0),
                        axis=1)[:, -1] if H else np.zeros(B)
    else:
        worst = np.zeros(B)
        round_s = np.maximum(uncoupled, worst)
        fwd = np.zeros(B)

    # sequential sums in stage order (zero-padded tails are exact no-ops)
    times_m = np.where(st_mask, st_time, 0.0)
    lat = (np.cumsum(times_m, axis=1)[:, -1] if S else np.zeros(B)) + fwd
    tops = (np.cumsum(np.where(st_mask, st_peak, 0.0), axis=1)[:, -1]
            if S else np.zeros(B))

    st_caps = np.where(st_mask, caps_kind[st_kind], 0.0)
    num = np.cumsum(times_m * st_caps, axis=1)[:, -1] if S else np.zeros(B)
    den = round_s * (np.cumsum(st_caps, axis=1)[:, -1] if S else np.zeros(B))
    with np.errstate(divide="ignore", invalid="ignore"):
        pbe = np.where((st_mask.any(axis=1)) & (round_s != 0.0), num / den, 0.0)
        fps = np.where(round_s != 0.0, 1.0 / round_s, 0.0)

    _tick("score", t0)
    return BatchedScores(
        configs=configs, fps=fps, latency=lat, tops=tops, pbe=pbe,
        round_seconds=round_s, uncoupled_seconds=uncoupled,
        binding_bound=worst,
    )


def score_single_batch(
    analysis: GraphAnalysis,
    configs: Sequence[tuple[int, int]],
    *,
    pus: Optional[list[PUSpec]] = None,
    backend: str = "numpy",
    device=None,
):
    """Score a config batch and return ``SingleBatchPoint``s in input order
    — the drop-in vectorized equivalent of one ``place()`` + ``_point_of``
    per config."""
    from .explorer import SingleBatchPoint

    sc = score_details(analysis, configs, pus=pus, backend=backend,
                       device=device)
    return [
        SingleBatchPoint(a=a, b=b, fps=float(sc.fps[i]),
                         latency=float(sc.latency[i]), tops=float(sc.tops[i]),
                         pbe=float(sc.pbe[i]))
        for i, (a, b) in enumerate(sc.configs)
    ]




# -- torch backend ------------------------------------------------------------

def _score_torch(tab, configs, st_time, st_kind, st_mask, stage_of,
                 st_pid, st_slr, st_clk, st_peak, caps_kind,
                 device: torch.device) -> BatchedScores:
    """The numpy scoring above as float64 / int64 tensor programs over the
    whole config batch on ``device``. Tolerance path (see module
    docstring): sums reduce in the device's order, not left to right."""
    f64, i64 = torch.float64, torch.int64

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    B, S = st_time.shape
    E = tab.n_edges
    time_t, mask = put(st_time, f64), put(st_mask, torch.bool)
    kind, stage = put(st_kind, i64), put(stage_of, i64)
    pid, slr = put(st_pid, i64), put(st_slr, i64)
    clk, peak = put(st_clk, f64), put(st_peak, f64)
    caps = put(caps_kind, f64)[kind]
    e_prod = put(tab.edge_prod, i64).expand(B, E)
    e_cons = put(tab.edge_cons, i64).expand(B, E)
    e_tensor = put(tab.edge_tensor, i64).expand(B, E)
    tw = put(np.stack([tab.edge_t_write[k] for k in tab.kinds]), f64)  # (K, E)
    tr = put(np.stack([tab.edge_t_read[k] for k in tab.kinds]), f64)
    timed = device.type == "cuda"
    if timed:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()

    rows = torch.arange(B, device=device)[:, None]
    uncoupled = torch.where(mask, time_t, -torch.inf).amax(dim=1)
    uncoupled = torch.where(torch.isfinite(uncoupled), uncoupled, 0.0)
    ps = torch.gather(stage, 1, e_prod)
    cs = torch.gather(stage, 1, e_cons)
    dist = cs - ps
    # credit depth: beta = max stage distance per tensor slot (flattened
    # row * width + col scatter onto zeros, as np.maximum.at), never below 1
    W = max(tab.n_tensor_slots, 1)
    beta = torch.zeros(B * W, dtype=i64, device=device).scatter_reduce_(
        0, (rows * W + e_tensor).reshape(-1), dist.reshape(-1), "amax",
        include_self=True).view(B, W)
    depth = torch.gather(beta, 1, e_tensor) + 1

    pk, ck = torch.gather(kind, 1, ps), torch.gather(kind, 1, cs)
    hops = (torch.gather(pid, 1, ps) - torch.gather(pid, 1, cs)).abs()
    slr_cross = (torch.gather(slr, 1, ps) != torch.gather(slr, 1, cs)).to(i64)
    pclk, cclk = torch.gather(clk, 1, ps), torch.gather(clk, 1, cs)
    t_write = torch.gather(tw, 0, pk)
    t_read = torch.gather(tr, 0, ck)
    # token_latency_cycles in int64, divided by the float64 clocks
    lat_cyc = torch.where(
        hops == 0, SAME_PU_LATENCY,
        BASE_HOP_LATENCY + (hops > 2).to(i64) + SLR_CROSS_PENALTY * slr_cross)
    l_req = lat_cyc / pclk
    l_ack = lat_cyc / cclk
    t_dec = (4 * DECODE_CYCLES) / pclk  # _HANDSHAKE_DECODES
    cycle = (((t_write + l_req) + t_read) + l_ack) + t_dec
    bound = cycle / depth
    cross = dist > 0
    worst = torch.where(cross, bound, 0.0).amax(dim=1)
    round_s = torch.maximum(uncoupled, worst)

    # forward latency: min one-way REQ latency per distinct stage hop
    # (flattened scatter onto inf, as np.minimum.at), summed
    req_lat = l_req + (2 * DECODE_CYCLES) / pclk
    H = (S + 1) * (S + 1)
    hid = ps * (S + 1) + cs
    hop_min = torch.full((B * H,), torch.inf, dtype=f64, device=device)
    hop_min.scatter_reduce_(0, (rows * H + hid).reshape(-1),
                            torch.where(cross, req_lat, torch.inf).reshape(-1),
                            "amin", include_self=True)
    hop_min = hop_min.view(B, H)
    fwd = torch.where(torch.isfinite(hop_min), hop_min, 0.0).sum(dim=1)

    times_m = torch.where(mask, time_t, 0.0)
    lat = times_m.sum(dim=1) + fwd
    tops = torch.where(mask, peak, 0.0).sum(dim=1)
    num = (times_m * caps).sum(dim=1)
    den = round_s * torch.where(mask, caps, 0.0).sum(dim=1)
    live = round_s != 0.0
    pbe = torch.where(mask.any(dim=1) & live,
                      num / torch.where(den != 0.0, den, 1.0), 0.0)
    fps = torch.where(live, 1.0 / torch.where(live, round_s, 1.0), 0.0)
    if timed:
        ev1.record()

    fps, lat, tops, pbe, round_s, uncoupled, worst = (
        t.cpu().numpy() for t in (fps, lat, tops, pbe, round_s, uncoupled, worst))
    if timed:
        PROFILE["score_device"] = (PROFILE.get("score_device", 0.0)
                                   + ev0.elapsed_time(ev1) / 1e3)
    return BatchedScores(
        configs=list(configs), fps=fps, latency=lat, tops=tops, pbe=pbe,
        round_seconds=round_s, uncoupled_seconds=uncoupled,
        binding_bound=worst,
    )
