"""Top-level compilation driver: DNN graph -> executable PUPrograms.

The framework phases of Fig. 4 are split along their data dependencies into
three explicit layers, so the DSE (Sec. V-A) never recomputes — or even
runs — work a design point does not need:

``analyze(g, pus)``
    The *config-independent* artifact: fusion, per-PU-kind node profiling,
    and a memo of per-(node-segment, PU-kind) SMOF weight schedules. It is
    computed **once per graph content** (memoized by ``Graph.fingerprint``)
    and shared by every (a, b) configuration a sweep evaluates.

``place(analysis, a, b)``
    The *cheap per-config* step: DP partitioning over the cached profiles,
    weight schedules looked up (or filled in) from the analysis memo, and
    the analytic stage times — everything the DSE cache reads. No memory
    planning, no instruction generation.

``CompiledModel.programs`` / ``CompiledModel.mem``
    *Lazy* codegen: pipeline memory optimization and instruction generation
    run on first access, i.e. only when a deployment actually needs
    executable programs. ``compile_deployment`` forces them at deploy time;
    ``explore``/``explore_multi`` never touch them.

``compile_model(g, a, b)`` remains the one-call form (= ``analyze`` +
``place``) and is what non-DSE callers use. Module-level ``STATS`` counts
phase invocations: the evidence that the sweep does no redundant work (the
port's counters move as the JAX package's do for the same calls). Like the
caches below, they are this package's own, apart from the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from ..core.program import PUProgram
from ..core.pu import PUSpec, make_u50_system
from .codegen import generate_programs
from .coupling import CouplingModel, couple
from .fusion import fuse
from .graph import Graph
from .memory import MemoryPlan, assign_channels, buffer_requirements
from .partition import Partition, partition
from .profiler import DECODE_CYCLES, NodeProfile, profile_graph
from .weights import WeightSchedule, schedule_weights, segment_shape_key


@dataclass
class CompileStats:
    """Process-wide counters of actual phase executions (memo hits excluded).

    Snapshot these around a sweep to read the engine's work profile: one
    fuse/profile per graph, zero codegen during exploration. ``reset()``
    zeroes all counters."""

    fuse_calls: int = 0
    profile_calls: int = 0
    weight_schedule_calls: int = 0
    weight_schedule_shape_hits: int = 0  # rebinds of a shape-equal schedule
    partition_calls: int = 0
    memory_plan_calls: int = 0
    codegen_calls: int = 0
    analysis_hits: int = 0
    analysis_misses: int = 0
    tables_builds: int = 0  # dense AnalysisTables exports (once per analysis)
    batched_score_calls: int = 0  # vectorized scoring passes (repro_torch.dse.batched)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def snapshot(self) -> dict[str, int]:
        return dataclasses.asdict(self)


STATS = CompileStats()


@dataclass
class GraphAnalysis:
    """Config-independent compile artifact shared across all (a, b) configs.

    Holds the fused graph, the per-PU-kind node profiles, and a lazy memo of
    per-(node-segment, PU-kind) weight schedules with their derived stage
    overheads (stall + dynamic-chunk decode). Everything here depends only
    on graph content and PU *types* — never on how many PUs a configuration
    assigns — which is what makes one analysis serve a whole DSE sweep.
    Cached objects are treated as immutable by all downstream phases."""

    source_graph: Graph
    graph: Graph  # fused
    pu_kinds: dict[str, PUSpec]
    profiles: dict[str, dict[int, NodeProfile]]
    _wscheds: dict[tuple[tuple[int, ...], str], WeightSchedule] = field(
        default_factory=dict)
    _stage_overheads: dict[tuple[tuple[int, ...], str], float] = field(
        default_factory=dict)
    # shared f(i, u1, u2) table of the partition DP — its subproblems are
    # budget-independent, so config (a, b) reuses everything (a', b') solved
    _partition_memo: dict[tuple[int, int, int], float] = field(
        default_factory=dict)
    # lazy dense-array export for the vectorized DSE engine
    _tables: Optional[object] = field(default=None, repr=False, compare=False)

    def weight_schedule(self, nids: tuple[int, ...], pu_kind: str) -> WeightSchedule:
        """SMOF schedule for a contiguous node segment on one PU kind,
        computed once per distinct (segment-*shape*, kind) across every
        config: a segment shape-identical to an already-scheduled one (a
        repeated transformer block under a different partition offset)
        rebinds the cached allocation instead of re-running the greedy
        pass."""
        key = (tuple(nids), pu_kind)
        ws = self._wscheds.get(key)
        if ws is None:
            spec = self.pu_kinds[pu_kind]
            skey = (dataclasses.replace(spec, pid=-1, slr=-1),
                    segment_shape_key(self.graph, key[0]))
            canon = _WSCHED_SHAPE_CACHE.get(skey)
            if canon is not None:
                STATS.weight_schedule_shape_hits += 1
                ws = canon.rebound(key[0])
            else:
                STATS.weight_schedule_calls += 1
                ws = schedule_weights(self.graph, list(key[0]), spec)
                if len(_WSCHED_SHAPE_CACHE) >= _WSCHED_SHAPE_CACHE_MAX:
                    _WSCHED_SHAPE_CACHE.pop(next(iter(_WSCHED_SHAPE_CACHE)))
                _WSCHED_SHAPE_CACHE[skey] = ws
            self._wscheds[key] = ws
        return ws

    def stage_overhead(self, nids: tuple[int, ...], pu_kind: str) -> float:
        """Seconds added to a stage's profiled time: node-granular
        weight-stream stalls plus two CP instruction decodes per dynamic
        chunk (URAM_PRM + WEIGHTS_ADM issue), matching the codegen's
        one-node-lookahead chunk issue."""
        key = (tuple(nids), pu_kind)
        extra = self._stage_overheads.get(key)
        if extra is None:
            ws = self.weight_schedule(key[0], pu_kind)
            spec = self.pu_kinds[pu_kind]
            n_dyn = sum(t.dynamic_chunks for t in ws.tiles)
            extra = ws.total_stall() + 2 * n_dyn * DECODE_CYCLES / spec.sys_clk_hz
            self._stage_overheads[key] = extra
        return extra

    def tables(self) -> "object":
        """Dense-array export of this analysis for the vectorized DSE
        engine (``repro_torch.compiler.tables.AnalysisTables``): per-kind node
        profiles, weight-tile layout, coupling edge geometry and (grown on
        demand) the dense partition-DP value table. Built lazily once per
        analysis and shared by every batched scoring call."""
        if self._tables is None:
            from .tables import AnalysisTables

            STATS.tables_builds += 1
            self._tables = AnalysisTables(self.graph, self.profiles,
                                          self.pu_kinds)
        return self._tables


# graph-fingerprint -> GraphAnalysis memo (bounded; LRU eviction — lookups
# re-insert their key so the front of the dict is always the coldest entry)
_ANALYSIS_CACHE: dict[tuple, GraphAnalysis] = {}
_ANALYSIS_CACHE_MAX = 32

# (normalized PU spec, segment shape key) -> canonical SMOF schedule,
# shared across *analyses*: depth-scaled variants of one architecture (and
# repeated blocks within one graph) are shape-identical per segment, so
# they rebind the canonical allocation (WeightSchedule.rebound) instead of
# re-running the greedy pass. Bounded; insertion-order eviction.
_WSCHED_SHAPE_CACHE: dict[tuple, WeightSchedule] = {}
_WSCHED_SHAPE_CACHE_MAX = 4096


def _kind_key(pus: list[PUSpec]) -> tuple:
    """Cache-key part for the PU *types* (pid/slr placement is irrelevant to
    profiling and weight scheduling). Last spec of each kind wins, matching
    the ``{p.kind: p}`` dict build below."""
    kinds = {p.kind: p for p in pus}
    return tuple(sorted(
        (k, dataclasses.replace(p, pid=-1, slr=-1)) for k, p in kinds.items()
    ))


def clear_analysis_cache() -> None:
    _ANALYSIS_CACHE.clear()
    _WSCHED_SHAPE_CACHE.clear()


def analyze(
    g: Graph,
    pus: Optional[list[PUSpec]] = None,
    *,
    already_fused: bool = False,
    use_cache: bool = True,
) -> GraphAnalysis:
    """Fuse + profile ``g`` for the PU kinds of ``pus``, memoized by graph
    fingerprint — the once-per-graph half of compilation. ``use_cache=False``
    builds (and does not store) a fresh artifact: the brute-force baseline
    path of ``repro_torch.dse`` uses it to reproduce the pre-caching engine."""
    pus = pus if pus is not None else make_u50_system()
    key = (g.fingerprint(), bool(already_fused), _kind_key(pus))
    if use_cache:
        hit = _ANALYSIS_CACHE.get(key)
        if hit is not None:
            STATS.analysis_hits += 1
            # true LRU: re-insert on hit so eviction pops the coldest
            # entry, not simply the oldest-inserted one
            del _ANALYSIS_CACHE[key]
            _ANALYSIS_CACHE[key] = hit
            return hit
    STATS.analysis_misses += 1
    kinds = {p.kind: p for p in pus}
    if already_fused:
        fused = g
    else:
        STATS.fuse_calls += 1
        fused = fuse(g)
    STATS.profile_calls += 1
    profiles = profile_graph(
        fused, {k: kinds[k] for k in ("PU1x", "PU2x") if k in kinds})
    ana = GraphAnalysis(source_graph=g, graph=fused, pu_kinds=kinds,
                        profiles=profiles)
    if use_cache:
        if len(_ANALYSIS_CACHE) >= _ANALYSIS_CACHE_MAX:
            _ANALYSIS_CACHE.pop(next(iter(_ANALYSIS_CACHE)))
        _ANALYSIS_CACHE[key] = ana
    return ana


@dataclass
class CompiledModel:
    """One (a, b) configuration's compile result.

    The analytic model (``stage_times`` and everything derived from it) is
    materialized eagerly by :func:`place`; the executable form — the memory
    plan and the instruction programs — is generated lazily on first access
    of ``mem`` / ``programs``, so a DSE sweep that only reads predicted
    rates never runs memory planning or the 16-round instruction codegen."""

    graph: Graph  # fused
    source_graph: Graph
    part: Partition
    wscheds: dict[int, WeightSchedule]
    pid_map: dict[int, int]
    pu_specs: dict[int, PUSpec]
    rounds: int
    # analytic model
    stage_times: dict[int, float]  # incl. weight-streaming stalls
    analysis: GraphAnalysis
    # cross-stage credit-loop model (repro_torch.compiler.coupling); None only for
    # hand-built instances, which fall back to the uncoupled max-stage view
    coupling: Optional[CouplingModel] = None
    n_pu1x: int = 0
    n_pu2x: int = 0
    # deferred-codegen context
    n_io: int = 4
    channel_pool: Optional[list[int]] = None
    _mem: Optional[MemoryPlan] = None
    _programs: Optional[list[PUProgram]] = None

    # -- lazy executable form ------------------------------------------------
    @property
    def mem(self) -> MemoryPlan:
        """Pipeline memory plan (buffer requirements + channel assignment),
        built on first access."""
        if self._mem is None:
            STATS.memory_plan_calls += 1
            plans = buffer_requirements(self.graph, self.part, n_io=self.n_io)
            self._mem = assign_channels(self.graph, self.part, plans,
                                        self.analysis.profiles,
                                        channel_pool=self.channel_pool)
        return self._mem

    @property
    def programs(self) -> list[PUProgram]:
        """Per-stage instruction programs, generated on first access (the
        deploy layer forces this; the DSE never reaches it)."""
        if self._programs is None:
            STATS.codegen_calls += 1
            self._programs = generate_programs(
                self.graph, self.part, self.mem, self.wscheds,
                self.pid_map, self.pu_specs, rounds=self.rounds,
            )
        return self._programs

    def ensure_programs(self) -> list[PUProgram]:
        """Force codegen now (deploy-time hook); returns the programs."""
        return self.programs

    # -- predicted performance (pre-simulation; the DSE cache) ---------------
    @property
    def predicted_round_time(self) -> float:
        """Steady-state round period: the coupled credit-system rate (max of
        the per-stage serial bounds and every cross-stage credit-loop bound),
        not merely ``max(stage_times)``."""
        if self.coupling is not None:
            return self.coupling.round_seconds
        return max(self.stage_times.values()) if self.stage_times else 0.0

    @property
    def predicted_fps(self) -> float:
        t = self.predicted_round_time
        return 1.0 / t if t else 0.0

    @property
    def predicted_latency(self) -> float:
        lat = sum(self.stage_times.values())
        if self.coupling is not None:
            lat += self.coupling.forward_latency_seconds
        return lat

    @property
    def used_tops(self) -> float:
        return sum(
            self.pu_specs[self.pid_map[s.index]].peak_tops
            for s in self.part.stages
            if s.nids
        )

    def pbe(self) -> float:
        # relative stage capacities from the PU specs themselves (peak_tops),
        # so a non-default PU array weights its stages correctly
        caps = {k: spec.peak_tops for k, spec in self.analysis.pu_kinds.items()}
        used = [s for s in self.part.stages if s.nids]
        tmax = self.predicted_round_time
        if not used or tmax == 0:
            return 0.0
        num = sum(self.stage_times[s.index] * caps[s.pu_kind] for s in used)
        den = tmax * sum(caps[s.pu_kind] for s in used)
        return num / den

    def compute_efficiency(self, peak_tops: Optional[float] = None) -> float:
        """CE = achieved GOPS / peak GOPS (of the PUs given; defaults to the
        PUs used by this configuration)."""
        peak = peak_tops if peak_tops is not None else self.used_tops
        gops = 2.0 * self.graph.total_macs() * self.predicted_fps / 1e9
        return gops / (peak * 1e3) if peak else 0.0


def assign_pids(part: Partition, pus: list[PUSpec]) -> dict[int, int]:
    """Map pipeline stages to physical PU ids by kind, in pipeline order."""
    free = {"PU1x": [p.pid for p in pus if p.kind == "PU1x"],
            "PU2x": [p.pid for p in pus if p.kind == "PU2x"]}
    pid_map: dict[int, int] = {}
    for s in part.stages:
        if not s.nids:
            continue
        if not free[s.pu_kind]:
            raise ValueError(f"no free {s.pu_kind} for stage {s.index}")
        pid_map[s.index] = free[s.pu_kind].pop(0)
    return pid_map


def place(
    analysis: GraphAnalysis,
    n_pu1x: int,
    n_pu2x: int,
    *,
    pus: Optional[list[PUSpec]] = None,
    rounds: int = 16,
    n_io: int = 4,
    pid_offset: dict[str, int] | None = None,
    channel_pool: list[int] | None = None,
) -> CompiledModel:
    """Place a pre-analyzed graph onto a (n_pu1x, n_pu2x) pipeline config.

    The cheap per-config step: DP partition over the analysis' cached
    profiles, weight schedules from the analysis memo, analytic stage times.
    Memory planning and instruction generation are deferred to the returned
    model's lazy ``mem``/``programs``. ``pus`` must carry the same PU kinds
    the analysis was built with (it defaults to the same fixed machine)."""
    pus = pus if pus is not None else make_u50_system()
    if _kind_key(pus) != _kind_key(list(analysis.pu_kinds.values())):
        raise ValueError(
            "place() was given PU specs whose kinds differ from the ones "
            "this GraphAnalysis was built with — re-run analyze(g, pus)"
        )
    fused = analysis.graph
    STATS.partition_calls += 1
    part = partition(fused, analysis.profiles, n_pu1x, n_pu2x,
                     memo=analysis._partition_memo)

    wscheds: dict[int, WeightSchedule] = {}
    stage_times: dict[int, float] = {}
    for s in part.stages:
        if not s.nids:
            continue
        wscheds[s.index] = analysis.weight_schedule(s.nids, s.pu_kind)
        stage_times[s.index] = s.time + analysis.stage_overhead(s.nids, s.pu_kind)

    # Cross-stage credit-loop coupling (repro_torch.compiler.coupling): buffer
    # depths straight from the stage-distance analysis (cheap; the liveness/
    # channel planning behind ``.mem`` stays deferred) and ISU token
    # latencies on the *canonical* stage->pid assignment, so offset-placed
    # multi-batch members predict identically to the DSE cache.
    plans = buffer_requirements(fused, part, n_io=n_io)
    coupling = couple(fused, part, plans, stage_times,
                      assign_pids(part, pus), {p.pid: p for p in pus})

    if pid_offset:
        skip = dict(pid_offset)
        pool = []
        for p in pus:
            if skip.get(p.kind, 0) > 0:
                skip[p.kind] -= 1
                continue
            pool.append(p)
    else:
        pool = pus
    pid_map = assign_pids(part, pool)
    pu_specs = {p.pid: p for p in pus}

    return CompiledModel(
        graph=fused,
        source_graph=analysis.source_graph,
        part=part,
        wscheds=wscheds,
        pid_map=pid_map,
        pu_specs=pu_specs,
        rounds=rounds,
        stage_times=stage_times,
        analysis=analysis,
        coupling=coupling,
        n_pu1x=n_pu1x,
        n_pu2x=n_pu2x,
        n_io=n_io,
        channel_pool=channel_pool,
    )


def compile_model(
    g: Graph,
    n_pu1x: int,
    n_pu2x: int,
    *,
    pus: Optional[list[PUSpec]] = None,
    rounds: int = 16,
    n_io: int = 4,
    already_fused: bool = False,
    pid_offset: dict[str, int] | None = None,
    channel_pool: list[int] | None = None,
) -> CompiledModel:
    """Compile ``g`` for a (n_pu1x, n_pu2x) single-batch pipeline config —
    the one-call form of ``analyze`` + ``place`` (analysis memoized by graph
    fingerprint; programs generated lazily on first ``.programs`` access).

    ``pid_offset`` lets multi-batch deployments place this pipeline on a
    disjoint PU subset (e.g. {"PU1x": 2, "PU2x": 0} starts at the 3rd PU1x);
    ``channel_pool`` likewise gives it a disjoint HBM channel subset.
    """
    pus = pus if pus is not None else make_u50_system()
    return place(
        analyze(g, pus, already_fused=already_fused),
        n_pu1x,
        n_pu2x,
        pus=pus,
        rounds=rounds,
        n_io=n_io,
        pid_offset=pid_offset,
        channel_pool=channel_pool,
    )
