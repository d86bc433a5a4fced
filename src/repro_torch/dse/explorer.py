"""Three-step Design Space Exploration (paper Sec. V-A, Fig. 5).

Step 1 — enumerate all feasible single-batch configurations (a, b): a PU1x +
b PU2x units pipelining one batch. With 5+5 PUs this yields 35 configs. The
config-independent compile work (fusion, profiling, per-segment weight
scheduling) is done **once per graph** (``repro_torch.compiler.analyze``, memoized
by graph fingerprint) and every config is evaluated by the cheap
``repro_torch.compiler.place`` — no memory planning and no instruction codegen
happens anywhere in the sweep; programs are generated lazily only when a
design point is actually deployed.

Step 2 — compose multi-batch schedules: all unordered combinations of
single-batch configurations within the PU resource constraint. Each batch is
processed by a disjoint PU subset with internal pipeline parallelism (hybrid
parallelism). Schedule metrics: aggregated throughput, system latency (the
slowest member), cumulative TOPS of assigned PUs. Member configs that are
strictly Pareto-dominated at equal-or-lower PU cost are pruned from the
composition (frontier- and DP-point-preserving at tolerance 0; margin-aware
at tolerance > 0; see ``_cost_dominated_configs``).

Step 3 — Pareto analysis (repro_torch.dse.pareto; sort-based O(n log n) for the
2-objective case) + application constraints.

Multi-tenant co-exploration (``explore_multi``) generalizes Step 2 across
*models*: each tenant graph gets its own Step-1 cache (tenants referencing
the same graph content share one), joint placements assign every tenant a
disjoint (a, b) slice of the one machine, and the Pareto front is taken over
the vector of per-tenant rates — the FPGA-virtualization scenario (different
models serving different tenants) on the paper's fixed PU array. The joint
recursion is bounded by remaining-budget best-case throughput: a partial
placement whose optimistic completion is already strictly dominated by a
found point is abandoned.

``explore``/``explore_multi`` accept three engines. ``engine="batched"``
(the default; ``"fast"`` is kept as an alias) scores every Step-1 config in
one vectorized pass over the dense ``AnalysisTables`` export
(``repro_torch.dse.batched``); ``engine="scalar"`` runs the same analytic model
one ``place()`` call per config; ``engine="reference"`` is the pre-caching
brute-force engine (full recompile incl. eager codegen per config, unpruned
composition, O(n²) Pareto) — the oracle the equivalence tests and
the JAX package's ``benchmarks/dse_bench.py`` measure the other two against. All three
produce byte-identical frontiers and design points at tolerance 0.

``explore_multi(prev=...)`` re-explores incrementally: Step-1 caches of
tenants already present in a prior result are reused (matched by graph
fingerprint under the same PU array and budget) and the prior frontier
seeds the joint recursion's incumbent set, so a one-tenant change re-scores
only the changed tenant — exactly frontier-preserving.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..compiler.compile import analyze, place
from ..compiler.graph import Graph
from ..core.pu import PUSpec, make_u50_system
from .pareto import pareto_front, pareto_front_bruteforce

PU1X_TOPS = 0.3072
PU2X_TOPS = 0.6144


@dataclass(frozen=True)
class SingleBatchPoint:
    a: int  # PU1x units
    b: int  # PU2x units
    fps: float
    latency: float
    tops: float
    pbe: float

    @property
    def config(self) -> tuple[int, int]:
        return (self.a, self.b)

    # uniform schedule-like view (shared with MultiBatchSchedule) so DSE
    # consumers can read throughput/batch/configs off any design point
    @property
    def throughput(self) -> float:
        return self.fps

    @property
    def batch(self) -> int:
        return 1

    @property
    def configs(self) -> tuple[tuple[int, int], ...]:
        return (self.config,)


@dataclass(frozen=True)
class MultiBatchSchedule:
    configs: tuple[tuple[int, int], ...]  # sorted (a,b) per concurrent batch
    throughput: float  # aggregated fps
    latency: float  # slowest member pipeline
    tops: float  # cumulative DSP TOPS
    system_pbe: float  # capacity-weighted busy fraction across all members

    @property
    def batch(self) -> int:
        return len(self.configs)

    @property
    def total_a(self) -> int:
        return sum(c[0] for c in self.configs)

    @property
    def total_b(self) -> int:
        return sum(c[1] for c in self.configs)


def _point_of(cm, a: int, b: int) -> SingleBatchPoint:
    return SingleBatchPoint(a=a, b=b, fps=cm.predicted_fps,
                            latency=cm.predicted_latency, tops=cm.used_tops,
                            pbe=cm.pbe())


def _normalize_engine(engine: str) -> str:
    """Canonical engine name: "batched" (vectorized scorer, the default),
    "scalar" (per-config ``place()``), "reference" (pre-caching brute
    force). "fast" is the deprecated historical alias of the default."""
    if engine == "fast":
        from .._deprecation import warn_deprecated
        warn_deprecated(
            'engine="fast" is deprecated; use engine="batched" (the '
            "default vectorized scorer)", skip=(__name__,))
        return "batched"
    if engine not in ("batched", "scalar", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def enumerate_single_batch(
    g: Graph,
    *,
    n_pu1x: int = 5,
    n_pu2x: int = 5,
    pus: Optional[list[PUSpec]] = None,
    engine: str = "batched",
) -> list[SingleBatchPoint]:
    """Step 1: evaluate every (a, b) against one shared graph analysis.

    Fusion/profiling/weight-scheduling results come from the memoized
    ``analyze`` artifact; no instructions are generated. With the default
    ``engine="batched"`` the whole sweep is one vectorized scoring pass
    over the dense analysis tables (``repro_torch.dse.batched``);
    ``engine="scalar"`` pays one ``place()`` call per config. The two
    return byte-identical points."""
    if engine not in ("batched", "scalar"):
        raise ValueError(f"unknown Step-1 engine {engine!r}")
    pus = pus if pus is not None else make_u50_system()
    ana = analyze(g, pus)
    configs = [(a, b)
               for a in range(n_pu1x + 1)
               for b in range(n_pu2x + 1)
               if a + b > 0]
    if engine == "batched":
        from .batched import score_single_batch

        return score_single_batch(ana, configs, pus=pus)
    return [_point_of(place(ana, a, b, pus=pus), a, b) for a, b in configs]


def enumerate_single_batch_reference(
    g: Graph,
    *,
    n_pu1x: int = 5,
    n_pu2x: int = 5,
    pus: Optional[list[PUSpec]] = None,
) -> list[SingleBatchPoint]:
    """The pre-caching Step 1: re-run the *entire* compiler — fusion,
    profiling, weight scheduling, memory planning and eager instruction
    codegen whose programs are immediately discarded — once per config.
    Kept as the brute-force baseline for the equivalence suite and the
    before/after measurements of the JAX package's ``benchmarks/dse_bench.py``."""
    pus = pus if pus is not None else make_u50_system()
    points: list[SingleBatchPoint] = []
    for a in range(n_pu1x + 1):
        for b in range(n_pu2x + 1):
            if a + b == 0:
                continue
            ana = analyze(g, pus, use_cache=False)
            cm = place(ana, a, b, pus=pus)
            cm.ensure_programs()  # eager codegen, as the old engine did
            points.append(_point_of(cm, a, b))
    return points


def _cost_dominated_configs(
    by_cfg: dict[tuple[int, int], SingleBatchPoint],
    *,
    use_latency: bool,
    fps_margin: float = 0.0,
) -> set[tuple[int, int]]:
    """Member configs strictly dominated at equal-or-lower PU cost: another
    config uses no more PU1x and no more PU2x yet achieves *strictly* higher
    fps — by more than ``fps_margin`` — (and, with ``use_latency``, no worse
    latency).

    Composing with such a config can never help: swapping in the dominating
    config yields a feasible schedule with the same batch and strictly
    higher throughput (throughput — per schedule or per tenant — is a sum
    resp. a vector component, so the member-level improvement is never
    masked) — so at tolerance 0 every schedule containing a dominated config
    is strictly dominated (off the frontier) and DP-B's tie-breaks resolve
    to the surviving, earlier-enumerated schedule. The fps *strictness* is
    load-bearing: a config better only in latency must be kept, because
    schedule latency is a max over members and another member can mask the
    improvement, leaving the two schedules exactly tied — and tied schedules
    are all frontier members. Exact fps ties (common when extra PUs add
    nothing) are therefore never pruned, which keeps frontiers byte-identical
    to the brute-force path.

    ``use_latency=True`` (single-model Step 2) additionally requires the
    dominating config not to worsen latency, since schedule latency is an
    objective there; ``use_latency=False`` (multi-tenant joint placements)
    ignores latency because the joint frontier is over fps vectors only.

    ``fps_margin > 0`` is the tolerance-aware mode (see
    ``enumerate_multi_batch``): with margin ``tolerance * T_max`` (``T_max``
    the best achievable schedule throughput) every schedule containing a
    pruned config has a kept swap-in counterpart *strictly beyond its
    throughput tolerance threshold* at no worse latency — so the exact
    frontier, every DP point, and the tolerant-frontier membership of every
    kept schedule are preserved (the tolerant frontier of the pruned set is
    the reference tolerant frontier restricted to kept schedules). Exact
    set-equality of tolerant frontiers is unattainable for *any* engaged
    config prune: schedule latency is a max over members, so another member
    can mask the latency axis of the tolerance-dominance test."""
    dead: set[tuple[int, int]] = set()
    for c, p in by_cfg.items():
        for c2, q in by_cfg.items():
            if (c2 != c and c2[0] <= c[0] and c2[1] <= c[1]
                    and q.fps > p.fps + fps_margin
                    and (not use_latency or q.latency <= p.latency)):
                dead.add(c)
                break
    return dead


def _max_schedule_throughput(
    by_cfg: dict[tuple[int, int], SingleBatchPoint],
    n_pu1x: int,
    n_pu2x: int,
) -> float:
    """Best achievable total fps of any multi-batch schedule under the PU
    budget (unbounded 2-D knapsack over member configs). Upper-bounds every
    composed schedule's throughput — the normalizer that turns the relative
    Pareto ``tolerance`` into the absolute ``fps_margin`` of
    ``_cost_dominated_configs``."""
    dp = [[0.0] * (n_pu2x + 1) for _ in range(n_pu1x + 1)]
    for (a, b), p in by_cfg.items():
        if p.fps <= 0.0:
            continue
        for ra in range(a, n_pu1x + 1):
            row = dp[ra]
            src = dp[ra - a]
            for rb in range(b, n_pu2x + 1):
                cand = src[rb - b] + p.fps
                if cand > row[rb]:
                    row[rb] = cand
    return dp[n_pu1x][n_pu2x]


def enumerate_multi_batch(
    points: list[SingleBatchPoint],
    *,
    n_pu1x: int = 5,
    n_pu2x: int = 5,
    prune: bool = True,
    tolerance: float = 0.0,
) -> list[MultiBatchSchedule]:
    """Step 2: all unordered combinations under the PU resource constraint.

    ``prune=True`` drops member configs that are strictly dominated at
    equal-or-lower cost before composing (see ``_cost_dominated_configs``) —
    pass ``prune=False`` for the exhaustive brute-force composition.

    ``tolerance`` is the Pareto tolerance of the downstream frontier
    extraction: at ``tolerance > 0`` the dominance test demands an fps
    margin of ``tolerance * T_max`` so pruning stays engaged without
    touching the exact frontier, the DP points, or the tolerant-frontier
    membership of any kept schedule (a dropped schedule always has a kept
    counterpart more than ``tolerance`` ahead in throughput at no worse
    latency)."""
    by_cfg = {p.config: p for p in points}
    cfgs = sorted(by_cfg)  # deterministic order for unordered enumeration
    if prune:
        margin = (tolerance * _max_schedule_throughput(by_cfg, n_pu1x, n_pu2x)
                  if tolerance > 0.0 else 0.0)
        dead = _cost_dominated_configs(by_cfg, use_latency=True,
                                       fps_margin=margin)
        cfgs = [c for c in cfgs if c not in dead]
    schedules: list[MultiBatchSchedule] = []

    def rec(idx: int, rem_a: int, rem_b: int, chosen: list[tuple[int, int]]) -> None:
        if chosen:
            members = [by_cfg[c] for c in chosen]
            thr = sum(m.fps for m in members)
            lat = max(m.latency for m in members)
            tops = sum(m.tops for m in members)
            # system PBE: capacity-weighted utilization across members; each
            # member's PUs are busy pbe fraction of its round.
            pbe = sum(m.pbe * m.tops for m in members) / tops if tops else 0.0
            schedules.append(
                MultiBatchSchedule(
                    configs=tuple(sorted(chosen)),
                    throughput=thr,
                    latency=lat,
                    tops=tops,
                    system_pbe=pbe,
                )
            )
        for i in range(idx, len(cfgs)):
            a, b = cfgs[i]
            if a <= rem_a and b <= rem_b:
                chosen.append((a, b))
                rec(i, rem_a - a, rem_b - b, chosen)  # multiset: reuse i
                chosen.pop()

    rec(0, n_pu1x, n_pu2x, [])
    return schedules


@dataclass(frozen=True)
class ValidationRecord:
    """Analytic-cache cross-check: one schedule simulated end to end."""

    configs: tuple[tuple[int, int], ...]
    analytic_fps: float
    simulated_fps: float

    @property
    def rel_err(self) -> float:
        if not self.analytic_fps:
            return float("inf")
        return abs(self.simulated_fps - self.analytic_fps) / self.analytic_fps


@dataclass
class DSEResult:
    single: list[SingleBatchPoint]
    multi: list[MultiBatchSchedule]
    single_frontier: list[SingleBatchPoint]
    multi_frontier: list[MultiBatchSchedule]
    # deployment context: what was explored, on which machine — ``workload``
    # preserves an explored Workload's label/rounds overrides for deploys
    graph: Optional[Graph] = None
    pus: Optional[list[PUSpec]] = None
    workload: "Optional[object]" = None  # repro_torch.deploy.Workload when given
    # the PU budget that was explored (DP-C's one-PU-per-batch target and
    # any other budget-derived design point read these, so non-default PU
    # arrays resolve correctly instead of raising LookupError)
    n_pu1x: int = 5
    n_pu2x: int = 5
    validation: list[ValidationRecord] = field(default_factory=list)

    def deploy(self, point_or_schedule, *, rounds: Optional[int] = None):
        """Compile any Step-1 point / Step-2 schedule (or raw config tuple)
        of this exploration into an executable Deployment — every DSE design
        point is one call away from the simulator. Instruction programs are
        generated here (and only here): the exploration itself never runs
        codegen. ``rounds=None`` keeps the per-workload default (explicit
        Workload.rounds, else one full decode window for decode graphs,
        else 16)."""
        if self.graph is None:
            raise ValueError("this DSEResult carries no graph to deploy")
        from ..deploy import Strategy, compile_deployment

        return compile_deployment(
            self.workload if self.workload is not None else self.graph,
            Strategy.of(point_or_schedule), pus=self.pus, rounds=rounds
        )

    def simulate(self, point_or_schedule, *, rounds: Optional[int] = None):
        """Deploy + execute on a fresh fixed system; returns the SimResult."""
        from ..deploy import System

        dep = self.deploy(point_or_schedule, rounds=rounds)
        return System(pus=self.pus).load(dep).run()

    # paper design points -----------------------------------------------------
    @property
    def dp_a(self) -> SingleBatchPoint:
        """Highest single-batch throughput (pipeline across all PUs)."""
        return max(self.single, key=lambda p: p.fps)

    @property
    def dp_b(self) -> MultiBatchSchedule:
        """Max system throughput at the smallest batch achieving it."""
        best = max(self.multi, key=lambda s: s.throughput)
        near = [s for s in self.multi if s.throughput >= 0.995 * best.throughput]
        return min(near, key=lambda s: (s.batch, s.latency))

    @property
    def dp_c(self) -> MultiBatchSchedule:
        """Maximum batch-level parallelism: one PU per batch, for the PU
        budget this exploration actually ran with."""
        target = tuple(sorted([(1, 0)] * self.n_pu1x + [(0, 1)] * self.n_pu2x))
        for s in self.multi:
            if s.configs == target:
                return s
        raise LookupError("one-PU-per-batch schedule missing")


@dataclass(frozen=True)
class MultiTenantPoint:
    """One joint placement: tenant ``i`` runs on its own ``configs[i]``
    slice, with per-tenant analytic rate/latency from that tenant's own
    Step-1 cache."""

    configs: tuple[tuple[int, int], ...]  # (a, b) per tenant, tenant order
    fps: tuple[float, ...]
    latency: tuple[float, ...]
    tops: float

    @property
    def batch(self) -> int:
        return len(self.configs)

    @property
    def total_a(self) -> int:
        return sum(c[0] for c in self.configs)

    @property
    def total_b(self) -> int:
        return sum(c[1] for c in self.configs)

    @property
    def system_latency(self) -> float:
        return max(self.latency)

    def __str__(self) -> str:
        body = " | ".join(
            f"({a},{b})@{f:.1f}fps" for (a, b), f in zip(self.configs, self.fps))
        return f"tenants[{body}]"


@dataclass(frozen=True)
class MultiTenantValidationRecord:
    """One joint placement simulated end to end: per-tenant simulated rate
    cross-checked against that tenant's own analytic model."""

    configs: tuple[tuple[int, int], ...]
    analytic_fps: tuple[float, ...]
    simulated_fps: tuple[float, ...]

    @property
    def rel_errs(self) -> tuple[float, ...]:
        return tuple(
            abs(s - a) / a if a else float("inf")
            for a, s in zip(self.analytic_fps, self.simulated_fps)
        )

    @property
    def max_rel_err(self) -> float:
        return max(self.rel_errs)


@dataclass
class MultiDSEResult:
    """Co-exploration result: joint placements of several tenants on one
    machine, Pareto-filtered by the vector of per-tenant rates."""

    workloads: tuple  # tuple[Workload, ...]
    singles: list[list[SingleBatchPoint]]  # Step-1 cache per tenant
    points: list[MultiTenantPoint]
    frontier: list[MultiTenantPoint]
    pus: Optional[list[PUSpec]] = None
    # the budget this co-exploration ran with — ``explore_multi(prev=...)``
    # reuses a prior result only when machine and budget are unchanged
    n_pu1x: int = 5
    n_pu2x: int = 5
    # per-tenant graph fingerprints at result time — ``prev=`` reuse keys
    # Step-1 caches on these (the content the caches were computed from)
    # instead of re-hashing possibly-mutated prev graph objects.
    fingerprints: tuple = ()  # tuple[str, ...]
    validation: list[MultiTenantValidationRecord] = field(default_factory=list)

    @property
    def n_tenants(self) -> int:
        return len(self.workloads)

    def best_solo_fps(self, i: int) -> float:
        """Tenant ``i``'s best rate with the whole machine to itself — the
        normalizer for fairness metrics."""
        return max(p.fps for p in self.singles[i])

    @property
    def balanced(self) -> MultiTenantPoint:
        """The max-min-fair joint placement: maximize the worst tenant's
        rate relative to what it could do alone on the full machine."""
        return max(
            self.frontier,
            key=lambda p: min(
                p.fps[i] / self.best_solo_fps(i) for i in range(self.n_tenants)
            ),
        )

    def strategy(self, point: MultiTenantPoint):
        """The joint placement as a workload-bound deploy Strategy."""
        from ..deploy import Strategy

        return Strategy.tenants(
            [(w, a, b) for w, (a, b) in zip(self.workloads, point.configs)],
            name=str(point),
        )

    def deploy(self, point: MultiTenantPoint, *, rounds: Optional[int] = None):
        """Compile the joint placement into an executable multi-tenant
        Deployment — every co-exploration point is one call away from the
        simulator, exactly like single-model DSE points. ``rounds=None``
        keeps each tenant's own default (Workload.rounds, else one full
        decode window for decode tenants, else 16)."""
        from ..deploy import compile_deployment

        return compile_deployment(None, self.strategy(point), pus=self.pus,
                                  rounds=rounds)

    def simulate(self, point: MultiTenantPoint, *, rounds: Optional[int] = None):
        from ..deploy import System

        dep = self.deploy(point, rounds=rounds)
        return System(pus=self.pus).load(dep).run()


def _best_case_fps(
    points: list[SingleBatchPoint], n_pu1x: int, n_pu2x: int
) -> list[list[float]]:
    """best[ra][rb] = max fps this tenant can reach with a budget of
    (ra PU1x, rb PU2x) — the optimistic completion bound of the joint
    recursion. -inf where nothing fits."""
    best = [[-math.inf] * (n_pu2x + 1) for _ in range(n_pu1x + 1)]
    by_cfg = {p.config: p for p in points}
    for ra in range(n_pu1x + 1):
        for rb in range(n_pu2x + 1):
            v = -math.inf
            if ra > 0:
                v = max(v, best[ra - 1][rb])
            if rb > 0:
                v = max(v, best[ra][rb - 1])
            p = by_cfg.get((ra, rb))
            if p is not None:
                v = max(v, p.fps)
            best[ra][rb] = v
    return best


def explore_multi(graphs, *, n_pu1x: int = 5, n_pu2x: int = 5,
                  tolerance: float = 0.0, pus: Optional[list[PUSpec]] = None,
                  validate: int = 0, validate_rounds: int = 5,
                  engine: str = "batched",
                  prev: Optional[MultiDSEResult] = None) -> MultiDSEResult:
    """Co-explore joint placements of several tenant models on one machine.

    ``graphs`` is a list of Graphs (or deploy ``Workload``s), one per tenant.
    Every tenant is compiled through its own Step-1 enumeration — tenants
    whose graphs have identical content (by fingerprint) share one — joint
    placements give each tenant one disjoint (a, b) member pipeline under
    the shared PU budget, and the returned frontier is Pareto-optimal in the
    vector of per-tenant rates (tenant-A fps, tenant-B fps, ...). The joint
    recursion abandons partial placements whose best-case completion (each
    remaining tenant granted the whole remaining budget) is already
    dominated beyond the tolerance threshold by a found placement — exactly
    frontier-preserving at any tolerance >= 0; at tolerance 0 it
    additionally pre-prunes per-tenant configs that are strictly
    fps-dominated at equal-or-lower cost (sound only under exact dominance:
    the other tenants' unchanged rates mask any margin version).
    ``engine="reference"`` disables both and runs the brute-force engine;
    ``engine="scalar"`` keeps them but scores Step 1 per-config instead of
    through the batched engine.

    ``prev`` makes the co-exploration incremental: any tenant whose graph
    fingerprint appears in ``prev`` (same PU array, same budget) reuses its
    prior Step-1 cache verbatim, and the prior frontier is projected onto
    the new tenant list to seed the joint recursion's incumbent set — so
    adding, dropping or swapping one tenant re-scores only that tenant's
    candidate slice. Every seed is an achievable placement of *this* run's
    search space, so the bound stays exactly frontier-preserving and the
    result equals the from-scratch exploration.

    ``validate=N`` deploys + simulates up to N joint placements (the
    max-min-fair ``balanced`` point first, then the frontier by normalized
    rate product) and cross-checks each tenant's simulated rate against its
    own analytic model in ``MultiDSEResult.validation``. When any tenant
    carries its own round semantics (explicit ``Workload.rounds`` or a
    decode window), validation keeps the per-member defaults instead of
    forcing ``validate_rounds``, so decode tenants are cross-checked over
    their full advancing-length cycle."""
    from ..deploy import Workload

    engine = _normalize_engine(engine)
    workloads = tuple(Workload.of(g) for g in graphs)
    if len(workloads) < 2:
        raise ValueError("explore_multi needs at least two tenant graphs")
    pus = pus if pus is not None else make_u50_system()
    fast = engine != "reference"
    # The per-tenant config pre-prune is sound only under exact dominance:
    # swapping one tenant's config leaves every *other* tenant's rate
    # unchanged, and a tolerant dominator must clear the threshold on every
    # component — masked axes make a margin version impossible. The
    # incumbent bound below, by contrast, is margin-aware and stays engaged
    # at any tolerance >= 0 (an incumbent clearing the tolerance-scaled
    # threshold of an *optimistic* completion excludes every actual
    # completion from the tolerant frontier — exactly frontier-preserving).
    cfg_prune = fast and tolerance == 0.0
    bound = fast and tolerance >= 0.0

    # Incremental re-exploration: a prior result's Step-1 caches carry over
    # for any tenant still present (matched by graph fingerprint), provided
    # machine and budget are unchanged — the points are a pure function of
    # (graph, pus, budget).
    fps_order = [w.graph.fingerprint() for w in workloads]
    prev_fps: list[str] = []
    step1_by_fp: dict[str, list[SingleBatchPoint]] = {}
    if prev is not None and fast and prev.pus == pus \
            and prev.n_pu1x == n_pu1x and prev.n_pu2x == n_pu2x:
        prev_fps = (list(prev.fingerprints) if prev.fingerprints
                    else [w.graph.fingerprint() for w in prev.workloads])
        for fp, pts in zip(prev_fps, prev.singles):
            step1_by_fp.setdefault(fp, pts)
    else:
        prev = None

    singles: list[list[SingleBatchPoint]] = []
    caches: list[dict[tuple[int, int], SingleBatchPoint]] = []
    for w, fp in zip(workloads, fps_order):
        pts = step1_by_fp.get(fp) if fast else None
        if pts is None:
            if fast:
                pts = enumerate_single_batch(w.graph, n_pu1x=n_pu1x,
                                             n_pu2x=n_pu2x, pus=pus,
                                             engine=engine)
            else:
                pts = enumerate_single_batch_reference(
                    w.graph, n_pu1x=n_pu1x, n_pu2x=n_pu2x, pus=pus)
            step1_by_fp[fp] = pts
        singles.append(pts)
        caches.append({p.config: p for p in pts})

    # Joint enumeration: one ordered config per tenant, disjoint PU budgets.
    points: list[MultiTenantPoint] = []
    if cfg_prune:
        cfg_lists = []
        for cache in caches:
            dead = _cost_dominated_configs(cache, use_latency=False)
            cfg_lists.append(sorted(c for c in cache if c not in dead))
    else:
        cfg_lists = [sorted(c) for c in caches]
    best_case = [_best_case_fps(s, n_pu1x, n_pu2x) for s in singles]
    n_tenants = len(workloads)
    # Non-dominated incumbent fps vectors live in ``inc_arr[:inc_n]``: a
    # grow-on-demand row array so the dominance tests below run as one
    # vectorized comparison per call instead of Python loops — on deep
    # joint recursions the incumbent checks are the hot path.
    inc_arr = np.empty((64, max(n_tenants, 1)))
    inc_n = 0

    def bounded_out(i: int, rem_a: int, rem_b: int, got: list[float]) -> bool:
        """True when this partial placement cannot contribute a frontier
        point: a remaining tenant cannot fit at all, or the optimistic
        completion is strictly dominated by an already-found placement."""
        if rem_a + rem_b < n_tenants - i:  # every tenant needs >= 1 PU
            return True
        opt = list(got)
        for j in range(i, n_tenants):
            b = best_case[j][rem_a][rem_b]
            if b == -math.inf:
                return True
            opt.append(b)
        if not bound or not inc_n:
            return False
        A = inc_arr[:inc_n]
        o = np.array(opt)
        if tolerance == 0.0:
            # finite rates: sign(A - o) encodes both comparisons, so the
            # dominance test is one subtract plus two reductions.
            D = A - o
            return bool(((D.min(axis=1) >= 0.0)
                         & (D.max(axis=1) > 0.0)).any())
        thr = np.where(o >= 0.0, o * (1.0 + tolerance), o * (1.0 - tolerance))
        return bool(((A >= thr).all(axis=1) & (A > o).any(axis=1)).any())

    def note_incumbent(fps: tuple[float, ...]) -> None:
        nonlocal inc_arr, inc_n
        f = np.array(fps)
        if inc_n:
            # sign(f - A) per row: mn >= 0 & mx > 0 means f dominates the
            # incumbent; mx <= 0 means the incumbent weakly dominates f
            # (disjoint conditions, so one pass serves both tests).
            D = f - inc_arr[:inc_n]
            mx = D.max(axis=1)
            dominated = (D.min(axis=1) >= 0.0) & (mx > 0.0)
            if (mx <= 0.0).any():
                return  # weakly dominated by a surviving incumbent
            if dominated.any():
                kept = inc_arr[:inc_n][~dominated]  # fancy index copies
                inc_n = len(kept)
                inc_arr[:inc_n] = kept
        if inc_n == len(inc_arr):
            inc_arr = np.concatenate([inc_arr, np.empty_like(inc_arr)])
        inc_arr[inc_n] = f
        inc_n += 1

    if prev is not None and bound and prev.frontier:
        # Project each prior frontier point onto the new tenant list:
        # tenants matched by fingerprint keep their prior config, new
        # tenants greedily take their best-rate config that still fits.
        # Every successful projection is an achievable placement of *this*
        # run's search space, so seeding its rate vector prunes only
        # partial placements a real point dominates beyond tolerance — the
        # incumbent bound stays exactly frontier-preserving while the
        # recursion starts warm instead of rediscovering the old frontier.
        for pt in prev.frontier:
            pool: dict[str, list[tuple[int, int]]] = {}
            for fp, cfg in zip(prev_fps, pt.configs):
                pool.setdefault(fp, []).append(cfg)
            chosen: list[Optional[tuple[int, int]]] = []
            for fp in fps_order:
                cfgs = pool.get(fp)
                chosen.append(cfgs.pop(0) if cfgs else None)
            rem_a = n_pu1x - sum(c[0] for c in chosen if c is not None)
            rem_b = n_pu2x - sum(c[1] for c in chosen if c is not None)
            ok = rem_a >= 0 and rem_b >= 0
            if ok:
                for i, cfg in enumerate(chosen):
                    if cfg is not None:
                        continue
                    best_cfg, best_fps = None, -math.inf
                    for (a, b), p in caches[i].items():
                        if a <= rem_a and b <= rem_b and p.fps > best_fps:
                            best_cfg, best_fps = (a, b), p.fps
                    if best_cfg is None:
                        ok = False
                        break
                    chosen[i] = best_cfg
                    rem_a -= best_cfg[0]
                    rem_b -= best_cfg[1]
            if ok:
                note_incumbent(tuple(
                    caches[i][cfg].fps for i, cfg in enumerate(chosen)))

    def rec(i: int, rem_a: int, rem_b: int, chosen: list[tuple[int, int]],
            got: list[float]) -> None:
        if bounded_out(i, rem_a, rem_b, got):
            return
        if i == n_tenants - 1:
            # Last tenant: every fitting config completes the same prefix,
            # so the completions differ only in the final rate — all but
            # the best are weakly dominated by it and one note_incumbent
            # call covers the whole group (no pruning check can run
            # between siblings, so the incumbent set evolves identically).
            pre = [caches[j][c] for j, c in enumerate(chosen)]
            pre_fps = tuple(got)
            pre_lat = tuple(m.latency for m in pre)
            pre_tops = sum(m.tops for m in pre)
            prefix = tuple(chosen)
            best = -math.inf
            for a, b in cfg_lists[i]:
                if a <= rem_a and b <= rem_b:
                    m = caches[i][(a, b)]
                    points.append(
                        MultiTenantPoint(
                            configs=prefix + ((a, b),),
                            fps=pre_fps + (m.fps,),
                            latency=pre_lat + (m.latency,),
                            tops=pre_tops + m.tops,
                        )
                    )
                    if m.fps > best:
                        best = m.fps
            if bound and best > -math.inf:
                note_incumbent(pre_fps + (best,))
            return
        for a, b in cfg_lists[i]:
            if a <= rem_a and b <= rem_b:
                chosen.append((a, b))
                got.append(caches[i][(a, b)].fps)
                rec(i + 1, rem_a - a, rem_b - b, chosen, got)
                got.pop()
                chosen.pop()

    rec(0, n_pu1x, n_pu2x, [], [])
    if not points:
        raise ValueError(
            f"no joint placement fits {len(workloads)} tenants in "
            f"{n_pu1x}x PU1x + {n_pu2x}x PU2x"
        )

    objectives = [
        (lambda p, i=i: p.fps[i]) for i in range(len(workloads))
    ]
    front = pareto_front if fast else pareto_front_bruteforce
    frontier = front(points, objectives, tolerance=tolerance)

    res = MultiDSEResult(workloads=workloads, singles=singles, points=points,
                         frontier=frontier, pus=pus,
                         n_pu1x=n_pu1x, n_pu2x=n_pu2x,
                         fingerprints=tuple(fps_order))
    if validate > 0:
        # tenants with their own round semantics (explicit Workload.rounds
        # or a decode window) validate on per-member defaults, so decode
        # rates are measured over the full advancing-length cycle.
        has_own_rounds = any(
            w.rounds is not None or w.graph.decode_steps for w in workloads)
        val_rounds = None if has_own_rounds else validate_rounds
        norm = [res.best_solo_fps(i) for i in range(res.n_tenants)]
        candidates = [res.balanced]
        ranked = sorted(
            frontier,
            key=lambda p: -sum(
                (f / n if n else 0.0) for f, n in zip(p.fps, norm)),
        )
        seen = {candidates[0].configs}
        for p in ranked:
            if p.configs not in seen:
                candidates.append(p)
                seen.add(p.configs)
        for cand in candidates[:validate]:
            sim = res.simulate(cand, rounds=val_rounds)
            res.validation.append(
                MultiTenantValidationRecord(
                    configs=cand.configs,
                    analytic_fps=cand.fps,
                    simulated_fps=tuple(
                        m.throughput_fps(warmup=2) for m in sim.members),
                )
            )
    return res


def explore(g, *, n_pu1x: int = 5, n_pu2x: int = 5,
            tolerance: float = 0.0, pus: Optional[list[PUSpec]] = None,
            validate: int = 0, validate_rounds: int = 5,
            engine: str = "batched") -> DSEResult:
    """Run the three DSE steps; optionally cross-check the analytic cache.

    ``g`` is a Graph or a deploy ``Workload`` — any frontend graph flows
    through unchanged, including decode-phase graphs
    (``zoo.transformer_decoder``) whose K/V-cache scheduling is entirely a
    compiler/ISA concern: a decode tenant enumerates, composes and deploys
    exactly like a prefill or CNN tenant.

    The default ``engine="batched"`` shares one memoized graph analysis
    across all Step-1 configs, scores the whole config sweep in one
    vectorized pass (``repro_torch.dse.batched``), generates **zero** instructions
    (codegen runs only when a point is deployed), prunes cost-dominated
    member configs from the Step-2 composition (margin-aware at
    ``tolerance > 0``, see ``enumerate_multi_batch``), and extracts the
    frontier with the sort-based O(n log n) Pareto. ``engine="scalar"``
    (alias ``"fast"``: the historical default) is identical except Step 1
    runs one ``place()`` per config; ``engine="reference"`` is the
    pre-caching brute-force engine. At tolerance 0 all three produce
    identical frontiers and design points, at tolerance > 0 the fast
    frontiers are the reference one restricted to kept schedules and still
    contain the entire exact frontier and every DP point (locked by the
    equivalence suite of the JAX package; the port's results equal the JAX
    package's per engine).

    ``validate=N`` deploys + simulates up to N schedules (the design points
    DP-A/C/B first, then the throughput-ordered multi-batch frontier) and
    records analytic-vs-simulated throughput in ``DSEResult.validation``;
    decode workloads validate over one full decode window (not
    ``validate_rounds``) so the cross-check covers the whole
    advancing-length cycle."""
    engine = _normalize_engine(engine)
    workload = None
    if not isinstance(g, Graph):
        from ..deploy import Workload

        workload = Workload.of(g)
        g = workload.graph
    pus = pus if pus is not None else make_u50_system()
    fast = engine != "reference"
    if fast:
        single = enumerate_single_batch(g, n_pu1x=n_pu1x, n_pu2x=n_pu2x,
                                        pus=pus, engine=engine)
    else:
        single = enumerate_single_batch_reference(g, n_pu1x=n_pu1x,
                                                  n_pu2x=n_pu2x, pus=pus)
    # margin-aware pruning stays engaged at tolerance > 0 (see
    # enumerate_multi_batch); a negative tolerance shrinks the frontier and
    # would make any prune unsound, so only that degenerate case sweeps
    # exhaustively.
    multi = enumerate_multi_batch(single, n_pu1x=n_pu1x, n_pu2x=n_pu2x,
                                  prune=fast and tolerance >= 0.0,
                                  tolerance=tolerance)
    front = pareto_front if fast else pareto_front_bruteforce
    sf = front(
        single, [lambda p: p.fps, lambda p: -p.latency], tolerance=tolerance
    )
    mf = front(
        multi, [lambda s: s.throughput, lambda s: -s.latency], tolerance=tolerance
    )
    res = DSEResult(single=single, multi=multi, single_frontier=sf,
                    multi_frontier=mf, graph=g, pus=pus, workload=workload,
                    n_pu1x=n_pu1x, n_pu2x=n_pu2x)
    if validate > 0:
        # decode workloads (or explicit Workload.rounds) validate over their
        # own full window; everything else uses the quick validate_rounds.
        has_own_rounds = (workload is not None and workload.rounds is not None
                          ) or bool(g.decode_steps)
        val_rounds = None if has_own_rounds else validate_rounds
        candidates: list = []
        for dp in ("dp_a", "dp_c", "dp_b"):
            try:
                candidates.append(getattr(res, dp))
            except LookupError:
                pass
        seen = {c.configs for c in candidates}
        for s in sorted(mf, key=lambda s: -s.throughput):
            if s.configs not in seen:
                candidates.append(s)
                seen.add(s.configs)
        for cand in candidates[:validate]:
            sim = res.simulate(cand, rounds=val_rounds)
            res.validation.append(
                ValidationRecord(
                    configs=cand.configs,
                    analytic_fps=cand.throughput,
                    simulated_fps=sim.aggregate_fps(warmup=2),
                )
            )
    return res
