"""Unified run reporting: one result schema for offline runs and serving.

The port's copy of the JAX package's ``deploy/report.py``. A
``System.run`` wraps the raw :class:`~repro_torch.core.simulator.SimResult`
in a :class:`RunReport`, the single schema every caller reads: per-tenant
throughput, token accounting, latency percentiles and SLO attainment. It
forwards unknown attributes to the ``SimResult``, so ``aggregate_fps`` and
``fps_by_workload`` keep working on it. The ``"serve"`` kind (a report
aggregated over serving windows, no backing sim) is what the JAX package's
``Server.drain`` builds; the serving layer is not copied into the port yet.

:class:`SLO` lives here rather than in the serving layer because reports
carry attainment against it and ``deploy`` must not import the serving
layer that builds on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from ..core.simulator import SimResult


@dataclass(frozen=True)
class SLO:
    """Per-tenant service-level objective for the serving control plane.

    ``min_tokens_per_s`` is a floor on the tenant's aggregate decode rate
    (measured per serving window); ``deadline_s`` bounds a request's
    completion latency; ``priority`` orders tenants under contention
    (higher wins — lower-priority tenants shed load first).
    """

    min_tokens_per_s: Optional[float] = None
    deadline_s: Optional[float] = None
    priority: int = 0


def _percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a sequence."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


@dataclass(frozen=True)
class TenantReport:
    """One tenant's share of a run: throughput, tokens, latency, SLO."""

    tenant: str
    fps: float                # steady-state member rounds/s
    token_rate: float         # fps scaled by packed slot counts
    rounds: int
    tokens: int
    # Latency samples in seconds: per-round pipeline latencies for offline
    # runs, completed-request latencies for serving runs.
    latencies_s: tuple[float, ...] = ()
    slo: Optional[SLO] = None
    # Fraction of measurement windows (serving) meeting the SLO; None when
    # no SLO applies.
    slo_attainment: Optional[float] = None

    def latency_percentile(self, q: float) -> float:
        return _percentile(self.latencies_s, q)

    @property
    def latency_p50(self) -> float:
        return self.latency_percentile(50)

    @property
    def latency_p95(self) -> float:
        return self.latency_percentile(95)

    @property
    def latency_p99(self) -> float:
        return self.latency_percentile(99)


@dataclass
class RunReport:
    """The one result schema of a run — offline or serving.

    ``tenants`` maps workload label to :class:`TenantReport`; ``wall_s`` is
    the simulated seconds covered; ``source`` is ``"run"`` for a single
    ``System.run`` and ``"serve"`` for an aggregated ``Server.drain``.
    When a single :class:`~repro_torch.core.simulator.SimResult` backs the report
    it is kept in ``sim`` and every unknown attribute forwards to it, so
    all historical ``SimResult`` call sites (``members``,
    ``round_end_cycles``, ``deadlocked``, ...) work on a report unchanged.
    """

    tenants: dict[str, TenantReport] = field(default_factory=dict)
    wall_s: float = 0.0
    source: str = "run"
    sim: Optional[SimResult] = None

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_sim(sim: SimResult, warmup: int = 1) -> "RunReport":
        """Wrap one simulation result, splitting accounting per tenant."""
        by_label: dict[str, list] = {}
        for m in sim.members:
            by_label.setdefault(m.workload, []).append(m)
        tenants = {}
        for label, ms in by_label.items():
            lats = tuple(c / sim.sys_clk_hz for m in ms
                         for c in m.round_latencies_cycles)
            tenants[label] = TenantReport(
                tenant=label,
                fps=sum(m.throughput_fps(warmup) for m in ms),
                token_rate=sum(m.token_rate(warmup) for m in ms),
                rounds=sum(m.rounds for m in ms),
                tokens=sum(m.tokens for m in ms),
                latencies_s=lats,
            )
        return RunReport(tenants=tenants, wall_s=sim.end_seconds,
                         source="run", sim=sim)

    # -- unified aggregate accessors ----------------------------------------
    def aggregate_fps(self, warmup: int = 1) -> float:
        """System throughput: sum of per-member steady-state rates."""
        if self.sim is not None:
            return self.sim.aggregate_fps(warmup)
        return sum(t.fps for t in self.tenants.values())

    def fps_by_workload(self, warmup: int = 1) -> dict[str, float]:
        """Per-tenant throughput split (the multi-tenant metric)."""
        if self.sim is not None:
            return self.sim.fps_by_workload(warmup)
        return {name: t.fps for name, t in self.tenants.items()}

    def aggregate_token_rate(self, warmup: int = 1) -> float:
        """System tokens/s (slot-aware; equals fps when nothing packed)."""
        if self.sim is not None:
            return self.sim.aggregate_token_rate(warmup)
        return sum(t.token_rate for t in self.tenants.values())

    @property
    def total_tokens(self) -> int:
        return sum(t.tokens for t in self.tenants.values())

    def latency_percentile(self, q: float) -> float:
        """Percentile over every tenant's merged latency samples."""
        merged = [x for t in self.tenants.values() for x in t.latencies_s]
        return _percentile(merged, q)

    @property
    def latency_p50(self) -> float:
        return self.latency_percentile(50)

    @property
    def latency_p95(self) -> float:
        return self.latency_percentile(95)

    @property
    def latency_p99(self) -> float:
        return self.latency_percentile(99)

    def slo_attainment(self) -> dict[str, float]:
        """Per-tenant SLO attainment (tenants with an SLO only)."""
        return {name: t.slo_attainment for name, t in self.tenants.items()
                if t.slo_attainment is not None}

    # -- SimResult forwarding (historical call sites) ------------------------
    def __getattr__(self, name: str):
        if name.startswith("_") or self.__dict__.get("sim") is None:
            raise AttributeError(
                f"{type(self).__name__!s} has no attribute {name!r}")
        return getattr(self.__dict__["sim"], name)

    def __str__(self) -> str:
        parts = [f"RunReport[{self.source}] wall={self.wall_s:.4g}s"]
        for name, t in sorted(self.tenants.items()):
            slo = (f" slo={t.slo_attainment:.0%}"
                   if t.slo_attainment is not None else "")
            parts.append(f"  {name or '<default>'}: {t.token_rate:.1f} tok/s "
                         f"({t.tokens} tokens, p95 {t.latency_p95 * 1e3:.2f} ms"
                         f"{slo})")
        return "\n".join(parts)
