"""Online re-placement policy: the serving loop's interface to the DSE.

The JAX package's serving control plane (``repro/serve``) re-places tenants whenever
membership changes (join/leave) or an SLO violation persists. This module
is the thin policy layer between that loop and the explorer: it picks the
joint placement — the max-min-fair ``balanced`` point of
:func:`repro_torch.dse.explore_multi` for two or more tenants, the best
single-batch pipeline (DP-A) for one — and threads the previous
:class:`~repro_torch.dse.MultiDSEResult` back in as ``prev`` so consecutive
replans are incremental: tenants whose placement graphs are unchanged
(matched by fingerprint) reuse their Step-1 caches, and the result is
*exactly* the from-scratch exploration (the incremental path is equality-
preserving, not approximate — the serving tests assert byte-equality).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .explorer import explore, explore_multi


@dataclass
class Placement:
    """One joint placement decision over the active tenant set.

    ``configs`` gives each workload (in ``workloads`` order) its member
    pipeline shape ``(a, b)``; ``point`` is the underlying DSE point
    (:class:`~repro_torch.dse.MultiTenantPoint` or
    :class:`~repro_torch.dse.SingleBatchPoint`); ``result`` is the full
    :class:`~repro_torch.dse.MultiDSEResult` when two or more tenants were
    co-explored — pass it back as ``prev`` on the next replan.
    """

    workloads: tuple[Any, ...]
    configs: tuple[tuple[int, int], ...]
    point: Any
    result: Any = None

    def config_for(self, label: str) -> tuple[int, int]:
        for w, cfg in zip(self.workloads, self.configs):
            if w.label == label:
                return cfg
        raise KeyError(f"no placement for tenant {label!r}")


def plan_placement(workloads, *, pus=None, n_pu1x: int = 5, n_pu2x: int = 5,
                   prev: Optional[Any] = None, engine: str = "batched",
                   available: Optional[Any] = None) -> Placement:
    """Place the active tenant set on the fixed machine.

    ``workloads`` is a non-empty list of deploy ``Workload``s (or graphs).
    ``prev`` is the ``result`` of the previous multi-tenant placement (or
    ``None``); it only accelerates — the returned placement equals the
    from-scratch one.

    ``available`` is the degraded-array mask: an iterable of still-healthy
    pids. The per-kind PU budget is capped to the healthy counts, which is
    all the explorer needs (members bind to concrete healthy pids at
    deploy time, via ``compile_deployment(available=...)``). A mask that
    changes the budget inherently differs from ``prev``'s budget, so the
    explorer's ``prev=`` reuse check rejects it and the placement takes
    the safe from-scratch path — degraded placements are byte-equal to a
    fresh ``explore_multi`` on the masked budget by construction.
    """
    from ..core.pu import make_u50_system
    from ..deploy import Workload

    ws = tuple(Workload.of(w) for w in workloads)
    if not ws:
        raise ValueError("plan_placement needs at least one tenant workload")
    if available is not None:
        avail = set(available)
        machine = pus if pus is not None else make_u50_system()
        n_pu1x = min(n_pu1x, sum(1 for p in machine
                                 if p.kind == "PU1x" and p.pid in avail))
        n_pu2x = min(n_pu2x, sum(1 for p in machine
                                 if p.kind == "PU2x" and p.pid in avail))
        if n_pu1x + n_pu2x == 0:
            raise ValueError("no available PUs to place tenants on")
    if len(ws) == 1:
        res = explore(ws[0], n_pu1x=n_pu1x, n_pu2x=n_pu2x, pus=pus,
                      engine=engine)
        pt = res.dp_a  # best single-batch pipeline over the whole machine
        return Placement(workloads=ws, configs=(pt.config,), point=pt)
    res = explore_multi(list(ws), n_pu1x=n_pu1x, n_pu2x=n_pu2x, pus=pus,
                        prev=prev, engine=engine)
    pt = res.balanced  # max-min-fair over the joint frontier
    return Placement(workloads=res.workloads, configs=pt.configs, point=pt,
                     result=res)
