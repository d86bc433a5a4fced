"""Disjoint resource partitioning for multi-member deployments.

Concurrent member pipelines must never contend: each member gets a disjoint
PU subset (by kind, in pid order) and a disjoint HBM channel pool (Sec. V-A —
"each batch is processed by a disjoint PU subset"; [33] motivates channel
isolation). This logic used to leak into callers of ``compile_model`` through
the ``pid_offset``/``channel_pool`` kwargs; it is now owned by the deploy
layer and callers only ever see a :class:`~repro_torch.deploy.Strategy`.

Channel policy: all available channels are split proportionally to each
member's *demand* (largest-remainder rounding, minimum 3 channels per member
when the budget allows — weights + LD + ST streams), as consecutive disjoint
ranges. Demand is the member's PU count scaled by its workload's per-round
HBM traffic (the activation bytes its memory plan will cycle through HBM),
so in a multi-tenant deployment a streaming-heavy tenant gets a wider slice.
When members run the same workload — or carry none — the traffic factors
cancel and the split reduces to the historical PU-count-proportional one; a
single-member strategy keeps the whole channel space.

Infeasible strategies fail fast in :func:`check_fits` with one aggregate
error that names every member's requested vs. available PUs and channels,
instead of erroring deep inside per-member compilation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.pu import N_HBM_CHANNELS, PUSpec
from .strategy import Member, Strategy

MIN_CHANNELS_PER_MEMBER = 1  # a member needs at least one HBM channel


@dataclass(frozen=True)
class MemberResources:
    """Placement of one member pipeline on the shared machine."""

    index: int
    config: tuple[int, int]
    pid_offset: dict[str, int]  # PUs of each kind consumed by earlier members
    channel_pool: tuple[int, ...]


def _member_traffic(member: Member) -> float:
    """Per-round HBM activation traffic estimate of a member's workload.

    Every graph tensor crosses HBM at least once per round (produced by one
    PU's ST stream, consumed by another's LD stream), so the padded tensor
    footprint is the slice-sizing signal the member's memory plan will turn
    into DataMove streams. Workload-less members return 0 (resolved to the
    mean by the caller, so a broadcast graph splits by PU count alone)."""
    if member.workload is None:
        return 0.0
    g = member.workload.graph
    return float(sum(t.nbytes_padded for t in g.tensors.values()))


def _member_weights(strategy: Strategy) -> list[float]:
    """Channel-share weight per member: PU count x relative HBM traffic."""
    traffic = [_member_traffic(m) for m in strategy.members]
    known = [t for t in traffic if t > 0]
    mean = sum(known) / len(known) if known else 1.0
    return [
        m.n_pus * ((t / mean) if t > 0 else 1.0)
        for m, t in zip(strategy.members, traffic)
    ]


def check_fits(strategy: Strategy, pus: list[PUSpec],
               n_channels: int = N_HBM_CHANNELS) -> None:
    """Validate that all member slices fit the machine.

    ``pus`` is the *available* PU list — a degraded array simply passes its
    healthy subset — and ``n_channels`` the available channel count.
    Raises a single ValueError enumerating each member's requested PUs and
    minimum channels against what the machine offers, so an overcommitted
    multi-tenant strategy reports every tenant's demand at once."""
    n1 = sum(1 for p in pus if p.kind == "PU1x")
    n2 = sum(1 for p in pus if p.kind == "PU2x")
    need_chan = MIN_CHANNELS_PER_MEMBER * strategy.batch
    problems = []
    if strategy.total_a > n1:
        problems.append(f"PU1x overcommitted: {strategy.total_a} requested, {n1} available")
    if strategy.total_b > n2:
        problems.append(f"PU2x overcommitted: {strategy.total_b} requested, {n2} available")
    if need_chan > n_channels:
        problems.append(
            f"HBM channels overcommitted: {strategy.batch} members x "
            f">={MIN_CHANNELS_PER_MEMBER} = {need_chan} requested, {n_channels} available"
        )
    if not problems:
        return
    lines = [
        f"strategy {strategy} does not fit the machine "
        f"({n1}x PU1x + {n2}x PU2x, {n_channels} HBM channels):"
    ]
    for i, m in enumerate(strategy.members):
        tenant = f" [{m.workload}]" if m.workload is not None else ""
        lines.append(
            f"  member {i}{tenant}: {m.a}x PU1x + {m.b}x PU2x, "
            f">={MIN_CHANNELS_PER_MEMBER} channel(s)"
        )
    lines.extend(f"  {p}" for p in problems)
    raise ValueError("\n".join(lines))


def _channel_shares(weights: list[float], n_channels: int) -> list[int]:
    """Integer split of ``n_channels``: every member first gets a floor of
    min(3, n_channels // len(weights)) channels (never less than 1), then
    the remainder is distributed proportionally to ``weights`` by largest
    remainder. Always sums to exactly ``n_channels``."""
    n = len(weights)
    if n_channels < n:
        raise ValueError(f"{n} member pipelines but only {n_channels} HBM channels")
    floor_share = min(3, n_channels // n)
    rem = n_channels - floor_share * n
    total_w = sum(weights)
    exact = [rem * w / total_w for w in weights]
    extra = [int(e) for e in exact]
    order = sorted(range(n), key=lambda j: exact[j] - extra[j], reverse=True)
    for k in range(rem - sum(extra)):
        extra[order[k]] += 1
    return [floor_share + extra[i] for i in range(n)]


def partition_resources(
    strategy: Strategy,
    pus: list[PUSpec],
    n_channels: int = N_HBM_CHANNELS,
    channels: "Optional[Sequence[int]]" = None,
) -> list[MemberResources]:
    """Assign each member pipeline disjoint PUs (as kind offsets into the
    given — possibly degraded — PU list) and a disjoint HBM channel range.

    ``channels`` restricts the split to an explicit list of available
    channel ids (the serving loop passes the healthy channels of a
    quarantined array); members then get consecutive disjoint slices of
    that list instead of of ``range(n_channels)``."""
    chan_list = list(channels) if channels is not None else list(range(n_channels))
    check_fits(strategy, pus, n_channels=len(chan_list))
    shares = _channel_shares(_member_weights(strategy), len(chan_list))
    out: list[MemberResources] = []
    offsets = {"PU1x": 0, "PU2x": 0}
    chan_next = 0
    for i, m in enumerate(strategy.members):
        pool = tuple(chan_list[chan_next:chan_next + shares[i]])
        chan_next += shares[i]
        out.append(
            MemberResources(
                index=i,
                config=m.config,
                pid_offset=dict(offsets),
                channel_pool=pool,
            )
        )
        offsets["PU1x"] += m.a
        offsets["PU2x"] += m.b
    return out
