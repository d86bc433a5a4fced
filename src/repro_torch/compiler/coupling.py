"""Pipeline coupling model: credit-loop bounds on the steady-state rate.

The analytic model of ``place()`` historically treated the pipeline round
time as ``max(stage_times)`` — stages as independent servers. The compiled
programs are tighter than that: every cross-stage tensor is forwarded
through a WAIT_ACK/SEND_REQ (producer ST) <-> WAIT_REQ/SEND_ACK (consumer
LD) handshake over a finite ring of ping-pong buffer regions
(``TensorPlan.n_regions``), so a fast producer can run at most ``beta``
rounds ahead of the consumer that returns its credits.

In timed-event-graph terms the steady pipeline is a marked graph. Its
period is bounded below by every cycle's delay divided by the tokens on
it. Two cycle families matter:

* each instruction group's serial round work — the classic per-stage
  bound, already captured by ``stage_times``;
* each cross-stage credit loop. The ACK-bypass prologue places
  ``beta(T)`` credit tokens on tensor T's loop, and one traversal costs

      t_write(T) + L_req + t_read(T) + L_ack + 4 * DECODE_CYCLES

  — the producer's store ADM, the REQ token's ISU flight to the consumer,
  the consumer's load ADM (zero for side/second-operand inputs, whose LD
  handshake ACKs immediately while the CP streams the data), the ACK
  token's flight back, and one decode slot for each of the four handshake
  instructions. Token flight times come from
  :func:`repro_torch.core.isu.token_latency_cycles` and the decode cost from
  :data:`repro_torch.core.icu.DECODE_CYCLES` — calibration constants of the
  simulated hardware, not fit parameters.

The coupled round time is the max over both families — closed form, no
simulation, O(edges) per config — so ``place()`` stays cheap and the
fast-DSE ``analyze``/``place`` split and STATS call-count gates are
untouched (buffer depths come from :func:`buffer_requirements` directly,
which never runs the liveness/channel planning counted by
``STATS.memory_plan_calls``).

Token latencies are evaluated on the *canonical* PU assignment (pipeline
order onto the default PU pool, ignoring any multi-batch ``pid_offset``):
ISU latency depends only on hop distance and SLR crossing, which are
identical for every contiguous same-kind placement, and the canonical form
keeps DSE-cache predictions and offset-placed deployment predictions
byte-identical.

Graph input/output tensors are host-coordinated (``n_io`` A/C regions over
PCIe) and are not part of the PU-to-PU credit system; they carry no bound
here.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.icu import DECODE_CYCLES
from ..core.isu import token_latency_cycles
from ..core.pu import PUSpec
from .graph import Graph
from .memory import TensorPlan
from .partition import Partition

# WAIT_ACK + SEND_REQ (producer ST) + WAIT_REQ + SEND_ACK (consumer LD)
_HANDSHAKE_DECODES = 4


@dataclass(frozen=True)
class BoundaryBound:
    """One cross-stage tensor's credit-loop period bound."""

    tid: int
    producer_stage: int
    consumer_stage: int
    depth: int  # credit tokens on the loop (ping-pong regions / kv credits)
    cycle_seconds: float  # one traversal of the credit loop
    req_latency_seconds: float  # one-way store->load forwarding latency

    @property
    def bound_seconds(self) -> float:
        """Minimum steady-state round period this loop allows."""
        return self.cycle_seconds / self.depth


@dataclass(frozen=True)
class CouplingModel:
    """Coupled steady-state rate of one placed pipeline."""

    uncoupled_seconds: float  # max(stage_times) — the independent-server view
    bounds: tuple[BoundaryBound, ...]

    @property
    def round_seconds(self) -> float:
        return max(
            self.uncoupled_seconds,
            max((b.bound_seconds for b in self.bounds), default=0.0),
        )

    @property
    def binding(self) -> "BoundaryBound | None":
        """The boundary whose credit loop limits the rate, if any does."""
        worst = max(self.bounds, key=lambda b: b.bound_seconds, default=None)
        if worst is not None and worst.bound_seconds > self.uncoupled_seconds:
            return worst
        return None

    @property
    def forward_latency_seconds(self) -> float:
        """Per-item latency added by handshake forwarding: each distinct
        producer->consumer stage hop pays its one-way REQ flight once.
        Hops are summed in canonical (producer, consumer) order so every
        engine — scalar, reference, and the vectorized scorer of
        ``repro_torch.dse.batched`` — accumulates the identical float sequence."""
        hops: dict[tuple[int, int], float] = {}
        for b in self.bounds:
            key = (b.producer_stage, b.consumer_stage)
            cur = hops.get(key)
            if cur is None or b.req_latency_seconds < cur:
                hops[key] = b.req_latency_seconds
        return sum(hops[k] for k in sorted(hops))


def _credit_depth(plan: TensorPlan) -> int:
    """Tokens the ACK-bypass prologue puts on this tensor's loop. For
    ordinary tensors that is the physical ping-pong region count; a K/V
    cache is a single append-only region but keeps the stage-distance
    credit depth (writes append rows disjoint from the prefix reads)."""
    return plan.beta if plan.kind == "kv" else plan.n_regions


def coupling_bounds(
    g: Graph,
    part: Partition,
    plans: dict[int, TensorPlan],
    pid_map: dict[int, int],
    pu_specs: dict[int, PUSpec],
) -> tuple[BoundaryBound, ...]:
    """Credit-loop bounds for every cross-stage tensor edge.

    ``pid_map`` must be the canonical stage->pid assignment (see module
    docstring); ``plans`` the :func:`buffer_requirements` output for the
    same partition.
    """
    stage_of = part.stage_of_node()
    bounds: list[BoundaryBound] = []
    for tid, plan in plans.items():
        if plan.kind in ("input", "output") or plan.producer_stage is None:
            continue
        pstage = plan.producer_stage
        ppid = pid_map.get(pstage)
        if ppid is None:
            continue
        pspec = pu_specs[ppid]
        tinfo = g.tensors[tid]
        t_write = pspec.adm_seconds(tinfo.write_bytes)
        # the slowest consumer stage's ACK paces the producer
        for c in g.consumers_of(tid):
            cstage = stage_of.get(c.nid)
            if cstage is None or cstage == pstage:
                continue  # intra-stage edges stream write->read (no loop)
            cpid = pid_map.get(cstage)
            if cpid is None:
                continue
            cspec = pu_specs[cpid]
            # primary inputs are read by the consumer LD before it ACKs;
            # side/second operands ACK immediately (CP streams the data).
            t_read = (
                cspec.adm_seconds(tinfo.nbytes_padded)
                if c.inputs and c.inputs[0] == tid
                else 0.0
            )
            l_req = token_latency_cycles(pspec, cspec) / pspec.sys_clk_hz
            l_ack = token_latency_cycles(cspec, pspec) / cspec.sys_clk_hz
            t_dec = _HANDSHAKE_DECODES * DECODE_CYCLES / pspec.sys_clk_hz
            bounds.append(
                BoundaryBound(
                    tid=tid,
                    producer_stage=pstage,
                    consumer_stage=cstage,
                    depth=max(1, _credit_depth(plan)),
                    cycle_seconds=t_write + l_req + t_read + l_ack + t_dec,
                    req_latency_seconds=l_req + 2 * DECODE_CYCLES / pspec.sys_clk_hz,
                )
            )
    return tuple(bounds)


def couple(
    g: Graph,
    part: Partition,
    plans: dict[int, TensorPlan],
    stage_times: dict[int, float],
    pid_map: dict[int, int],
    pu_specs: dict[int, PUSpec],
) -> CouplingModel:
    """Build the coupling model for one placed configuration."""
    return CouplingModel(
        uncoupled_seconds=max(stage_times.values()) if stage_times else 0.0,
        bounds=coupling_bounds(g, part, plans, pid_map, pu_specs),
    )
