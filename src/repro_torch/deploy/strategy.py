"""Deployment strategies (paper Sec. V): a uniform value type for *what to
run on the PU array*, independent of how it was found.

A :class:`Strategy` is a tuple of :class:`Member` pipeline configurations.
Each member is ``(workload, a, b)`` — ``a`` PU1x + ``b`` PU2x units
pipelining one batch of one :class:`Workload` (a DNN graph plus its
round/batch semantics). One member is classic pipeline parallelism (DP-A);
several members on disjoint PU subsets are batch-level / hybrid parallelism
(DP-B, DP-C); members carrying *different* workloads are multi-tenant
deployments (FPGA-virtualization style: different models serving different
tenants on one fixed machine).

The workload axis is optional everywhere: DSE points (``SingleBatchPoint`` /
``MultiBatchSchedule``), raw ``(a, b)`` tuples and tuples thereof all
normalize through :meth:`Strategy.of` exactly as before — a workload-less
member compares equal to its legacy ``(a, b)`` tuple, and
:func:`repro_torch.deploy.compile_deployment` broadcasts its single graph over all
workload-less members. ``(workload, a, b)`` triples (or ``(graph, a, b)``)
opt individual members into their own model.
"""
from __future__ import annotations

import numbers
from dataclasses import dataclass, field
from typing import Any, Optional

from .._deprecation import warn_deprecated
from ..compiler.graph import Graph

# Normalization layers the deprecation warning walks past, so the warning
# is attributed to whoever actually wrote the legacy tuple form.
# (deployment.py comes with the rest of deploy/ in a later slice)
_STRATEGY_SHIMS = (__name__, f"{__package__}.deployment")


def _warn_tuple_strategy() -> None:
    warn_deprecated(
        "tuple-only Strategy member forms are deprecated: build strategies "
        "with Strategy.single(a, b), Strategy.multi([Member(a, b), ...]) or "
        "Strategy.tenants([(workload, a, b), ...])",
        skip=_STRATEGY_SHIMS)


@dataclass(frozen=True)
class Workload:
    """One tenant's work: a DNN graph plus its round semantics and a label.

    ``rounds`` optionally overrides the deployment-wide per-round loop count
    for members running this workload (e.g. a latency-critical tenant running
    fewer rounds per measurement window than a batch tenant); it always wins
    over the ``rounds`` given to ``compile_deployment``. When neither is
    set, a decode-phase graph (``graph.decode_steps``) defaults to one full
    decode window — see :func:`repro_torch.deploy.compile_deployment`. ``label``
    keys per-member accounting in
    :class:`repro_torch.core.simulator.MemberSimResult`; it defaults to the graph
    name.

    ``slots`` names the decode sessions packed into this workload's member
    (slot-packed decode graphs, ``transformer_decoder(slots=...)``): one
    name per concurrent session, in slot order. It flows into
    :class:`repro_torch.core.simulator.PipelineMember` so round accounting scales
    to per-session token accounting. Empty for unpacked workloads.
    """

    graph: Graph
    label: str = ""
    rounds: Optional[int] = None
    slots: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.graph, Graph):
            raise TypeError(f"Workload.graph must be a Graph, got {self.graph!r}")
        if not self.label:
            object.__setattr__(self, "label", self.graph.name)
        if self.rounds is not None and self.rounds <= 0:
            raise ValueError(f"Workload.rounds must be positive, got {self.rounds}")
        slots = tuple(str(s) for s in self.slots)
        if not slots:
            # slot-packed graphs carry their packing in attrs; default the
            # slot ids so token accounting works without a serving layer
            packed = self.graph.attrs.get("slot_prefix_rows") or ()
            slots = tuple(f"slot{i}" for i in range(len(packed)))
        object.__setattr__(self, "slots", slots)

    @staticmethod
    def of(obj: "Workload | Graph | None", label: str = "") -> "Optional[Workload]":
        if obj is None or isinstance(obj, Workload):
            return obj
        if isinstance(obj, Graph):
            return Workload(graph=obj, label=label)
        raise TypeError(f"cannot interpret {obj!r} as a Workload")

    # Graphs are mutable node DAGs compared by identity; a workload is the
    # *specific* graph object the deployment will compile.
    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Workload):
            return NotImplemented
        return (self.graph is other.graph and self.label == other.label
                and self.rounds == other.rounds and self.slots == other.slots)

    def __hash__(self) -> int:
        return hash((id(self.graph), self.label, self.rounds, self.slots))

    def __str__(self) -> str:
        return self.label

    def __repr__(self) -> str:
        extra = f", rounds={self.rounds}" if self.rounds is not None else ""
        if self.slots:
            extra += f", slots={self.slots!r}"
        return f"Workload({self.label!r}{extra})"


@dataclass(frozen=True)
class Member:
    """One member pipeline: ``a`` PU1x + ``b`` PU2x running ``workload``.

    ``workload`` is ``None`` for legacy single-model strategies (the graph is
    supplied to ``compile_deployment`` and broadcast); such members compare
    equal to — and hash like — their historical ``(a, b)`` tuple form, so old
    tuple-shaped strategies round-trip unchanged.
    """

    a: int
    b: int
    workload: Optional[Workload] = None

    def __post_init__(self) -> None:
        if self.a < 0 or self.b < 0:
            raise ValueError(f"malformed member config ({self.a}, {self.b})")
        if self.a + self.b == 0:
            raise ValueError("member config (0, 0) uses no PU")

    @property
    def config(self) -> tuple[int, int]:
        return (self.a, self.b)

    @property
    def n_pus(self) -> int:
        return self.a + self.b

    def with_workload(self, workload: "Workload | Graph | None") -> "Member":
        """This member bound to ``workload`` (kept as-is if already bound)."""
        if self.workload is not None or workload is None:
            return self
        return Member(a=self.a, b=self.b, workload=Workload.of(workload))

    # -- legacy (a, b) tuple interchangeability ------------------------------
    def __iter__(self):
        """Unpack as the legacy pair: ``a, b = member``."""
        yield self.a
        yield self.b

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Member):
            return (self.a, self.b, self.workload) == (other.a, other.b, other.workload)
        if isinstance(other, tuple):
            return (self.workload is None and len(other) == 2
                    and tuple(other) == (self.a, self.b))
        return NotImplemented

    def __hash__(self) -> int:
        if self.workload is None:
            return hash((self.a, self.b))
        return hash((self.a, self.b, self.workload))

    def __str__(self) -> str:
        if self.workload is None:
            return f"({self.a},{self.b})"
        return f"({self.workload}:{self.a},{self.b})"


def _as_member(m: Any) -> Member:
    """Normalize ``(a, b)`` / ``(workload|graph, a, b)`` / Member."""
    if isinstance(m, Member):
        return m
    t = tuple(m)
    if len(t) == 3 and isinstance(t[0], (Workload, Graph)):
        w, a, b = t
        t = (a, b)
        workload = Workload.of(w)
    elif len(t) == 2:
        workload = None
    else:
        raise ValueError(f"malformed member config {m!r}")
    try:
        a, b = int(t[0]), int(t[1])
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed member config {m!r}") from e
    # integral floats / numpy ints normalize to plain ints
    if a != t[0] or b != t[1]:
        raise ValueError(f"malformed member config {m!r}")
    return Member(a=a, b=b, workload=workload)


@dataclass(frozen=True)
class Strategy:
    """A deployment strategy: one member pipeline per concurrent batch."""

    members: tuple[Member, ...]
    name: str = field(default="", compare=False)

    def __post_init__(self) -> None:
        if not self.members:
            raise ValueError("strategy needs at least one member pipeline")
        object.__setattr__(
            self, "members", tuple(_as_member(m) for m in self.members))

    # -- constructors --------------------------------------------------------
    @staticmethod
    def single(a: int, b: int, name: str = "",
               workload: "Workload | Graph | None" = None) -> "Strategy":
        """A single-batch pipeline across ``a`` PU1x + ``b`` PU2x."""
        member = _as_member((a, b)).with_workload(workload)
        s = Strategy(members=(member,), name=name)
        if not name:
            s = Strategy(members=s.members,
                         name=f"pipeline({s.members[0].a},{s.members[0].b})")
        return s

    @staticmethod
    def multi(configs, name: str = "") -> "Strategy":
        """A multi-batch schedule: one member pipeline per concurrent batch.

        Each config is ``(a, b)``, ``(workload, a, b)``, ``(graph, a, b)``
        or a :class:`Member`."""
        try:
            members = tuple(_as_member(c) for c in configs)
        except TypeError as e:
            raise ValueError(f"malformed member configs {configs!r}") from e
        s = Strategy(members=members, name=name)
        if not name:
            s = Strategy(members=s.members,
                         name="+".join(str(m) for m in s.members))
        return s

    @staticmethod
    def tenants(assignments, name: str = "") -> "Strategy":
        """Multi-tenant constructor: ``[(workload_or_graph, a, b), ...]``."""
        s = Strategy.multi(assignments, name=name)
        for m in s.members:
            if m.workload is None:
                raise ValueError(
                    f"Strategy.tenants requires a workload per member; {m} has none")
        return s

    @staticmethod
    def of(obj: Any, name: str = "") -> "Strategy":
        """Normalize any schedule-like object into a Strategy.

        Accepts a Strategy, a DSE ``MultiBatchSchedule`` (has ``.configs``),
        a DSE ``SingleBatchPoint`` (has ``.config``), an ``(a, b)`` pair, a
        ``(workload, a, b)`` triple, or an iterable of pairs / triples /
        Members."""
        if isinstance(obj, Strategy):
            return obj
        # a lone Member keeps its workload (it also has a .config view, so
        # it must not fall into the DSE-point branches below)
        if isinstance(obj, Member):
            return Strategy.multi([obj], name=name)
        # single points first: SingleBatchPoint also exposes a uniform
        # .configs view, but keeps its pipeline(a,b) naming through .config
        cfg = getattr(obj, "config", None)
        if cfg is not None:
            return Strategy.single(*cfg, name=name)
        cfgs = getattr(obj, "configs", None)
        if cfgs is not None:
            return Strategy.multi(cfgs, name=name)
        seq = tuple(obj)
        if len(seq) == 2 and all(isinstance(x, numbers.Number) for x in seq):
            _warn_tuple_strategy()
            return Strategy.single(*seq, name=name)
        if len(seq) == 3 and isinstance(seq[0], (Workload, Graph)):
            return Strategy.multi([seq], name=name)
        if any(isinstance(m, (tuple, list)) and len(m) == 2 for m in seq):
            _warn_tuple_strategy()
        return Strategy.multi(seq, name=name)

    def with_workload(self, workload: "Workload | Graph | None") -> "Strategy":
        """Broadcast ``workload`` onto every workload-less member (the
        backward-compatible single-model path of ``compile_deployment``)."""
        if workload is None:
            return self
        w = Workload.of(workload)
        return Strategy(members=tuple(m.with_workload(w) for m in self.members),
                        name=self.name)

    # -- properties ----------------------------------------------------------
    @property
    def batch(self) -> int:
        """Concurrent batches = number of member pipelines."""
        return len(self.members)

    @property
    def is_single(self) -> bool:
        return len(self.members) == 1

    @property
    def configs(self) -> tuple[tuple[int, int], ...]:
        """The legacy workload-less view: one (a, b) per member."""
        return tuple(m.config for m in self.members)

    @property
    def workloads(self) -> tuple[Workload, ...]:
        """Distinct workloads, in first-appearance member order."""
        seen: list[Workload] = []
        for m in self.members:
            if m.workload is not None and m.workload not in seen:
                seen.append(m.workload)
        return tuple(seen)

    @property
    def is_multi_tenant(self) -> bool:
        return len(self.workloads) > 1

    @property
    def total_a(self) -> int:
        return sum(m.a for m in self.members)

    @property
    def total_b(self) -> int:
        return sum(m.b for m in self.members)

    @property
    def total_pus(self) -> int:
        return self.total_a + self.total_b

    def __str__(self) -> str:
        body = "+".join(str(m) for m in self.members)
        return f"{self.name or 'strategy'}[{body}]"
