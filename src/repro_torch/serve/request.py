"""Value types of the serving control plane: requests, sessions, events.

A :class:`Request` is one tenant job: a prompt of ``prompt_tokens`` already
prefilled (the session's initial cache depth) plus ``max_new_tokens`` to
decode, one token per program round. Admission turns a request into a
:class:`DecodeSession` — a slot in the tenant's slot-packed decode member
whose cache depth grows every round. Everything the scheduler does (admit /
retire / replan / swap / evict / join / leave) is recorded as a
:class:`ServeEvent`, which is what the deterministic scheduler tests
assert on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Request:
    """One serving job: decode ``max_new_tokens`` on top of a prefilled
    prompt of ``prompt_tokens`` for ``tenant``. ``arrival_s`` is virtual
    arrival time; the server fills the lifecycle fields."""

    tenant: str
    prompt_tokens: int
    max_new_tokens: int
    arrival_s: float = 0.0
    rid: str = ""

    # -- lifecycle (server-owned) -------------------------------------------
    admitted_s: Optional[float] = None
    finished_s: Optional[float] = None
    generated: int = 0
    evicted: bool = False

    def __post_init__(self) -> None:
        if self.prompt_tokens < 1:
            raise ValueError("prompt_tokens must be >= 1 (prefilled prefix)")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def done(self) -> bool:
        return self.finished_s is not None

    @property
    def completed(self) -> bool:
        return self.done and not self.evicted

    @property
    def latency_s(self) -> Optional[float]:
        """Arrival -> completion latency in virtual seconds."""
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s


@dataclass
class DecodeSession:
    """One admitted request occupying one packed slot: current cache depth
    (grows one row per round) and tokens still to decode."""

    request: Request
    depth: int       # current K/V cache rows (prompt + generated so far)
    remaining: int   # tokens left to decode

    @property
    def rid(self) -> str:
        return self.request.rid

    def advance(self, rounds: int) -> None:
        self.request.generated += rounds
        self.depth += rounds
        self.remaining -= rounds


@dataclass(frozen=True)
class ServeEvent:
    """One scheduler decision, timestamped in virtual seconds."""

    t: float
    kind: str     # join|leave|admit|retire|swap|replan|evict|slo-violation
                  # |inject|fault|quarantine|replay|shed (fault tolerance)
    tenant: str
    detail: str = ""

    def __str__(self) -> str:
        d = f" {self.detail}" if self.detail else ""
        return f"[{self.t:10.6f}s] {self.kind:<14s} {self.tenant}{d}"


@dataclass
class WindowSample:
    """Per-tenant measurement of one serving window (SLO accounting)."""

    t: float
    tokens: int
    dt: float
    met: Optional[bool] = None  # None when the tenant carries no rate SLO

    @property
    def rate(self) -> float:
        return self.tokens / self.dt if self.dt > 0 else 0.0


@dataclass
class TenantState:
    """Server-internal per-tenant record (spec + live scheduling state)."""

    name: str
    workload: object             # stable placement Workload (DSE identity)
    arch: object                 # ArchConfig of the tenant's model
    depth: int                   # decoder blocks
    max_slots: int
    window: int                  # decode steps per serving window (cap)
    slo: Optional[object] = None
    queue: list = field(default_factory=list)      # pending Requests (FIFO)
    active: list = field(default_factory=list)     # DecodeSessions, slot order
    tokens: int = 0
    rounds: int = 0
    samples: list = field(default_factory=list)    # WindowSamples
    violations: int = 0          # consecutive violating windows
    replans: int = 0             # SLO-triggered replans already spent

    @property
    def free_slots(self) -> int:
        return self.max_slots - len(self.active)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)
