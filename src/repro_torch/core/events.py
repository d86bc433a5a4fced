"""Minimal discrete-event simulation kernel (simpy-like, dependency-free).

Used by the cycle-approximate multi-PU simulator (``simulator.py``) to
model ICU instruction streams, ISU token routing and buffer handshakes.

Processes are Python generators that ``yield`` effect objects:

  Delay(dt)          -- advance this process by ``dt`` time units
  WaitCond(key)      -- block until ``Kernel.notify(key)`` fires AND the
                        registered predicate (optional) evaluates true
  Acquire(sem)       -- P() on a counting semaphore
  Release(sem)       -- V() on a counting semaphore (non-blocking)

Time is float (we use cycles of ``sys_clk``). Deterministic: ties broken by
(priority, sequence number).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Generator, NamedTuple, Optional


class Effect:
    pass


@dataclass
class Delay(Effect):
    dt: float


@dataclass
class WaitCond(Effect):
    """Block until ``notify(key)`` is called and ``pred()`` is true.

    The predicate is re-checked on every notify; it must be side-effect free.
    If ``pred()`` is already true at yield time the process continues
    immediately (same timestamp). ``desc`` is an optional human-readable
    description of what is being awaited (surfaced by
    :class:`DeadlockError`)."""

    key: Any
    pred: Optional[Callable[[], bool]] = None
    desc: Optional[str] = None


@dataclass
class Acquire(Effect):
    sem: "Semaphore"
    n: int = 1


@dataclass
class Release(Effect):
    sem: "Semaphore"
    n: int = 1


class BlockedProc(NamedTuple):
    """One process stuck in the event loop: its name, a description of the
    effect it awaits, the simulated cycle at which it parked, and the label
    of the deployment member that owns it ("" for unowned processes).

    Unpacks as the historical ``(name, desc)`` pair plus the two new
    fields, so ``for name, desc, *_ in blocked`` keeps working."""

    name: str
    desc: str
    cycle: float
    member: str


class DeadlockError(RuntimeError):
    """Raised when the event loop exceeds ``max_events``: a deadlock or
    livelock. ``blocked`` lists a :class:`BlockedProc` for every process
    still pending — for an ICU decoder blocked in a WAIT_* the description
    names the instruction and its ``(pid, bid)`` channel, ``cycle`` the
    simulated time it parked, and ``member`` the owning pipeline member."""

    def __init__(self, message: str, blocked: list[BlockedProc]) -> None:
        super().__init__(message)
        self.blocked = blocked


class Semaphore:
    """Counting semaphore with FIFO wakeup."""

    def __init__(self, kernel: "Kernel", value: int, name: str = "") -> None:
        self.kernel = kernel
        self.value = value
        self.name = name
        self.waiters: list["_Proc"] = []

    def try_acquire(self, n: int) -> bool:
        if self.value >= n:
            self.value -= n
            return True
        return False

    def release(self, n: int = 1) -> None:
        self.value += n
        # Wake all waiters; they re-attempt acquisition in FIFO order.
        waiters, self.waiters = self.waiters, []
        for proc in waiters:
            self.kernel._schedule(self.kernel.now, proc)


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    proc: "_Proc" = field(compare=False)


class _Proc:
    __slots__ = ("gen", "name", "pending", "done", "result", "member",
                 "daemon", "blocked_since")

    def __init__(self, gen: Generator, name: str, member: str = "",
                 daemon: bool = False) -> None:
        self.gen = gen
        self.name = name
        self.pending: Optional[Effect] = None  # effect we are blocked on
        self.done = False
        self.result = None
        self.member = member  # owning deployment member label ("" = unowned)
        # Daemon processes (watchdog monitors, injected fault generators)
        # never count as pending work: the loop stops when only daemon
        # events remain and no non-daemon process is parked, and they are
        # excluded from deadlock reporting.
        self.daemon = daemon
        self.blocked_since: Optional[float] = None  # cycle we parked at

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Proc {self.name} done={self.done}>"


class Kernel:
    """Discrete event loop."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self._cond_waiters: dict[Any, list[_Proc]] = {}
        self._procs: list[_Proc] = []
        self._nondaemon_events = 0  # scheduled events of non-daemon procs
        self._halted = False
        self.trace: list[tuple[float, str, Any]] = []
        self.trace_enabled = False

    # -- public API ---------------------------------------------------------
    def semaphore(self, value: int, name: str = "") -> Semaphore:
        return Semaphore(self, value, name)

    def spawn(self, gen: Generator, name: str = "proc", *, member: str = "",
              daemon: bool = False) -> _Proc:
        proc = _Proc(gen, name, member=member, daemon=daemon)
        self._procs.append(proc)
        self._schedule(self.now, proc)
        return proc

    def halt(self) -> None:
        """Stop the event loop after the current step (a watchdog that has
        diagnosed a fault calls this instead of letting the simulation spin
        until ``max_events``)."""
        self._halted = True

    def notify(self, key: Any) -> None:
        """Wake processes blocked on WaitCond(key)."""
        waiters = self._cond_waiters.pop(key, None)
        if waiters:
            for proc in waiters:
                self._schedule(self.now, proc)

    def log(self, who: str, what: Any) -> None:
        if self.trace_enabled:
            self.trace.append((self.now, who, what))

    def run(self, until: float = float("inf"), max_events: int = 50_000_000) -> float:
        events = 0
        self._halted = False
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.time > until:
                heapq.heappush(self._heap, ev)
                break
            if ev.proc.daemon and self._nondaemon_events == 0 and not any(
                    not p.done and not p.daemon for p in self._procs):
                # Only daemon events remain and every non-daemon process has
                # finished: the simulation is complete, don't let a periodic
                # monitor keep the clock running forever.
                heapq.heappush(self._heap, ev)
                break
            if not ev.proc.daemon:
                self._nondaemon_events -= 1
            events += 1
            if events > max_events:
                blocked = self.blocked_procs()
                detail = "; ".join(f"{b.name}: {b.desc}" for b in blocked)
                raise DeadlockError(
                    f"simulation exceeded max_events={max_events} "
                    f"(deadlock/livelock?). {len(blocked)} blocked process(es)"
                    + (f": {detail}" if detail else ""),
                    blocked,
                )
            self.now = ev.time
            self._step(ev.proc)
            if self._halted:
                break
        return self.now

    def deadlocked(self) -> list[_Proc]:
        """Non-daemon processes still blocked after run() drained the heap."""
        return [p for p in self._procs if not p.done and not p.daemon]

    def blocked_procs(self) -> list[BlockedProc]:
        """A :class:`BlockedProc` for every non-done, non-daemon process,
        using the pending effect's own description where available."""
        out: list[BlockedProc] = []
        for p in self._procs:
            if p.done or p.daemon:
                continue
            eff = p.pending
            if isinstance(eff, WaitCond):
                desc = eff.desc or f"WaitCond({eff.key!r})"
            elif isinstance(eff, Acquire):
                desc = f"Acquire({eff.sem.name or 'semaphore'})"
            else:
                desc = "runnable (livelock suspect)"
            cycle = p.blocked_since if p.blocked_since is not None else self.now
            out.append(BlockedProc(p.name, desc, cycle, p.member))
        return out

    # -- internals ----------------------------------------------------------
    def _schedule(self, time: float, proc: _Proc) -> None:
        if not proc.daemon:
            self._nondaemon_events += 1
        heapq.heappush(self._heap, _Event(time, next(self._seq), proc))

    def _step(self, proc: _Proc) -> None:
        if proc.done:
            return
        # If blocked on a condition/semaphore, re-check before resuming.
        eff = proc.pending
        if isinstance(eff, WaitCond):
            if eff.pred is not None and not eff.pred():
                self._cond_waiters.setdefault(eff.key, []).append(proc)
                return
        elif isinstance(eff, Acquire):
            if not eff.sem.try_acquire(eff.n):
                eff.sem.waiters.append(proc)
                return
        proc.pending = None
        proc.blocked_since = None
        try:
            nxt = proc.gen.send(None)
        except StopIteration as stop:
            proc.done = True
            proc.result = stop.value
            return
        self._dispatch(proc, nxt)

    def _dispatch(self, proc: _Proc, eff: Effect) -> None:
        if isinstance(eff, Delay):
            self._schedule(self.now + eff.dt, proc)
        elif isinstance(eff, WaitCond):
            if eff.pred is None or not eff.pred():
                proc.pending = eff
                proc.blocked_since = self.now
                if eff.pred is not None and eff.pred():
                    # racy predicate became true: run now
                    self._schedule(self.now, proc)
                else:
                    self._cond_waiters.setdefault(eff.key, []).append(proc)
            else:
                self._schedule(self.now, proc)
        elif isinstance(eff, Acquire):
            if eff.sem.try_acquire(eff.n):
                self._schedule(self.now, proc)
            else:
                proc.pending = eff
                proc.blocked_since = self.now
                eff.sem.waiters.append(proc)
        elif isinstance(eff, Release):
            eff.sem.release(eff.n)
            self._schedule(self.now, proc)
        else:
            raise TypeError(f"unknown effect {eff!r}")
