"""Queue-driven serving control plane over :class:`repro_torch.deploy.System`.

The paper's runtime strategy switching (new instruction programs, no
reconfiguration) turned into an online serving loop:

* **Elastic tenancy** — tenants :meth:`Server.join`/:meth:`Server.leave`
  at runtime; whenever the *active* tenant set changes, the server re-places
  everyone through :func:`repro_torch.dse.plan_placement` (incremental
  ``explore_multi(prev=...)`` for two or more tenants) and hot-swaps the
  running system to the new joint placement mid-service.
* **Continuous batching** — each tenant's admitted requests become decode
  sessions packed into *one* shared member at their own cache depths
  (``transformer_decoder(slots=...)``: independent per-slot AddrLen length
  streams). Serving advances in windows sized so the shortest packed
  session retires exactly at a window boundary, freeing its slot for the
  head of the queue — the slot is reused without disturbing its neighbors.
* **SLO enforcement** — per-window token rates are measured against each
  tenant's :class:`repro_torch.deploy.SLO`. A sustained violation first spends
  one re-placement; if violations persist, the lowest-priority tenant's
  youngest session is evicted (load shedding).
* **Fault tolerance** — with a :class:`repro_torch.faults.Watchdog` armed, a
  window that hangs (a stuck PU, a lost sync token, a dead HBM channel)
  comes back as structured :class:`~repro_torch.faults.FaultReport` diagnostics
  instead of an unbounded simulation. The server quarantines the suspect
  PU / HBM channel, re-places the surviving tenants over the *masked*
  array (``plan_placement(available=...)`` — the changed budget forces
  the safe from-scratch exploration), hot-swaps the degraded deployment,
  and replays every interrupted decode session from its last completed
  window's K/V append cursor (the faulted window's partial progress is
  discarded, so no session observes a half-written cache row). When the
  shrunken array cannot host every tenant, the lowest-priority tenant's
  work is shed. Faults and deadlocks surface as typed ``srv.events``
  entries, never as exceptions escaping :meth:`Server.drain`.

Time is virtual: each window's duration is the simulated wall time of its
deployment run, so the whole loop is deterministic — admission order, swap
points and evictions are pure functions of the submitted requests (and of
the injected fault schedule, which is itself a frozen seeded value).
"""
from __future__ import annotations

import bisect
from typing import Optional

from ..compiler.zoo import transformer_decoder
from ..configs import get_config
from ..core.events import DeadlockError
from ..core.pu import N_HBM_CHANNELS
from ..deploy import (RunReport, SLO, Strategy, System, TenantReport,
                      Workload, compile_deployment)
from ..dse.replan import Placement, plan_placement
from ..faults import FaultCode, FaultReport, Watchdog, reports_from_blocked
from .request import (DecodeSession, Request, ServeEvent, TenantState,
                      WindowSample)

MAX_WINDOW = 128  # 7-bit AddrCyc NC bound on the cache append side


class DrainStuckError(RuntimeError):
    """:meth:`Server.drain` exhausted its window budget with work left.

    ``stuck`` names every tenant still holding queued or active requests,
    so a wedged serving loop reports *who* is stuck instead of silently
    truncating."""

    def __init__(self, max_windows: int, stuck) -> None:
        self.max_windows = max_windows
        self.stuck = tuple(stuck)
        names = ", ".join(self.stuck) or "<none>"
        super().__init__(
            f"drain did not converge in {max_windows} windows; "
            f"tenants still holding work: {names}")


class Server:
    """Admission, packing, placement and eviction over one fixed machine."""

    def __init__(self, pus=None, *, n_pu1x: int = 5, n_pu2x: int = 5,
                 slo_patience: int = 2, verify: bool = True,
                 engine: str = "batched",
                 watchdog: Optional[Watchdog] = None) -> None:
        self.system = System(pus)
        self.n_pu1x = n_pu1x
        self.n_pu2x = n_pu2x
        self.slo_patience = slo_patience
        self.verify = verify
        self.engine = engine
        self.watchdog = watchdog
        self.system.watchdog = watchdog
        self.now = 0.0
        self.events: list[ServeEvent] = []
        self.requests: list[Request] = []
        self.placement: Optional[Placement] = None
        self.windows = 0
        self.faults: list[FaultReport] = []   # every detected fault, in order
        self.quarantined: set[int] = set()    # pids removed from service
        self.dead_channels: set[int] = set()  # HBM channels removed
        self._tenants: dict[str, TenantState] = {}
        self._placed = None  # (names, quarantined, dead_channels) at replan
        self._prev_multi = None  # last MultiDSEResult, threaded as prev=
        self._seq = 0

    # -- fault injection -----------------------------------------------------
    def inject(self, schedule, *, watchdog="auto") -> None:
        """Attach a :class:`repro_torch.faults.FaultSchedule` to the simulated
        hardware (re-armed every window until recovery routes around it).

        Unless a watchdog is already configured — or one is explicitly
        given (pass ``watchdog=None`` to exercise the slower drained-heap
        deadlock detection instead) — a default
        :class:`repro_torch.faults.Watchdog` is armed alongside, so injected
        faults are detected rather than deadlocking the loop."""
        self.system.inject(schedule)
        if watchdog == "auto":
            watchdog = self.watchdog or Watchdog()
        self.watchdog = watchdog
        self.system.watchdog = watchdog
        self._event("inject", "", schedule.describe())

    # -- tenancy -------------------------------------------------------------
    def join(self, name: str, arch="qwen3-0.6b", *, depth: int = 1,
             max_slots: int = 2, window: int = 8,
             placement_prefix: int = 64,
             slo: Optional[SLO] = None) -> TenantState:
        """Register a tenant: its model (``arch`` config name or ArchConfig,
        ``depth`` decoder blocks), slot capacity and SLO.

        ``placement_prefix`` fixes the representative cache depth of the
        tenant's *placement graph* — the stable graph the DSE places (its
        fingerprint must not change between replans, or the incremental
        ``prev=`` reuse would never hit). The actually-served windows
        compile their own slot-packed graphs at the live depths."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already joined")
        if not 1 <= window <= MAX_WINDOW:
            raise ValueError(f"window must be in [1, {MAX_WINDOW}]")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        cfg = get_config(arch) if isinstance(arch, str) else arch
        g = transformer_decoder(cfg, slots=(placement_prefix,) * max_slots,
                                decode_steps=window, depth=depth)
        t = TenantState(name=name, workload=Workload(g, label=name),
                        arch=cfg, depth=depth, max_slots=max_slots,
                        window=window, slo=slo)
        self._tenants[name] = t
        self._event("join", name,
                    f"{cfg.name} x{depth} slots={max_slots} window={window}")
        return t

    def leave(self, name: str, *, force: bool = False) -> None:
        """Deregister ``name``. Refuses while the tenant still has queued or
        active requests unless ``force``, which evicts them."""
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"no tenant {name!r}")
        if t.has_work and not force:
            raise ValueError(
                f"tenant {name!r} still has work; drain first or force=True")
        for sess in t.active:
            self._finish(sess.request, evicted=True)
        for req in t.queue:
            self._finish(req, evicted=True)
        del self._tenants[name]
        self._event("leave", name)

    def submit(self, req: Request) -> Request:
        """Queue a request; it becomes eligible at ``req.arrival_s``."""
        t = self._tenants.get(req.tenant)
        if t is None:
            raise KeyError(f"no tenant {req.tenant!r} — join first")
        self._seq += 1
        if not req.rid:
            req.rid = f"{req.tenant}-{self._seq}"
        self.requests.append(req)
        bisect.insort(t.queue, req, key=lambda r: (r.arrival_s, r.rid))
        return req

    # -- the serving loop ----------------------------------------------------
    def step(self) -> bool:
        """Serve one window. Returns False when there is nothing to do.

        A faulted window (watchdog detection or deadlock) does not advance
        any session: its partial progress is discarded, the suspect PU /
        channel is quarantined, and the next step re-places the survivors
        on the masked array and replays the interrupted sessions from
        their last completed window's K/V append cursor."""
        self._admit()
        if not self._active_tenants():
            arrivals = [r.arrival_s for t in self._tenants.values()
                        for r in t.queue]
            if not arrivals:
                return False
            self.now = max(self.now, min(arrivals))  # idle-skip virtual time
            self._admit()
            if not self._active_tenants():
                return False
        if not self._ensure_placement():
            # everything placeable was shed; anything left retries later
            return any(t.has_work for t in self._tenants.values())
        dep = self._compile_window()
        if self.system.deployment is None:
            self.system.load(dep)
        else:
            self.system.switch(dep)
        self._event("swap", "", dep.name)
        try:
            report = self.system.run()
        except DeadlockError as e:
            # max_events livelock guard: surface as typed events + recover.
            self.windows += 1
            self._handle_faults(reports_from_blocked(e.blocked))
            return True
        self.windows += 1
        faults = list(report.faults)
        if not faults and report.deadlocked:
            # No watchdog armed: the drained heap is the detection.
            faults = reports_from_blocked(report.blocked)
        if faults:
            self.now += report.wall_s  # the wedged window still took time
            self._handle_faults(faults)
            return True
        dt = report.wall_s
        self.now += dt
        self._account(report, dt)
        return True

    def drain(self, *, max_windows: int = 10_000) -> RunReport:
        """Serve until every queue and slot is empty; return the aggregate
        :class:`RunReport` (per-tenant token rates, request latency
        percentiles, SLO attainment). With zero tenants (or only empty
        queues) this is a no-op returning an empty report. Raises
        :class:`DrainStuckError` naming the stuck tenants if the loop does
        not converge within ``max_windows``."""
        for _ in range(max_windows):
            if not self.step():
                break
        else:
            stuck = sorted(n for n, t in self._tenants.items() if t.has_work)
            raise DrainStuckError(max_windows, stuck)
        return self.report()

    def report(self) -> RunReport:
        """Aggregate serving report over everything served so far."""
        tenants = {}
        for name, t in sorted(self._tenants.items()):
            tenants[name] = self._tenant_report(t)
        return RunReport(tenants=tenants, wall_s=self.now, source="serve")

    # -- internals -----------------------------------------------------------
    def _event(self, kind: str, tenant: str, detail: str = "") -> None:
        self.events.append(ServeEvent(t=self.now, kind=kind, tenant=tenant,
                                      detail=detail))

    def _active_tenants(self) -> list[TenantState]:
        return [t for _, t in sorted(self._tenants.items()) if t.active]

    def _admit(self) -> None:
        for _, t in sorted(self._tenants.items()):
            while t.free_slots > 0 and t.queue \
                    and t.queue[0].arrival_s <= self.now:
                req = t.queue.pop(0)
                req.admitted_s = self.now
                t.active.append(DecodeSession(request=req,
                                              depth=req.prompt_tokens,
                                              remaining=req.max_new_tokens))
                self._event("admit", t.name,
                            f"{req.rid} depth={req.prompt_tokens} "
                            f"new={req.max_new_tokens}")

    def _healthy_pids(self) -> list[int]:
        return [p.pid for p in self.system.pus
                if p.pid not in self.quarantined]

    def _healthy_channels(self) -> list[int]:
        return [c for c in range(N_HBM_CHANNELS)
                if c not in self.dead_channels]

    def _ensure_placement(self) -> bool:
        """Re-place the active tenants if the tenant set *or* the healthy
        array changed since the last plan. When the shrunken array cannot
        host everyone, sheds the lowest-priority tenant's work and retries
        until a feasible placement exists (or no tenant remains — returns
        False; True means ``self.placement`` covers every active tenant)."""
        while True:
            active = self._active_tenants()
            if not active:
                return False
            names = frozenset(t.name for t in active)
            key = (names, frozenset(self.quarantined),
                   frozenset(self.dead_channels))
            if self.placement is not None and key == self._placed:
                return True
            try:
                self.placement = plan_placement(
                    [t.workload for t in active], pus=self.system.pus,
                    n_pu1x=self.n_pu1x, n_pu2x=self.n_pu2x,
                    prev=self._prev_multi, engine=self.engine,
                    available=self._healthy_pids() if self.quarantined
                    else None)
            except ValueError as e:
                # Degraded array cannot host this tenant set: shed the
                # lowest-priority tenant's work and try the smaller set.
                if not self._shed_tenant(reason=str(e)):
                    return False
                continue
            if self.placement.result is not None:
                self._prev_multi = self.placement.result
            self._placed = key
            cfgs = ", ".join(f"{t.name}({a},{b})" for t, (a, b)
                             in zip(active, self.placement.configs))
            self._event("replan", "", cfgs)
            return True

    def _shed_tenant(self, reason: str = "") -> bool:
        """Shed *all* work (active sessions + queue) of the lowest-priority
        tenant holding any — the degraded array cannot meet everyone's
        demand, so the least important tenant loses service entirely.
        Returns False when no tenant had work to shed."""
        candidates = [t for _, t in sorted(self._tenants.items())
                      if t.has_work]
        if not candidates:
            return False
        def prio(t: TenantState) -> tuple:
            return ((t.slo.priority if t.slo else 0), t.name)
        victim = min(candidates, key=prio)
        n = len(victim.active) + len(victim.queue)
        for sess in victim.active:
            self._finish(sess.request, evicted=True)
        for req in victim.queue:
            self._finish(req, evicted=True)
        victim.active.clear()
        victim.queue.clear()
        self._event("shed", victim.name,
                    f"{n} request(s) dropped: degraded array cannot host "
                    f"all tenants" + (f" ({reason.splitlines()[0]})"
                                      if reason else ""))
        return True

    def _handle_faults(self, faults: list) -> None:
        """Turn a wedged window into quarantine + replay.

        The report list mixes root causes with secondary victims (a PU
        parked on a WAIT whose partner hung is itself reported as blocked),
        so suspects are ranked: an injected/instrumented PU hang first,
        then a dead HBM channel, then the *source* of the earliest-starved
        sync channel (the waiter closest to a lost token parks first, and
        a starvation cycle's later channels point at secondary victims),
        then heartbeat-flagged members, and only then generic stalls."""
        self.faults.extend(faults)
        for r in faults:
            self._event("fault", r.member, str(r))
        suspects: set[int] = set()
        dead_chans: set[int] = set()
        for r in faults:  # rung 1: the PU that stopped issuing
            if r.code == FaultCode.PU_HANG and r.pid is not None:
                suspects.add(r.pid)
        for r in faults:  # rung 2: a stalled HBM channel
            if r.code == FaultCode.HBM_TIMEOUT and r.hbm_channel is not None:
                dead_chans.add(r.hbm_channel)
        if not suspects and not dead_chans:
            # rung 3: the silent source of the *first* channel to starve
            for r in sorted((r for r in faults
                             if r.code in (FaultCode.SYNC_TIMEOUT,
                                           FaultCode.DEADLOCK)
                             and r.channel is not None),
                            key=lambda r: (r.cycle, str(r))):
                src = r.channel[0]
                if src not in self.quarantined:
                    suspects.add(src)
                    break
        if not suspects and not dead_chans:
            for r in faults:  # rung 4: a member making no round progress
                if r.code == FaultCode.HEARTBEAT and r.pid is not None:
                    suspects.add(r.pid)
        if not suspects and not dead_chans:
            for r in faults:  # rung 5: fall back to any blocked pid
                if r.pid is not None and r.pid not in self.quarantined:
                    suspects.add(r.pid)
                    break
        for pid in sorted(suspects):
            self.quarantined.add(pid)
            self._event("quarantine", "", f"pu{pid} removed from service "
                        f"({len(self._healthy_pids())} PUs remain)")
        for c in sorted(dead_chans):
            self.dead_channels.add(c)
            self._event("quarantine", "", f"hbm channel {c} removed from "
                        f"service ({len(self._healthy_channels())} remain)")
        # The faulted window's partial progress is discarded (sessions were
        # never advanced), so every interrupted session replays from its
        # last completed window's K/V append cursor.
        for t in self._active_tenants():
            for sess in t.active:
                self._event("replay", t.name,
                            f"{sess.rid} from depth={sess.depth} "
                            f"remaining={sess.remaining}")
        self.placement = None
        self._placed = None

    def _compile_window(self):
        assignments = []
        for t in self._active_tenants():
            w = min(t.window, min(s.remaining for s in t.active))
            g = transformer_decoder(t.arch,
                                    slots=tuple(s.depth for s in t.active),
                                    decode_steps=w, depth=t.depth)
            wl = Workload(g, label=t.name, rounds=w,
                          slots=tuple(s.rid for s in t.active))
            a, b = self.placement.config_for(t.name)
            assignments.append((wl, a, b))
        strat = Strategy.tenants(assignments)
        kw = {}
        if self.quarantined:
            kw["available"] = self._healthy_pids()
        if self.dead_channels:
            kw["channels"] = self._healthy_channels()
        return compile_deployment(None, strat, pus=self.system.pus,
                                  verify=self.verify, **kw)

    def _finish(self, req: Request, *, evicted: bool = False) -> None:
        req.finished_s = self.now
        req.evicted = evicted

    def _account(self, report: RunReport, dt: float) -> None:
        for t in self._active_tenants():
            tr = report.tenants.get(t.name)
            if tr is None:  # pragma: no cover - every active tenant ran
                continue
            rounds = tr.rounds
            t.rounds += rounds
            t.tokens += tr.tokens
            for sess in list(t.active):
                sess.advance(rounds)
                if sess.remaining <= 0:
                    t.active.remove(sess)
                    self._finish(sess.request)
                    self._event("retire", t.name,
                                f"{sess.rid} tokens={sess.request.generated} "
                                f"lat={self.now - sess.request.arrival_s:.6f}s")
            self._check_slo(t, tr.tokens, dt)

    def _check_slo(self, t: TenantState, tokens: int, dt: float) -> None:
        if t.slo is None or t.slo.min_tokens_per_s is None:
            t.samples.append(WindowSample(t=self.now, tokens=tokens, dt=dt))
            return
        met = (tokens / dt if dt > 0 else 0.0) >= t.slo.min_tokens_per_s
        t.samples.append(WindowSample(t=self.now, tokens=tokens, dt=dt,
                                      met=met))
        if met:
            t.violations = 0
            return
        t.violations += 1
        self._event("slo-violation", t.name,
                    f"{tokens / dt if dt > 0 else 0.0:.1f} < "
                    f"{t.slo.min_tokens_per_s:.1f} tok/s "
                    f"({t.violations}/{self.slo_patience})")
        if t.violations < self.slo_patience:
            return
        t.violations = 0
        if t.replans == 0:
            # First remedy: one fresh joint placement for the current mix.
            t.replans += 1
            self.placement = None
            self._placed = None
            self._event("replan", t.name, "slo remediation")
        else:
            self._shed()

    def _shed(self) -> None:
        """Evict the lowest-priority tenant's youngest session."""
        candidates = [t for t in self._active_tenants()]
        if not candidates:
            return
        def prio(t: TenantState) -> tuple:
            return ((t.slo.priority if t.slo else 0), t.name)
        victim = min(candidates, key=prio)
        sess = victim.active.pop()  # youngest admitted session
        self._finish(sess.request, evicted=True)
        self._event("evict", victim.name,
                    f"{sess.rid} after {sess.request.generated} tokens")

    def _tenant_report(self, t: TenantState) -> TenantReport:
        lats = tuple(r.latency_s for r in self.requests
                     if r.tenant == t.name and r.completed)
        attain = None
        if t.slo is not None:
            parts = []
            if t.slo.min_tokens_per_s is not None:
                rated = [s for s in t.samples if s.met is not None]
                if rated:
                    parts.append(sum(s.met for s in rated) / len(rated))
            if t.slo.deadline_s is not None:
                done = [r for r in self.requests
                        if r.tenant == t.name and r.completed]
                if done:
                    parts.append(sum(r.latency_s <= t.slo.deadline_s
                                     for r in done) / len(done))
            if parts:
                attain = min(parts)
        wall = self.now if self.now > 0 else 1.0
        return TenantReport(tenant=t.name, fps=t.rounds / wall,
                            token_rate=t.tokens / wall, rounds=t.rounds,
                            tokens=t.tokens, latencies_s=lats, slo=t.slo,
                            slo_attainment=attain)
