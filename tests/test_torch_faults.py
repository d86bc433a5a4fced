"""The port's fault package (``repro_torch.faults``) and its hooks in the
simulator copy, ``System`` and ``Server`` against the JAX package's
``repro.faults``, on the cases of ``tests/test_faults.py``: the event
kernel's blocked-process diagnostics, seeded schedules, watchdog detection
of all five fault classes, reset, masked placement, server recovery
(quarantine, replay, shedding), drain hardening and chaos determinism. Each
scenario runs through both packages and the results are compared field for
field: event logs, ``FaultReport``s, ``RunReport``s, simulator results and
placements. A scenario that serves several cases runs once, in a
module-scoped fixture."""
import dataclasses
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from test_torch_core_sim import _assert_same  # noqa: E402
from test_torch_deploy import _assert_same_deployment, _report  # noqa: E402

import repro.core.events as jev  # noqa: E402
import repro.core.isa as jisa  # noqa: E402
import repro.dse.replan as jreplan  # noqa: E402
import repro_torch.core.events as tev  # noqa: E402
import repro_torch.core.isa as tisa  # noqa: E402
import repro_torch.dse.replan as treplan  # noqa: E402
from repro import compiler as jc, deploy as jd, dse as jdse, faults as jf, serve as js  # noqa: E402
from repro_torch import compiler as tc, deploy as td, dse as tdse, faults as tf  # noqa: E402
from repro_torch import serve as ts  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(c=jc, d=jd, x=jdse, f=jf, s=js, ev=jev, isa=jisa, replan=jreplan),
    "torch": SimpleNamespace(c=tc, d=td, x=tdse, f=tf, s=ts, ev=tev, isa=tisa, replan=treplan),
}
CLASSES = ["pu-hang", "token-drop", "token-corrupt", "hbm-stall", "link-spike"]


def _both(fn):
    """``fn(pkg)`` for each package: {"jax": ..., "torch": ...}."""
    return {name: fn(p) for name, p in PKGS.items()}


def _fault(r):
    return (r.code.value, r.message, r.severity.value, r.member, r.pid, r.group, r.index,
            r.channel, r.hbm_channel, r.cycle, r.location, r.suspect_pid,
            r.suspect_hbm_channel, str(r))


def _spec(f):
    return type(f).__name__, dataclasses.astuple(f)


def _schedule(s):
    return [_spec(f) for f in s], s.seed, s.describe(), bool(s)


def _run(rep):
    """A ``System.run`` report: the simulator result, the report and the
    fault diagnostics."""
    return rep.sim, _report(rep), [_fault(r) for r in rep.faults], rep.faulted


def _assert_same_runs(got, want):
    _assert_same(got[0], want[0])
    assert got[1:] == want[1:]


def _cnn_dep(p):
    return p.d.compile_deployment(p.c.zoo.tiny_cnn(), p.d.Strategy.single(2, 1))


def _stage_pids(dep):
    """Pipeline-ordered pids of the first member."""
    cm = dep.members[0].compiled
    return [cm.pid_map[i] for i in sorted(s.index for s in cm.part.stages if s.nids)]


def _used_channel(p, dep):
    """The HBM channel the deployment's DataMoves reference most."""
    from collections import Counter

    c = Counter(inst.channel for prog in dep.programs() for grp in (prog.ld, prog.cp, prog.st)
                for inst in grp.instructions if isinstance(inst, p.isa.DataMove))
    return c.most_common(1)[0][0]


def _schedule_for(p, klass, dep):
    pids, f = _stage_pids(dep), p.f
    return p.f.FaultSchedule(faults=({
        "pu-hang": lambda: f.PUHang(pid=pids[-1], at_cycle=2000.0),
        "token-drop": lambda: f.TokenDrop(src_pid=pids[0]),
        "token-corrupt": lambda: f.TokenCorrupt(src_pid=pids[0]),
        "hbm-stall": lambda: f.HBMStall(channel=_used_channel(p, dep), at_cycle=1000.0),
        "link-spike": lambda: f.LinkSpike(src_pid=pids[0], dst_pid=pids[1],
                                          extra_cycles=10_000_000.0),
    }[klass](),))


@pytest.fixture(scope="module")
def cnn_deps():
    deps = _both(_cnn_dep)
    _assert_same_deployment(deps["torch"], deps["jax"])
    return deps


# ------------------------------------------------------- kernel diagnostics --
def _blocked(k):
    return [tuple(b) for b in k.blocked_procs()]


class TestKernelDiagnostics:
    def test_blocked_proc_carries_cycle_and_member(self):
        def go(p):
            k = p.ev.Kernel()

            def parked():
                yield p.ev.Delay(10)
                yield p.ev.WaitCond("never-signalled", desc="stuck on nothing")

            k.spawn(parked(), name="p0", member="m0")
            k.run()
            return bool(k.deadlocked()), k.now, _blocked(k)

        got = _both(go)
        assert got["torch"] == got["jax"]
        assert got["torch"] == (True, 10, [("p0", "stuck on nothing", 10, "m0")])

    def test_daemon_excluded_from_deadlock(self):
        def go(p):
            k = p.ev.Kernel()

            def ticker():
                while True:
                    yield p.ev.Delay(5)

            def worker():
                yield p.ev.Delay(12)

            k.spawn(ticker(), name="tick", daemon=True)
            k.spawn(worker(), name="work")
            k.run()  # must terminate: the daemon alone keeps no heap alive
            return bool(k.deadlocked()), k.now

        got = _both(go)
        assert got["torch"] == got["jax"]
        assert got["torch"][0] is False and got["torch"][1] >= 12

    def test_halt_stops_run(self):
        def go(p):
            k = p.ev.Kernel()

            def slow():
                yield p.ev.Delay(1000)

            def halter():
                yield p.ev.Delay(5)
                k.halt()

            k.spawn(slow(), name="slow")
            k.spawn(halter(), name="halter")
            k.run()
            return k.now

        assert _both(go) == {"jax": 5, "torch": 5}

    def test_reports_from_blocked_parses_channel(self):
        def go(p):
            k = p.ev.Kernel()

            def parked():
                yield p.ev.WaitCond(("lut", 1, "REQ", (0, 7)),
                                    desc="WAIT_REQ on channel (src_pid=0, bid=7)")

            k.spawn(parked(), name="pu1.LD", member="t0")
            k.run()
            return [_fault(r) for r in p.f.reports_from_blocked(k.blocked_procs())]

        got = _both(go)
        assert got["torch"] == got["jax"]
        (r,) = tf.reports_from_blocked([tev.BlockedProc(
            name="pu1.LD", desc="WAIT_REQ on channel (src_pid=0, bid=7)", cycle=0.0,
            member="t0")])
        assert r.code == tf.FaultCode.DEADLOCK and (r.pid, r.group) == (1, "LD")
        assert r.channel == (0, 7) and r.member == "t0"
        assert r.suspect_pid == 0  # the silent source, not the waiter

    @pytest.mark.parametrize("name", ["pu3.LD", "pu3.CP", "pu12.ST", "pu3.wadm", "pu.LD",
                                      "faults.watchdog", "fault.hbm4", "xpu3.LD"])
    def test_process_names_parse_alike(self, name):
        """The watchdog locates a stuck decoder by the event kernel's process
        name; the copy parses every name as the reference does."""
        from repro.faults.report import _parse_proc_name as jparse
        from repro_torch.faults.report import _parse_proc_name as tparse

        assert tparse(name) == jparse(name)


# ---------------------------------------------------------------- schedules --
class TestFaultSchedule:
    @pytest.mark.parametrize("seed", [0, 1, 42, 43, 1001, 65535])
    def test_random_is_the_same_schedule(self, seed, cnn_deps):
        """``FaultSchedule.random`` draws from stdlib ``random``: the same
        seed gives the JAX package's schedule, twice, on the default machine
        and on a deployment's."""
        for kw in ({"n": 3}, {"n": 2, "pus": "deployment"}):
            def go(p):
                args = dict(kw)
                if args.get("pus") == "deployment":
                    args["pus"] = cnn_deps["jax" if p is PKGS["jax"] else "torch"].pus
                return _schedule(p.f.FaultSchedule.random(seed, **args))

            got = _both(go)
            assert got["torch"] == got["jax"]
            assert _schedule(tf.FaultSchedule.random(seed, **{**kw, "pus": None})) == \
                _schedule(tf.FaultSchedule.random(seed, **{**kw, "pus": None}))
        assert tf.FaultSchedule.random(seed, n=3) != tf.FaultSchedule.random(seed + 1, n=3)

    def test_describe_names_every_class(self):
        def go(p):
            return _schedule(p.f.FaultSchedule(faults=(
                p.f.PUHang(pid=3, at_cycle=100),
                p.f.TokenDrop(src_pid=1),
                p.f.TokenCorrupt(src_pid=2),
                p.f.HBMStall(channel=4),
                p.f.LinkSpike(src_pid=0, dst_pid=5, extra_cycles=1000),
            )))

        got = _both(go)
        assert got["torch"] == got["jax"]
        assert tf.FAULT_CLASSES == jf.FAULT_CLASSES
        for tag in CLASSES:
            assert tag in got["torch"][2]
        assert tf.FaultSchedule().describe() == jf.FaultSchedule().describe()


# ---------------------------------------------------------------- detection --
def _detect(p, dep, schedule):
    system = p.d.System(dep.pus)
    system.watchdog = p.f.Watchdog()
    system.load(dep)
    system.inject(schedule)
    return _run(system.run())


@pytest.fixture(scope="module")
def detections(cnn_deps):
    """Each fault class through a watched ``System`` run, and a clean run with
    and without the watchdog, in both packages."""
    out = {}
    for klass in CLASSES:
        out[klass] = {n: _detect(p, cnn_deps[n], _schedule_for(p, klass, cnn_deps[n]))
                      for n, p in PKGS.items()}
    for n, p in PKGS.items():
        dep = cnn_deps[n]
        base = p.d.System(dep.pus).load(dep).run()
        system = p.d.System(dep.pus)
        system.watchdog = p.f.Watchdog()
        out.setdefault("clean", {})[n] = (_run(base), _run(system.load(dep).run()))
    return out


class TestDetection:
    """Every fault class -> the same structured FaultReports (PU, sync
    channel, HBM channel, instruction index) as the JAX package's."""

    @pytest.mark.parametrize("klass", CLASSES)
    def test_detected_alike(self, detections, cnn_deps, klass):
        got, want = detections[klass]["torch"], detections[klass]["jax"]
        _assert_same_runs(got, want)
        reports, faulted = got[2], got[3]
        assert faulted and reports
        codes = {r[0] for r in reports}
        pids = _stage_pids(cnn_deps["torch"])
        if klass == "pu-hang":
            hangs = [r for r in reports if r[0] == "fault-pu-hang"]
            assert hangs and all(r[4] == pids[-1] and r[6] is not None for r in hangs)
            assert not got[0].deadlocked
        elif klass == "hbm-stall":
            chan = _used_channel(PKGS["torch"], cnn_deps["torch"])
            hbm = [r for r in reports if r[0] == "fault-hbm-timeout"]
            assert hbm and all(r[8] == chan for r in hbm)
        else:
            assert "fault-sync-timeout" in codes
            assert any(r[0] == "fault-sync-timeout" and r[7] is not None and r[7][0] == pids[0]
                       for r in reports)

    def test_clean_run_unchanged_by_watchdog(self, detections):
        (base, watched), (jbase, jwatched) = (detections["clean"]["torch"],
                                              detections["clean"]["jax"])
        _assert_same_runs(base, jbase)
        _assert_same_runs(watched, jwatched)
        assert not watched[3] and watched[1] == base[1]


# --------------------------------------------------------- reset regression --
class TestResetClearsFaults:
    def test_clear_faults_restores_clean_behavior(self, cnn_deps):
        def go(p, dep):
            system = p.d.System(dep.pus)
            system.watchdog = p.f.Watchdog()
            system.load(dep)
            clean = _run(system.run())
            system.inject(p.f.FaultSchedule(
                faults=(p.f.PUHang(pid=_stage_pids(dep)[-1], at_cycle=2000.0),)))
            faulted = _run(system.run())
            system.clear_faults()
            again = _run(system.run())
            hooks = (system.sim.isu.fault_hook is None,
                     all(icu.hang_at is None for icu in system.sim.icus.values()),
                     system.sim.fault_schedule is None, system.sim.injector is None)
            return clean, faulted, again, hooks

        got = {n: go(p, cnn_deps[n]) for n, p in PKGS.items()}
        for g, w in zip(got["torch"][:3], got["jax"][:3]):
            _assert_same_runs(g, w)
        clean, faulted, again, hooks = got["torch"]
        assert faulted[3] and not again[3] and again[1] == clean[1]
        assert hooks == got["jax"][3] == (True, True, True, True)

    def test_schedule_rearms_identically_every_run(self, cnn_deps):
        def go(p, dep):
            system = p.d.System(dep.pus)
            system.watchdog = p.f.Watchdog()
            system.load(dep)
            system.inject(p.f.FaultSchedule(
                faults=(p.f.PUHang(pid=_stage_pids(dep)[0], at_cycle=3000.0),)))
            a = _run(system.run())
            b = _run(system.run())  # the frozen schedule re-arms on reset
            return a, b, [(c, str(d)) for c, d in system.sim.injector.log]

        got = {n: go(p, cnn_deps[n]) for n, p in PKGS.items()}
        for g, w in zip(got["torch"][:2], got["jax"][:2]):
            _assert_same_runs(g, w)
        assert got["torch"][2] == got["jax"][2]
        assert got["torch"][0][2] == got["torch"][1][2]


# --------------------------------------------------------- masked placement --
def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def _placement(pl):
    return ([w.label for w in pl.workloads], pl.configs, dataclasses.astuple(pl.point),
            None if pl.result is None else [dataclasses.astuple(x) for x in pl.result.frontier])


class TestMaskedPlacement:
    def test_masked_compile_avoids_quarantined_resources(self, cnn_deps):
        def go(p, base):
            avail = [q.pid for q in base.pus][1:]  # quarantine pid 0
            chans = list(range(4, 32))             # channels 0-3 dead
            dep = p.d.compile_deployment(p.c.zoo.tiny_cnn(), p.d.Strategy.single(2, 1),
                                         pus=base.pus, available=avail, channels=chans)
            return dep, avail, chans, _run(p.d.System(base.pus).load(dep).run())

        got = {n: go(p, cnn_deps[n]) for n, p in PKGS.items()}
        _assert_same_deployment(got["torch"][0], got["jax"][0])
        _assert_same_runs(got["torch"][3], got["jax"][3])
        dep, avail, chans, run = got["torch"]
        m = dep.members[0]
        assert set(m.pids) <= set(avail) and set(m.channels) <= set(chans)
        assert dep.pus == cnn_deps["torch"].pus and not run[0].deadlocked

    @pytest.mark.parametrize("mask", ["none", "only_1x"])
    def test_masked_compile_refused_alike(self, cnn_deps, mask):
        def go(p, base):
            avail = [] if mask == "none" else [q.pid for q in base.pus if q.kind == "PU1x"]
            return _error(lambda: p.d.compile_deployment(
                p.c.zoo.tiny_cnn(), p.d.Strategy.single(2, 1), pus=base.pus, available=avail))

        got = {n: go(p, cnn_deps[n]) for n, p in PKGS.items()}
        assert got["torch"] == got["jax"]
        assert ("no available PUs" if mask == "none" else "PU2x") in got["torch"]

    def test_degraded_placement_equals_from_scratch(self, cnn_deps):
        """A masked re-plan threaded with the unmasked ``prev`` equals a fresh
        ``explore_multi`` on the masked budget, in the port as in JAX, and the
        two packages' placements are equal."""
        def go(p, base):
            ws = [p.d.Workload(p.c.zoo.tiny_cnn(), "a"),
                  p.d.Workload(p.c.zoo.linear_chain(3), "b")]
            full = p.replan.plan_placement(ws, pus=base.pus)
            kinds = {q.pid: q.kind for q in base.pus}
            avail = [q.pid for q in base.pus if q.pid != _stage_pids(base)[0]]
            masked = p.replan.plan_placement(ws, pus=base.pus, prev=full.result,
                                             available=avail)
            fresh = p.x.explore_multi(ws, n_pu1x=sum(kinds[i] == "PU1x" for i in avail),
                                      n_pu2x=sum(kinds[i] == "PU2x" for i in avail),
                                      pus=base.pus)
            return (_placement(full), _placement(masked), dataclasses.astuple(fresh.balanced),
                    fresh.balanced.configs)

        got = {n: go(p, cnn_deps[n]) for n, p in PKGS.items()}
        assert got["torch"] == got["jax"]
        full, masked, fresh, fresh_configs = got["torch"]
        assert masked[2] == fresh and masked[1] == fresh_configs

    def test_no_healthy_pus_raises(self, cnn_deps):
        got = {n: _error(lambda: p.replan.plan_placement(
            [p.d.Workload(p.c.zoo.tiny_cnn(), "a")], pus=cnn_deps[n].pus, available=[]))
            for n, p in PKGS.items()}
        assert got["torch"] == got["jax"] and "no available PUs" in got["torch"]


# ---------------------------------------------------------- server recovery --
def _serve_one_window(p):
    """A server with one tenant and two requests, stepped through its first
    clean window so the placement (and target pids) are known."""
    srv = p.s.Server(verify=False)
    srv.join("t", depth=1, max_slots=2, window=4)
    srv.submit(p.s.Request(tenant="t", prompt_tokens=8, max_new_tokens=8))
    srv.submit(p.s.Request(tenant="t", prompt_tokens=4, max_new_tokens=8))
    assert srv.step()
    return srv


def _server(srv, rep=None):
    """Everything a serving run leaves behind, comparable across packages."""
    pl = srv.placement
    return {
        "events": [(e.t, e.kind, e.tenant, e.detail, str(e)) for e in srv.events],
        "faults": [_fault(r) for r in srv.faults],
        "quarantined": sorted(srv.quarantined),
        "dead_channels": sorted(srv.dead_channels),
        "requests": [dataclasses.astuple(r) for r in srv.requests],
        "completed": [r.completed for r in srv.requests],
        "evicted": [r.evicted for r in srv.requests],
        "now": srv.now, "windows": srv.windows,
        "placement": None if pl is None else _placement(pl),
        "report": None if rep is None else _report(rep),
        "channels": (None if srv.system.deployment is None
                     else [m.channels for m in srv.system.deployment.members]),
    }


def _recovery(p, klass):
    srv = _serve_one_window(p)
    dep = srv.system.deployment
    if klass == "deadlock":  # no watchdog: the drained heap is the detector
        srv.inject(p.f.FaultSchedule(
            faults=(p.f.PUHang(pid=_stage_pids(dep)[-1], at_cycle=2000.0),)), watchdog=None)
    else:
        srv.inject(_schedule_for(p, klass, dep))
    out = _server(srv, srv.drain())
    out["target_channel"] = _used_channel(p, dep)
    return out


@pytest.fixture(scope="module")
def recoveries():
    """Each fault class injected into a serving loop after one clean window,
    and the same PU hang with no watchdog, drained in both packages."""
    return {klass: _both(lambda p: _recovery(p, klass)) for klass in CLASSES + ["deadlock"]}


class TestServerRecovery:
    @pytest.mark.parametrize("klass", CLASSES)
    def test_detect_quarantine_replay_complete(self, recoveries, klass):
        got = recoveries[klass]["torch"]
        assert got == recoveries[klass]["jax"]
        kinds = [e[1] for e in got["events"]]
        assert got["faults"] and "fault" in kinds  # detected
        assert got["quarantined"] or got["dead_channels"]
        assert "quarantine" in kinds and "replay" in kinds
        # recovered: every request completes on the degraded array
        assert all(got["completed"]) and not any(got["evicted"])

    def test_hbm_stall_quarantines_the_channel(self, recoveries):
        got = recoveries["hbm-stall"]["torch"]
        chan = got["target_channel"]
        assert chan in got["dead_channels"]
        assert chan not in got["channels"][0]  # the degraded window avoids it

    def test_deadlock_surfaces_as_typed_events(self, recoveries):
        got = recoveries["deadlock"]["torch"]
        assert got == recoveries["deadlock"]["jax"]
        assert any(e[1] == "fault" and "fault-deadlock" in e[3] for e in got["events"])
        assert got["quarantined"]
        assert all(c or e for c, e in zip(got["completed"], got["evicted"]))

    def test_shed_when_array_exhausted(self):
        def go(p):
            srv = p.s.Server(verify=False)
            srv.join("hi", depth=1, max_slots=1, window=4, slo=p.d.SLO(priority=2))
            srv.join("lo", depth=1, max_slots=1, window=4)
            srv.submit(p.s.Request(tenant="hi", prompt_tokens=4, max_new_tokens=4))
            srv.submit(p.s.Request(tenant="lo", prompt_tokens=4, max_new_tokens=4))
            srv.quarantined = {q.pid for q in srv.system.pus}  # total loss
            return _server(srv, srv.drain())

        got = _both(go)
        assert got["torch"] == got["jax"]
        shed = [e for e in got["torch"]["events"] if e[1] == "shed"]
        assert len(shed) == 2 and shed[0][2] == "lo"  # lowest priority first
        assert all(got["torch"]["evicted"])
        assert got["torch"]["report"][2]


class TestDrainHardening:
    def test_drain_empty_server(self):
        got = _both(lambda p: _server(srv := p.s.Server(verify=False), srv.drain()))
        assert got["torch"] == got["jax"]
        assert got["torch"]["report"][2] == {} and got["torch"]["report"][1] == 0.0

    def test_drain_tenant_without_requests(self):
        def go(p):
            srv = p.s.Server(verify=False)
            srv.join("t", depth=1, max_slots=1, window=4)
            return _server(srv, srv.drain())

        got = _both(go)
        assert got["torch"] == got["jax"]
        assert got["torch"]["report"][2]["t"][4] == 0  # no tokens

    def test_drain_stuck_names_tenants(self):
        def go(p):
            srv = p.s.Server(verify=False)
            srv.join("t", depth=1, max_slots=1, window=2)
            srv.submit(p.s.Request(tenant="t", prompt_tokens=4, max_new_tokens=64))
            with pytest.raises(p.s.DrainStuckError) as ei:
                srv.drain(max_windows=3)
            return (ei.value.stuck, ei.value.max_windows, str(ei.value)), _server(srv)

        got = _both(go)
        assert got["torch"] == got["jax"]
        assert got["torch"][0][:2] == (("t",), 3) and "t" in got["torch"][0][2]
        assert issubclass(ts.DrainStuckError, RuntimeError)


# ------------------------------------------------------- chaos determinism --
CHAOS_SEED = 1001  # pu-hang on a placed pid: detect -> quarantine -> replay


def _chaos_run(p, seed):
    srv = p.s.Server(verify=False)
    srv.join("a", depth=1, max_slots=2, window=4)
    srv.join("b", depth=1, max_slots=1, window=4)
    for i in range(3):
        srv.submit(p.s.Request(tenant="a", prompt_tokens=4 + i, max_new_tokens=8))
    srv.submit(p.s.Request(tenant="b", prompt_tokens=6, max_new_tokens=8))
    srv.inject(p.f.FaultSchedule.random(seed, n=1))
    return _server(srv, srv.drain())


class TestChaosDeterminism:
    def test_same_seed_same_everything(self):
        """The same seed gives the same event log, reports and quarantine
        twice in the port, and the JAX package's."""
        a, b = _chaos_run(PKGS["torch"], CHAOS_SEED), _chaos_run(PKGS["torch"], CHAOS_SEED)
        assert a == b
        assert a == _chaos_run(PKGS["jax"], CHAOS_SEED)
        assert a["faults"] and a["quarantined"]

    @pytest.mark.parametrize("seed", [3, 977, 2024, 65536])
    def test_any_seed_detection_is_deterministic(self, cnn_deps, seed):
        """Two-fault random schedules over the deployment's machine: the
        same reports and rates twice, and the JAX package's (fixed seeds in
        place of the reference's hypothesis draw)."""
        def go(p, dep):
            sched = p.f.FaultSchedule.random(seed, n=2, pus=dep.pus)
            return [_detect(p, dep, sched)[1:] for _ in range(2)]

        got = {n: go(p, cnn_deps[n]) for n, p in PKGS.items()}
        assert got["torch"][0] == got["torch"][1] == got["jax"][0]
