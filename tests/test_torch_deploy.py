"""The port's deployment layer (``repro_torch.deploy``) against the JAX
package's ``repro.deploy``: the same graphs, strategies and rounds through
both give the same programs word for word, the same placements, fit
diagnostics and analytic predictions (``==``), and the same simulated
results field for field through ``System`` load, run, switch and session
history; the degraded-array masks place and fail alike; ``explore`` and
``explore_multi`` validate alike. ResNet-50 at 256x256 runs DP-A and DP-C
once a package (the example's rounds); everything else is small."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from test_torch_core_sim import _assert_same  # noqa: E402

from repro import compiler as jc, deploy as jd, dse as jdse  # noqa: E402
from repro.core.pu import make_u50_system as jax_u50  # noqa: E402
from repro_torch import compiler as tc, deploy as td, dse as tdse  # noqa: E402
from repro_torch.core.pu import make_u50_system  # noqa: E402

PKGS = {"jax": (jc, jd, jdse), "torch": (tc, td, tdse)}


def _programs(dep):
    return [(p.pid, p.label, p.encode()) for p in dep.programs()]


def _members(dep):
    return [(m.index, m.config, m.workload.label, m.pids, m.channels, m.first_pid,
             m.last_pid, m.predicted_fps, m.predicted_latency,
             dataclasses.astuple(m.resources), dataclasses.astuple(m.sim_member()))
            for m in dep.members]


def _predicted(dep):
    return (dep.name, dep.batch, dep.rounds, dep.is_multi_tenant,
            [w.label for w in dep.workloads], dep.predicted_throughput,
            dep.predicted_throughput_by_workload(), dep.predicted_latency, dep.used_tops,
            dep.predicted_ce(), dep.predicted_ce(4.608))


def _assert_same_deployment(got, want):
    assert _programs(got) == _programs(want)
    assert _members(got) == _members(want)
    assert _predicted(got) == _predicted(want)
    assert [dataclasses.astuple(p) for p in got.pus] == [dataclasses.astuple(p)
                                                         for p in want.pus]


def _report(rep):
    return (rep.source, rep.wall_s, {k: dataclasses.astuple(t) for k, t in rep.tenants.items()},
            rep.aggregate_fps(warmup=2), rep.fps_by_workload(warmup=2),
            rep.aggregate_token_rate(warmup=2), rep.total_tokens, rep.latency_p50,
            rep.latency_p95, rep.latency_p99, rep.slo_attainment(), str(rep))


def _assert_same_run(got, want):
    _assert_same(got.sim, want.sim)
    assert _report(got) == _report(want)


def _session(system):
    return ([(name, _report(rep)) for name, rep in system.history],
            [(s.name, str(s.strategy), s.tenants) for s in system.session.swaps],
            system.tenants, repr(system.session))


# -- ResNet-50 @256: DSE -> deploy DP-A / DP-C -> load, run, switch ----------
@pytest.fixture(scope="module")
def resnet50_flow():
    """Per package: ``explore(tolerance=0.01)``, DP-A at 6 rounds and DP-C
    at 5 (examples/resnet50_dse.py), one System loading DP-A, running it,
    switching to DP-C and running that."""
    out = {}
    for name, (c, d, x) in PKGS.items():
        res = x.explore(c.zoo.resnet50(256), tolerance=0.01)
        dep_a, dep_c = res.deploy(res.dp_a, rounds=6), res.deploy(res.dp_c, rounds=5)
        system = d.System()
        run_a = system.load(dep_a).run()
        run_c = system.switch(dep_c).run()
        out[name] = dict(res=res, dep_a=dep_a, dep_c=dep_c, system=system, run_a=run_a,
                         run_c=run_c)
    return out


def test_resnet50_deployments_match_jax(resnet50_flow):
    t, j = resnet50_flow["torch"], resnet50_flow["jax"]
    for key in ("dep_a", "dep_c"):
        _assert_same_deployment(t[key], j[key])
    assert t["dep_c"].batch == 10 and len(t["dep_a"].members) == 1
    t["dep_c"].assert_disjoint()


def test_resnet50_run_and_switch_match_jax(resnet50_flow):
    t, j = resnet50_flow["torch"], resnet50_flow["jax"]
    _assert_same_run(t["run_a"], j["run_a"])
    _assert_same_run(t["run_c"], j["run_c"])
    assert _session(t["system"]) == _session(j["system"])
    assert len(t["system"].history) == 2
    # the gate of tests/test_deploy.py: within 10 % of the analytic model
    for dep, run in ((t["dep_a"], t["run_a"]), (t["dep_c"], t["run_c"])):
        assert not run.deadlocked
        assert run.aggregate_fps(warmup=2) == pytest.approx(dep.predicted_throughput, rel=0.10)


# -- resources: placements and fit diagnostics -------------------------------
STRATEGIES = [
    [(5, 5)], [(2, 1), (1, 2), (2, 2)], [(1, 0)] * 5 + [(0, 1)] * 5, [(0, 1)] * 3,
]


@pytest.mark.parametrize("configs", STRATEGIES, ids=lambda c: f"{len(c)}members")
@pytest.mark.parametrize("channels", [None, (0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22)])
def test_partition_resources_matches_jax(configs, channels):
    got = td.partition_resources(td.Strategy.multi(configs), make_u50_system(),
                                 channels=channels)
    want = jd.partition_resources(jd.Strategy.multi(configs), jax_u50(), channels=channels)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]


def _raises(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("configs,n_channels,fits", [
    ([(3, 0), (3, 0)], 32, False), ([(1, 1)] * 6, 4, False), ([(6, 6)], 2, False),
    ([(2, 2), (2, 2)], 32, True),
])
@pytest.mark.parametrize("tenants", [False, True])
def test_check_fits_diagnostics_match_jax(configs, n_channels, fits, tenants):
    """An overcommitted strategy names every member (and its tenant) and
    every problem, the same text in both packages; a fitting one passes in
    both."""
    def strat(c, d):
        if not tenants:
            return d.Strategy.multi(configs)
        return d.Strategy.tenants([(d.Workload(c.zoo.tiny_cnn(), f"t{i}"), a, b)
                                   for i, (a, b) in enumerate(configs)])
    got_fn = lambda: td.check_fits(strat(tc, td), make_u50_system(), n_channels)  # noqa: E731
    want_fn = lambda: jd.check_fits(strat(jc, jd), jax_u50(), n_channels)  # noqa: E731
    if fits:
        assert got_fn() is None and want_fn() is None
        return
    got, want = _raises(got_fn), _raises(want_fn)
    assert got == want and "member 0" in got and ("[t0]" in got) == tenants


# -- degraded masks: available / channels -------------------------------------
@pytest.mark.parametrize("configs,available,channels", [
    ([(2, 1)], (0, 1, 2, 5, 6), None),
    ([(1, 1), (1, 1)], (1, 3, 6, 8), (4, 5, 6, 7, 9, 11, 30, 31)),
    ([(2, 2)], None, (0, 1, 2, 3)),
])
def test_degraded_masks_match_jax(configs, available, channels):
    deps = {name: d.compile_deployment(c.zoo.tiny_cnn(), d.Strategy.multi(configs), rounds=4,
                                       available=available, channels=channels)
            for name, (c, d, _) in PKGS.items()}
    _assert_same_deployment(deps["torch"], deps["jax"])
    if available is not None:
        assert {p for m in deps["torch"].members for p in m.pids} <= set(available)
    _assert_same_run(td.System().load(deps["torch"]).run(), jd.System().load(deps["jax"]).run())


@pytest.mark.parametrize("configs,available,channels", [
    ([(1, 1)], (), None),                      # every pid masked out
    ([(1, 1)], (0, 1, 2, 3, 4), None),         # every PU2x quarantined
    ([(3, 0)], (0, 1, 5, 6), None),            # too few healthy PU1x
    ([(1, 0), (1, 0)], None, (3,)),            # two members, one channel
])
def test_degraded_mask_errors_match_jax(configs, available, channels):
    got = _raises(lambda: td.compile_deployment(tc.zoo.tiny_cnn(), td.Strategy.multi(configs),
                                                available=available, channels=channels))
    want = _raises(lambda: jd.compile_deployment(jc.zoo.tiny_cnn(), jd.Strategy.multi(configs),
                                                 available=available, channels=channels))
    assert got == want


# -- multi-tenant and decode ---------------------------------------------------
def _tenants(c, d):
    return d.Strategy.tenants([
        (d.Workload(c.zoo.tiny_cnn(), "cnn"), 1, 1),
        (d.Workload(c.zoo.transformer_encoder(seq_len=64, depth=2), "enc"), 1, 1),
    ])


def test_multi_tenant_deploy_run_and_swap_match_jax():
    """A single-tenant tiny_cnn session hot-swaps to a cnn + encoder split
    and back; programs, runs and history equal JAX's, and the swap back
    equals a fresh load."""
    out = {}
    for name, (c, d, _) in PKGS.items():
        solo = d.compile_deployment(c.zoo.tiny_cnn(), d.Strategy.single(2, 2), rounds=4)
        two = d.compile_deployment(None, _tenants(c, d), rounds=4)
        system = d.System()
        runs = [system.load(solo).run(), system.switch(two).run(), system.switch(solo).run()]
        out[name] = (solo, two, system, runs, d.System().load(solo).run())
    (solo, two, system, runs, fresh), want = out["torch"], out["jax"]
    _assert_same_deployment(solo, want[0])
    _assert_same_deployment(two, want[1])
    for got_run, want_run in zip(runs, want[3]):
        _assert_same_run(got_run, want_run)
    assert _session(system) == _session(want[2])
    assert system.tenants == tuple(w.label for w in solo.workloads)
    _assert_same_run(runs[2], fresh)  # a switch leaves no residue
    for label, meas in runs[1].fps_by_workload(warmup=2).items():
        assert meas == pytest.approx(two.predicted_throughput_by_workload()[label], rel=0.10)


def test_decode_rounds_and_prefill_to_decode_swap_match_jax():
    """Decode rounds default to the window; a prefill -> decode -> prefill
    session equals JAX's, the swap equal to a fresh load."""
    out = {}
    for name, (c, d, x) in PKGS.items():
        dec = c.zoo.transformer_decoder("qwen3-0.6b", seq_len=64, decode_steps=8, depth=2)
        pre = c.zoo.transformer_encoder("qwen3-0.6b", seq_len=64, depth=2)
        res = x.explore(dec)
        deps = [d.compile_deployment(pre, d.Strategy.single(2, 2), rounds=4),
                res.deploy(res.dp_a), d.compile_deployment(d.Workload(dec, rounds=2),
                                                           d.Strategy.single(1, 1), rounds=3)]
        system = d.System()
        runs = [system.load(deps[0]).run(), system.switch(deps[1]).run(),
                system.switch(deps[0]).run()]
        out[name] = (deps, runs, system, d.System().load(deps[1]).run())
    (deps, runs, system, fresh), want = out["torch"], out["jax"]
    for got_dep, want_dep in zip(deps, want[0]):
        _assert_same_deployment(got_dep, want_dep)
    assert all(p.ld.progctrl.nr == 8 for p in deps[1].programs())
    assert all(p.ld.progctrl.nr == 2 for p in deps[2].programs())
    for got_run, want_run in zip(runs, want[1]):
        _assert_same_run(got_run, want_run)
    assert _session(system) == _session(want[2])
    _assert_same_run(runs[1], fresh)
    assert runs[1].aggregate_fps(warmup=2) == pytest.approx(deps[1].predicted_throughput,
                                                            rel=0.05)


# -- explore / explore_multi validation ---------------------------------------
def test_explore_validate_matches_jax():
    recs = {}
    for name, (c, _, x) in PKGS.items():
        recs[name] = x.explore(c.zoo.tiny_cnn(), validate=1, validate_rounds=4).validation
    got, want = recs["torch"], recs["jax"]
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert (g.configs, g.analytic_fps) == (w.configs, w.analytic_fps)
        assert g.simulated_fps == pytest.approx(w.simulated_fps, rel=1e-12)
        assert g.rel_err < 0.10


def test_explore_multi_validate_matches_jax():
    recs = {}
    for name, (c, _, x) in PKGS.items():
        pair = [c.zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
                c.zoo.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1)]
        recs[name] = x.explore_multi(pair, validate=2).validation
    got, want = recs["torch"], recs["jax"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.configs, g.analytic_fps) == (w.configs, w.analytic_fps)
        assert g.simulated_fps == pytest.approx(w.simulated_fps, rel=1e-12)


# -- errors, deprecations and the fault hooks ----------------------------------
def test_lifecycle_errors_match_jax():
    for c, d, _ in PKGS.values():
        dep = d.compile_deployment(c.zoo.tiny_cnn(), d.Strategy.single(1, 1), rounds=2)
        with pytest.raises(RuntimeError, match="use System.load first"):
            d.System().switch(dep)
        with pytest.raises(RuntimeError, match="no deployment loaded"):
            d.System().run()
        with pytest.raises(ValueError, match="no workload for member"):
            d.compile_deployment(None, d.Strategy.single(1, 1))
    pus = [p for p in make_u50_system() if p.pid not in (4, 9)]
    dep = td.compile_deployment(tc.zoo.tiny_cnn(), td.Strategy.single(2, 2), pus=pus, rounds=2)
    with pytest.raises(ValueError, match="different hardware"):
        td.System().load(dep)
    assert td.System(pus=pus).load(dep).run().rounds == 2


def test_tuple_strategy_warns_at_the_caller():
    """The deprecated tuple form warns, attributed to this file (not to a
    ``repro_torch`` frame, which pyproject's filter would make an error)."""
    with pytest.warns(DeprecationWarning, match="tuple") as rec:
        dep = td.compile_deployment(tc.zoo.tiny_cnn(), (1, 1), rounds=2, verify=False)
    assert all(r.filename == __file__ for r in rec)
    assert dep.strategy.configs == ((1, 1),)


def test_fault_hooks_raise_naming_item_16_before_any_work():
    """Formerly the refusal of ``System.inject`` / ``clear_faults``; the
    fault package is copied now, so both run and are held to JAX's: a
    watched run with a token drop from the first stage, then a clean run
    after ``clear_faults``, field for field with the same reports."""
    from repro import faults as jf
    from repro_torch import faults as tf

    def go(c, d, f):
        system = d.System()
        system.watchdog = f.Watchdog()
        dep = d.compile_deployment(c.zoo.tiny_cnn(), d.Strategy.single(1, 1), rounds=2)
        system.load(dep)
        system.inject(f.FaultSchedule(faults=(f.TokenDrop(src_pid=dep.members[0].first_pid),)))
        faulted = system.run()
        system.clear_faults()
        return faulted, system.run(), [str(r) for r in faulted.faults]

    got, want = go(tc, td, tf), go(jc, jd, jf)
    _assert_same_run(got[0], want[0])
    _assert_same_run(got[1], want[1])
    assert got[2] == want[2] and got[2] and "fault-sync-timeout" in " ".join(got[2])
    assert not got[1].faulted and got[1].rounds == 2


def test_exports_match_jax():
    assert td.__all__ == jd.__all__
