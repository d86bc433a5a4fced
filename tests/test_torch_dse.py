"""The port's DSE (``repro_torch.dse``) against the JAX package's: ``explore``,
``explore_multi`` and ``plan_placement`` per engine at tolerance 0 and 0.01
(port against JAX on the same engine, never one engine against another);
the float64 torch scoring backend on the CPU against the port's numpy
backend; the H100-pool deployment DSE with the JAX package's v5e constants
injected against ``tpu_deploy``; deploying, simulating and validating design
points against the JAX package's; and what the port refuses (the ``jax``
backend, a missing card). Small graphs only."""
import dataclasses
import inspect
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from repro import compiler as jc, deploy as jd, dse as jdse  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.dse import tpu_deploy  # noqa: E402
from repro.runtime import pipeline as jpipeline  # noqa: E402
from repro_torch import compiler as tc, dse as tdse, hw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pu import make_u50_system  # noqa: E402
from repro_torch.deploy import Strategy  # noqa: E402
from repro_torch.dse import batched, gpu_deploy  # noqa: E402
from repro_torch.benchmarks import gpu_dse  # noqa: E402

GRAPHS = {
    "tiny_cnn": lambda z: z.tiny_cnn(channels=(16, 32, 32), hw=16),
    "qwen3_enc": lambda z: z.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1),
    "qwen3_dec": lambda z: z.transformer_decoder("qwen3-0.6b", seq_len=64,
                                                 decode_steps=8, depth=2),
}
FIELDS = ("fps", "latency", "tops", "pbe", "round_seconds", "uncoupled_seconds",
          "binding_bound")
TPU_ARCHS = ["qwen3-0.6b", "h2o-danube-3-4b", "starcoder2-15b", "internvl2-76b"]


def _t(xs):
    return [dataclasses.astuple(x) for x in xs]


def _result(r):
    return (_t(r.single), _t(r.multi), _t(r.single_frontier), _t(r.multi_frontier),
            _t([r.dp_a, r.dp_b, r.dp_c]))


def _pool(n1, n2):
    """``n1`` PU1x on SLR 0 and ``n2`` PU2x on SLR 1, as ``make_u50_system``
    builds the U50's 5 + 5."""
    u50 = {p.kind: p for p in make_u50_system()}
    return ([dataclasses.replace(u50["PU1x"], pid=i, slr=0) for i in range(n1)]
            + [dataclasses.replace(u50["PU2x"], pid=n1 + i, slr=1) for i in range(n2)])


# -- explore / explore_multi / plan_placement: port == JAX, per engine --------
@pytest.mark.parametrize("tol", [0.0, 0.01])
@pytest.mark.parametrize("engine,name", [
    ("batched", "tiny_cnn"), ("batched", "qwen3_enc"), ("batched", "qwen3_dec"),
    ("scalar", "tiny_cnn"), ("scalar", "qwen3_dec"), ("reference", "tiny_cnn"),
])
def test_explore_matches_jax(engine, name, tol):
    rj = jdse.explore(GRAPHS[name](jc.zoo), tolerance=tol, engine=engine)
    rt = tdse.explore(GRAPHS[name](tc.zoo), tolerance=tol, engine=engine)
    assert _result(rt) == _result(rj)


@pytest.mark.parametrize("tol", [0.0, 0.01])
@pytest.mark.parametrize("engine", ["batched", "scalar", "reference"])
def test_explore_multi_matches_jax(engine, tol):
    names = ["tiny_cnn", "qwen3_enc"]
    rj = jdse.explore_multi([GRAPHS[n](jc.zoo) for n in names], tolerance=tol,
                            engine=engine)
    rt = tdse.explore_multi([GRAPHS[n](tc.zoo) for n in names], tolerance=tol,
                            engine=engine)
    assert [_t(s) for s in rt.singles] == [_t(s) for s in rj.singles]
    assert _t(rt.points) == _t(rj.points)
    assert _t(rt.frontier) == _t(rj.frontier)
    assert dataclasses.astuple(rt.balanced) == dataclasses.astuple(rj.balanced)
    assert rt.fingerprints == rj.fingerprints


def test_incremental_explore_multi_and_plan_placement_match_jax():
    def run(dse, z):
        base = dse.explore_multi([GRAPHS["tiny_cnn"](z), GRAPHS["qwen3_enc"](z)])
        swapped = dse.explore_multi(
            [GRAPHS["tiny_cnn"](z), GRAPHS["qwen3_dec"](z)], prev=base)
        solo = dse.plan_placement([GRAPHS["qwen3_enc"](z)])
        pair = dse.plan_placement([GRAPHS["tiny_cnn"](z), GRAPHS["qwen3_dec"](z)],
                                  prev=swapped, available=[0, 1, 2, 5, 6, 7])
        return (_t(swapped.frontier), dataclasses.astuple(swapped.balanced),
                solo.configs, dataclasses.astuple(solo.point),
                pair.configs, dataclasses.astuple(pair.point), _t(pair.result.frontier))

    assert run(tdse, tc.zoo) == run(jdse, jc.zoo)


def test_explore_stats_move_as_jax():
    def run(c, dse, z):
        c.clear_analysis_cache()
        c.STATS.reset()
        dse.explore(GRAPHS["qwen3_enc"](z))
        dse.explore(GRAPHS["qwen3_enc"](z), engine="scalar")
        return c.STATS.snapshot()

    assert run(tc, tdse, tc.zoo) == run(jc, jdse, jc.zoo)


# -- the torch scoring backend on the CPU against the numpy backend -----------
@pytest.mark.parametrize("pool", [(5, 5), (16, 16)], ids=["u50", "16+16"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_torch_backend_matches_numpy(name, pool):
    pus = make_u50_system() if pool == (5, 5) else _pool(*pool)
    an = tc.analyze(GRAPHS[name](tc.zoo), pus)
    configs = [(a, b) for a in range(pool[0] + 1) for b in range(pool[1] + 1) if a + b]
    ref = batched.score_details(an, configs, pus=pus)
    got = batched.score_details(an, configs, pus=pus, backend="torch", device="cpu")
    assert got.configs == ref.configs
    for f in FIELDS:
        a = getattr(got, f)
        assert isinstance(a, np.ndarray) and a.dtype == np.float64, f
        np.testing.assert_allclose(a, getattr(ref, f), rtol=1e-9, atol=1e-12, err_msg=f)


def test_torch_backend_without_edges_returns_the_numpy_result():
    an = tc.analyze(tc.zoo.linear_chain(n_convs=1))
    assert an.tables().n_edges == 0
    configs = [(1, 0), (0, 1), (1, 1), (2, 0)]
    ref = batched.score_details(an, configs)
    got = batched.score_details(an, configs, backend="torch", device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert (batched.score_single_batch(an, configs, backend="torch", device="cpu")
            == batched.score_single_batch(an, configs))


def test_backend_jax_is_unknown_and_device_none_needs_a_card(monkeypatch):
    an = tc.analyze(GRAPHS["tiny_cnn"](tc.zoo))
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        batched.score_details(an, [(1, 1)], backend="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = tc.STATS.batched_score_calls
    with pytest.raises(RuntimeError, match="CUDA"):
        batched.score_details(an, [(1, 1)], backend="torch")
    assert tc.STATS.batched_score_calls == calls  # raised before any work


def test_numpy_is_the_default_backend():
    for fn in (batched.score_details, batched.score_single_batch):
        assert inspect.signature(fn).parameters["backend"].default == "numpy"
    assert inspect.signature(tdse.explore).parameters["engine"].default == "batched"


# -- the H100-pool deployment DSE ---------------------------------------------
@pytest.mark.parametrize("arch", TPU_ARCHS)
def test_gpu_deploy_with_the_jax_constants_equals_tpu_deploy(arch):
    kw = dict(seq_len=4096, microbatch=4, microbatches=8)
    want = tpu_deploy.enumerate_deployments(jget(arch), chips=256, **kw)
    got = gpu_deploy.enumerate_deployments(
        get_config(arch), cards=256, link_bw=tpu_deploy.ICI_BW, budget=14e9,
        peak_flops=jpipeline.PEAK_FLOPS, hbm_bw=jpipeline.HBM_BW, **kw)
    assert _t(got) == _t(want)
    assert [d.label for d in got] == [d.label for d in want]
    pj, fj = tpu_deploy.explore_tpu(jget(arch), chips=64)
    pt, ft = gpu_deploy.explore_gpu(
        get_config(arch), cards=64, link_bw=tpu_deploy.ICI_BW, budget=14e9,
        peak_flops=jpipeline.PEAK_FLOPS, hbm_bw=jpipeline.HBM_BW)
    assert (_t(pt), _t(ft)) == (_t(pj), _t(fj))


def test_gpu_deploy_defaults_are_the_h100s():
    params = inspect.signature(gpu_deploy.enumerate_deployments).parameters
    assert {k: params[k].default for k in
            ("cards", "link_bw", "budget", "peak_flops", "hbm_bw")} == {
        "cards": 8, "link_bw": hw.NVLINK_BYTES_PER_S, "budget": hw.DEPLOY_BUDGET_BYTES,
        "peak_flops": hw.BF16_TENSOR_FLOPS, "hbm_bw": hw.HBM_BYTES_PER_S}
    assert hw.NVLINK_BYTES_PER_S == 450e9 and hw.HBM_CAPACITY_BYTES == 80e9
    assert hw.DEPLOY_BUDGET_BYTES < hw.HBM_CAPACITY_BYTES
    cfg = get_config("internvl2-76b")
    pts = gpu_deploy.enumerate_deployments(cfg)
    # 152 GB of bf16 weights fit no single card: every deployment shards them
    assert pts and all(p.stages * p.tensor >= 2 for p in pts)
    assert all(p.stages * p.replicas * p.tensor == 8 for p in pts)


def test_gpu_dse_rows():
    rows = gpu_dse.run()
    assert [r.split(",")[0] for r in rows] == [f"gpu_dse.{a}" for a in TPU_ARCHS]
    assert all(",,deployments=" in r and "hybrid_gain_vs_pipeline=" in r for r in rows)


# -- deploying a design point ------------------------------------------------
def test_deploy_simulate_and_validate_raise_before_any_work():
    """``res.deploy`` / ``simulate``, ``multi.deploy`` / ``simulate`` and
    ``validate=N`` run and equal the JAX package's (programs word for word,
    simulated rates and validation records); codegen runs only at deploy
    (``explore`` leaves ``codegen_calls`` and ``memory_plan_calls`` as they
    were, a deploy adds to them, both packages' counters move alike); and
    what deploy refuses, a point that does not fit the machine or a result
    without a graph, it refuses before any codegen."""
    def run(c, d, z, strategy):
        c.clear_analysis_cache()
        c.STATS.reset()
        g, enc = GRAPHS["tiny_cnn"](z), GRAPHS["qwen3_enc"](z)
        res, multi = d.explore(g), d.explore_multi([g, enc])
        snaps = [c.STATS.snapshot()]
        deps = [res.deploy(res.dp_a, rounds=4), res.deploy(res.dp_c, rounds=4),
                multi.deploy(multi.balanced, rounds=4)]
        snaps.append(c.STATS.snapshot())
        sims = [res.simulate(res.dp_b, rounds=4), multi.simulate(multi.balanced, rounds=4)]
        snaps.append(c.STATS.snapshot())
        for bad in (lambda: res.deploy(strategy.multi([(5, 5), (5, 5)])),
                    lambda: dataclasses.replace(res, graph=None).deploy(res.dp_a)):
            with pytest.raises(ValueError):
                bad()
        snaps.append(c.STATS.snapshot())
        val = (d.explore(g, validate=2, validate_rounds=4).validation,
               d.explore_multi([g, enc], validate=2).validation)
        return (snaps, [[(p.pid, p.encode()) for p in dep.programs()] for dep in deps],
                [(sim.aggregate_fps(warmup=2), sim.fps_by_workload(warmup=2), sim.end_cycles,
                  sim.deadlocked) for sim in sims],
                [_t(v) for v in val])

    got, want = run(tc, tdse, tc.zoo, Strategy), run(jc, jdse, jc.zoo, jd.Strategy)
    assert got == want
    snaps = got[0]
    assert snaps[0]["codegen_calls"] == snaps[0]["memory_plan_calls"] == 0
    assert snaps[1]["codegen_calls"] > 0 and snaps[2]["codegen_calls"] > snaps[1]["codegen_calls"]
    assert snaps[3] == snaps[2]  # the refusals ran no phase
    assert [len(v) for v in got[3]] == [2, 2]
    assert all(not sim[3] for sim in got[2])


def test_deprecated_forms_warn_at_the_caller_and_do_not_error():
    g = GRAPHS["tiny_cnn"](tc.zoo)
    # under the suite's filters ("error" for warnings from repro*): a warning
    # attributed to a repro_torch frame would raise here
    tdse.explore(g, engine="fast")
    Strategy.of(((1, 0), (0, 1)))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tdse.explore(g, engine="fast")
        Strategy.of(((1, 0), (0, 1)))
    assert [w.category for w in rec] == [DeprecationWarning] * 2
    assert [w.filename for w in rec] == [__file__] * 2
    assert _result(tdse.explore(g, engine="fast")) == _result(tdse.explore(g))
