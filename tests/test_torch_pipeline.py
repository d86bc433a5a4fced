"""The port's pipeline runtime against the JAX package's: the analytic layer
cost, the stage plan, the ISA stage programs (word for word, and run on the
JAX package's discrete-event simulator), the stage restacking, and the
executor's logits against JAX ``tf.forward`` on the CPU, where its tokens
are flags and a WAIT on a token that was never sent raises. The CUDA-stream
executor is checked on a card (tests/test_torch_gpu.py)."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _parity import jax_tree, numpy_params  # noqa: E402
from repro.configs import all_configs, get_config as jget  # noqa: E402
from repro.core import MultiPUSimulator  # noqa: E402
from repro.core.isa import Group as JaxGroup  # noqa: E402
from repro.core.program import Program as JaxProgram, PUProgram as JaxPUProgram  # noqa: E402
from repro.core.pu import PUSpec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import pipeline as jpp  # noqa: E402
from repro_torch import bridge, hw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Group, Opcode, Program, Sync  # noqa: E402
from repro_torch.runtime import pipeline as pp  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_runtime.py MULTIDEV_SCRIPT
ARCH = "h2o-danube-3-4b"
PLANS = [(1, 8), (3, 4), (4, 6), (4, 8)]


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_layer_cost_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for seq, batch, chips in [(2048, 4, 1), (512, 1, 2), (8192, 2, 4)]:
        got = pp.layer_cost_seconds(cfg, seq, batch, chips, peak_flops=jpp.PEAK_FLOPS,
                                    hbm_bw=jpp.HBM_BW)
        assert got == jpp.layer_cost_seconds(jcfg, seq, batch, chips)


def test_layer_cost_defaults_to_the_h100_fp32_rates():
    cfg = get_config(ARCH)
    assert pp.layer_cost_seconds(cfg, 4608, 1) == pp.layer_cost_seconds(
        cfg, 4608, 1, peak_flops=hw.FP32_FLOPS, hbm_bw=hw.HBM_BYTES_PER_S)
    assert pp.layer_cost_seconds(cfg, 4608, 1) != jpp.layer_cost_seconds(jget(ARCH), 4608, 1)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", ARCH])
@pytest.mark.parametrize("S,M", PLANS)
def test_plan_and_programs_match_jax(arch, S, M):
    kw = dict(n_stages=S, microbatches=M, seq_len=1024, microbatch_size=2)
    got, want = pp.plan_pipeline(get_config(arch), **kw), jpp.plan_pipeline(jget(arch), **kw)
    assert got.boundaries == want.boundaries
    assert (got.n_stages, got.microbatches, got.layers_per_stage) == (
        want.n_stages, want.microbatches, want.layers_per_stage)
    assert got.stage_time_s == got.layers_per_stage * pp.layer_cost_seconds(
        get_config(arch), 1024, 2)
    assert len(got.programs) == len(want.programs) == S
    for g, w in zip(got.programs, want.programs):
        g.validate()
        assert g.encode() == w.encode()  # word for word
        assert (g.pid, g.label) == (w.pid, w.label)
        assert [p.name for p in (g.ld, g.cp, g.st)] == [p.name for p in (w.ld, w.cp, w.st)]


def _as_jax(pu):
    """A port PUProgram decoded from its words into the JAX package's classes."""
    return JaxPUProgram(pu.pid, *(JaxProgram.decode(JaxGroup(p.group.value), p.encode(), p.name)
                                  for p in (pu.ld, pu.cp, pu.st)), label=pu.label)


def _simulate(plan):
    pus = [PUSpec(pid=i, kind="PU2x", sa_rows=64, sa_cols=8, slr=i // 2)
           for i in range(plan.n_stages)]
    return MultiPUSimulator(pus).run([_as_jax(p) for p in plan.programs], first_pid=0,
                                     last_pid=plan.n_stages - 1)


def test_programs_simulate_deadlock_free_at_full_width():
    """tests/test_runtime.py::test_stage_programs_validate_and_simulate on
    the port's programs."""
    plan = pp.plan_pipeline(get_config("qwen3-0.6b"), n_stages=4, microbatches=6,
                            seq_len=1024, microbatch_size=2)
    res = _simulate(plan)
    assert not res.deadlocked
    assert res.rounds == 6


def _setup(num_layers=None, seed=0):
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    if num_layers is not None:
        jcfg, cfg = replace(jcfg, num_layers=num_layers), replace(cfg, num_layers=num_layers)
    tree = numpy_params(jcfg, seed)
    return jcfg, cfg, tree


def _run(cfg, tree, S, M, mb, s, seed):
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    params = bridge.params_from_numpy(tree, device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (M * mb, s)).astype(np.int32)
    fn = pp.make_pipeline_forward(cfg, plan, device="cpu")
    out = fn(pp.stack_stage_params(cfg, params, plan),
             torch.from_numpy(toks).long().reshape(M, mb, s))
    return plan, fn, toks, out


def _want_counts(S, M):
    """Per non-first stage M x (WAIT_REQ + SEND_ACK) and the 2 prologue
    SEND_ACKs; per non-last stage M x (WAIT_ACK + SEND_REQ)."""
    return [{"WAIT_REQ": M * (i > 0), "SEND_ACK": (M + 2) * (i > 0),
             "WAIT_ACK": M * (i < S - 1), "SEND_REQ": M * (i < S - 1)} for i in range(S)]


@pytest.mark.parametrize("L,S", [(4, 4), (5, 3), (5, 4), (4, 3)])
def test_executor_matches_jax_forward(L, S):
    """Reduced h2o-danube-3-4b, s = 96 beyond its window 64. At (5, 4) and
    (4, 3) the JAX split (stage i runs layers i*lps ...) differs from
    plan.boundaries and the last stage runs one layer or none; at (5, 3) and
    (4, 4) they agree. The logits are the same either way."""
    M, mb, s = 2, 2, 96
    jcfg, cfg, tree = _setup(num_layers=L)
    plan, fn, toks, out = _run(cfg, tree, S, M, mb, s, seed=1)
    want, _ = jtf.forward(jcfg, jax_tree(tree), {"tokens": jnp.asarray(toks)})
    assert out.shape == (M, mb, s, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.reshape(M * mb, s, -1).numpy(), np.asarray(want), **TOL)
    lps = plan.layers_per_stage
    split = [min(i * lps, L) for i in range(S)] + [L]
    assert (split != plan.boundaries) == ((L, S) in [(5, 4), (4, 3)])
    assert fn.counts == pp.program_sync_counts(plan) == _want_counts(S, M)
    assert fn.stage_ms == [[] for _ in range(S)]  # device times only on the card


def test_executor_tokens_match_the_simulator():
    """The executor performs the token operations the simulator sends: on the
    port's programs, decoded into the JAX package's classes, the simulator
    drains every round with no deadlock and sends as many tokens as the
    executor's SEND_REQ and SEND_ACK."""
    S, M = 4, 6
    _, cfg, tree = _setup()
    plan, fn, _, _ = _run(cfg, tree, S, M, mb=1, s=16, seed=2)
    res = _simulate(plan)
    assert not res.deadlocked and res.rounds == M
    sends = sum(c["SEND_REQ"] + c["SEND_ACK"] for c in fn.counts)
    assert res.tokens_sent == sends == (S - 1) * (2 * M + 2)


# the group whose span holds each token operation's span
_SYNC_GROUP = {"WAIT_REQ": "LD", "SEND_ACK": "LD", "WAIT_ACK": "ST", "SEND_REQ": "ST"}


def test_executor_spans_under_a_profiler():
    """Under a CPU-only profiler the executor opens one ``pipeline.<op>``
    span a token operation of ``program_sync_counts``, each inside a span of
    its group, and one ``pipeline.LD`` / ``.CP`` / ``.ST`` span a group's
    pass (the prologue's LD on every stage but the first)."""
    S, M = 4, 2
    _, cfg, tree = _setup()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        plan, fn, _, _ = _run(cfg, tree, S, M, mb=1, s=16, seed=2)
    spans = [(e.name.removeprefix("pipeline."), e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("pipeline.")]
    names = [n for n, _, _ in spans]
    want = pp.program_sync_counts(plan)
    for op in pp.SYNC_OPS:
        assert names.count(op) == sum(c[op] for c in want) > 0, op
    assert (names.count("LD"), names.count("CP"), names.count("ST")) == (
        S * M + S - 1, S * M, S * M)
    groups = {g: [(t0, t1) for n, t0, t1 in spans if n == g] for g in ("LD", "ST")}
    for op, t0, t1 in spans:
        if op in _SYNC_GROUP:
            assert any(g0 <= t0 and t1 <= g1 for g0, g1 in groups[_SYNC_GROUP[op]]), op


def test_spans_are_off_without_a_profiler(monkeypatch):
    """With no profiler recording, ``span`` hands out one shared null context
    and never enters ``record_function``."""
    from repro_torch.runtime import spans

    assert spans.span("pipeline.LD") is spans.span("serve.step")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, cfg, tree = _setup()
    plan, fn, _, _ = _run(cfg, tree, 3, 2, mb=1, s=16, seed=2)
    assert fn.counts == pp.program_sync_counts(plan)


def test_stack_stage_params_matches_jax():
    for L, S in [(4, 4), (5, 3), (5, 4)]:
        jcfg, cfg, tree = _setup(num_layers=L)
        kw = dict(n_stages=S, microbatches=2, seq_len=16, microbatch_size=1)
        want = jax.tree.map(np.asarray, jpp.stack_stage_params(
            jcfg, jax_tree(tree), jpp.plan_pipeline(jcfg, **kw)))
        got = bridge.params_to_numpy(pp.stack_stage_params(
            cfg, bridge.params_from_numpy(tree, device="cpu"), pp.plan_pipeline(cfg, **kw)))
        jax.tree.map(np.testing.assert_array_equal, got, want)
        assert jax.tree.structure(got) == jax.tree.structure(want)


def _broken(plan, stage, ld_ops, loop_ba):
    plan.programs[stage].ld = Program.assemble(Group.LD, ld_ops, rounds=plan.microbatches,
                                               loop_ba=loop_ba, name=f"stage{stage}.LD")
    return plan


def test_wait_on_a_token_never_sent_raises():
    """Two broken programs: stage 1 without its ACK-bypass prologue (stage 0
    then waits for an ACK nobody sent), and stage 1 with a WAIT_REQ that does
    not cycle its BID (its second round waits on B0 again, which stage 0 sent
    once)."""
    _, cfg, tree = _setup()
    params = bridge.params_from_numpy(tree, device="cpu")
    kw = dict(n_stages=4, microbatches=2, seq_len=16, microbatch_size=1)
    toks = torch.zeros((2, 1, 16), dtype=torch.long)

    plan = pp.plan_pipeline(cfg, **kw)
    body = plan.programs[1].ld.instructions[2:-1]  # the loop body, without the prologue
    plan = _broken(plan, 1, body, loop_ba=0)
    with pytest.raises(RuntimeError, match="WAIT on ACK 1->0 B0, which was not sent"):
        pp.make_pipeline_forward(cfg, plan, device="cpu")(pp.stack_stage_params(
            cfg, params, plan), toks)

    plan = pp.plan_pipeline(cfg, **kw)
    ops = plan.programs[1].ld.instructions[:-1]
    assert ops[2].op == Opcode.WAIT_REQ
    ops[2] = Sync(op=Opcode.WAIT_REQ, pid=0, bid=0, nc=0)
    plan = _broken(plan, 1, ops, loop_ba=2)
    with pytest.raises(RuntimeError, match="WAIT on REQ 0->1 B0, which was not sent"):
        pp.make_pipeline_forward(cfg, plan, device="cpu")(pp.stack_stage_params(
            cfg, params, plan), toks)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b", "gemma3-4b", "dbrx-132b",
                                  "internvl2-76b"])
def test_other_stacks_are_refused_by_name(arch):
    cfg = get_config(arch).reduced()
    plan = pp.plan_pipeline(cfg, n_stages=2, microbatches=2, seq_len=16, microbatch_size=1)
    with pytest.raises(ValueError, match="ROADMAP queue 3: uniform dense stacks only"):
        pp.make_pipeline_forward(cfg, plan, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP queue 3: uniform dense stacks only"):
        pp.stack_stage_params(cfg, {"blocks": []}, plan)


def test_device_none_means_cuda_and_tokens_are_checked():
    cfg = get_config(ARCH).reduced()
    plan = pp.plan_pipeline(cfg, n_stages=2, microbatches=2, seq_len=16, microbatch_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pp.make_pipeline_forward(cfg, plan)
    fn = pp.make_pipeline_forward(cfg, plan, device="cpu")
    with pytest.raises(ValueError, match="M = 2"):
        fn({}, torch.zeros((3, 1, 16), dtype=torch.long))
