"""The pipeline executor across processes (``repro_torch.runtime.
pipeline_ranks``), one stage a rank over gloo on the CPU (2 to 4 processes,
one thread each): its logits against JAX ``tf.forward`` (the JAX pipeline
itself fails under jax 0.9.0, ROADMAP queue 3) and against the one-card
``PipelineForward``, its token operations against the programs and the
simulator copy, each rank's params, the broken programs of
tests/test_torch_pipeline.py raising across processes (the BID mix-up by the
REQ header, the missing ACK by the WAIT's timeout), and the refusals. Every
spawn is bounded by ``timeout_s``."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax.numpy as jnp  # noqa: E402

from _parity import jax_tree, numpy_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import pipeline as jpp  # noqa: E402
from repro_torch import bridge, core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Group, Opcode, Program, Sync  # noqa: E402
from repro_torch.runtime import pipeline as pp  # noqa: E402
from repro_torch.runtime import pipeline_ranks as pr  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_runtime.py MULTIDEV_SCRIPT
ONE_CARD_TOL = dict(rtol=1e-6, atol=1e-6)
ARCH = "h2o-danube-3-4b"
SPAWN_S = 180.0  # bound of one spawn_stages call
BROKEN_WAIT_S = 5.0  # a WAIT's timeout where a message never comes


def _setup(num_layers=None, arch=ARCH, seed=0):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    if num_layers is not None:
        jcfg, cfg = replace(jcfg, num_layers=num_layers), replace(cfg, num_layers=num_layers)
    return jcfg, cfg, numpy_params(jcfg, seed)


def _spawn(cfg, plan, params, tokens, wait_timeout_s=60.0, timeout_s=SPAWN_S):
    sp = pp.stack_stage_params(cfg, params, plan)
    slices = pr.PerRank([pr.stage_slice(cfg, sp, plan, r) for r in range(plan.n_stages)])
    return pr.spawn_stages(plan.n_stages, pr.forward_rank, cfg, plan, slices, tokens,
                           wait_timeout_s, device="cpu", timeout_s=timeout_s)


def _tokens(cfg, M, mb, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (M * mb, s)).astype(np.int32)
    return toks, torch.from_numpy(toks).long().reshape(M, mb, s)


def _sends(counts):
    return sum(c["SEND_REQ"] + c["SEND_ACK"] for c in counts)


@pytest.mark.parametrize("L,S", [(4, 4), (5, 3), (5, 4), (4, 3)])
def test_ranks_match_jax_forward_and_the_one_card_executor(L, S):
    """Reduced h2o-danube-3-4b at s = 96, beyond its window 64, the cases of
    tests/test_torch_pipeline.py::test_executor_matches_jax_forward (at (5, 4)
    and (4, 3) the JAX split leaves the last rank one layer or none)."""
    M, mb, s = 2, 2, 96
    jcfg, cfg, tree = _setup(num_layers=L)
    params = bridge.params_from_numpy(tree, device="cpu")
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    toks, tokens = _tokens(cfg, M, mb, s, seed=1)
    res = _spawn(cfg, plan, params, tokens)

    assert [r["logits"] is None for r in res] == [True] * (S - 1) + [False]
    out = res[-1]["logits"]
    assert out.shape == (M, mb, s, cfg.vocab_size) and out.dtype == torch.float32
    want, _ = jtf.forward(jcfg, jax_tree(tree), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(out.reshape(M * mb, s, -1).numpy(), np.asarray(want), **TOL)
    one = pp.make_pipeline_forward(cfg, plan, device="cpu")(
        pp.stack_stage_params(cfg, params, plan), tokens)
    np.testing.assert_allclose(out.numpy(), one.numpy(), **ONE_CARD_TOL)

    assert [r["counts"] for r in res] == pp.program_sync_counts(plan)
    assert [r["stage_ms"] for r in res] == [[] for _ in range(S)]  # device times on the card
    for i, r in enumerate(res):  # a D2H where a REQ leaves, a recv and an H2D where one arrives
        kinds = [m[0] for m in r["messages"]]
        assert kinds.count("d2h") == M * (i < S - 1)
        assert kinds.count("send_recv") == kinds.count("h2d") == M * (i > 0)
        assert all(ms >= 0 for _, _, ms in r["messages"])


def test_ranks_send_the_simulator_copys_tokens():
    """4 ranks, 6 microbatches: B0/B1 cycle three times over, and each rank's
    operations are the programs'; the port's simulator sends as many tokens
    as the ranks' SEND_REQs and SEND_ACKs, and drains every round."""
    S, M = 4, 6
    _, cfg, tree = _setup()
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=16, microbatch_size=1)
    res = _spawn(cfg, plan, bridge.params_from_numpy(tree, device="cpu"),
                 _tokens(cfg, M, 1, 16, seed=2)[1])
    counts = [r["counts"] for r in res]
    assert counts == pp.program_sync_counts(plan)
    pus = [core.PUSpec(pid=i, kind="PU2x", sa_rows=64, sa_cols=8, slr=i // 2) for i in range(S)]
    sim = core.MultiPUSimulator(pus).run(plan.programs, first_pid=0, last_pid=S - 1)
    assert not sim.deadlocked and sim.rounds == M
    assert sim.tokens_sent == _sends(counts) == (S - 1) * (2 * M + 2)


def test_plan_predictions_are_the_jax_plans():
    """``predicted_throughput`` and ``predicted_latency`` (the example's
    analytic line) are the JAX plan's properties, here at the H100 rates."""
    plan = pp.plan_pipeline(get_config(ARCH), n_stages=4, microbatches=6, seq_len=1024,
                            microbatch_size=2)
    assert plan.predicted_throughput == jpp.PipelinePlan.predicted_throughput.fget(plan) > 0
    assert plan.predicted_latency == jpp.PipelinePlan.predicted_latency.fget(plan) > 0


@pytest.mark.parametrize("arch,L,S", [(ARCH, 5, 4), (ARCH, 4, 2), ("qwen3-0.6b", 3, 2)])
def test_stage_slice_holds_only_its_stage(arch, L, S):
    """Rank r: its stage's (lps, ...) block leaves, views of the restacked
    params; embed on the first rank, final_norm and the head (lm_head, or the
    tied embed) on the last; nothing else."""
    _, cfg, tree = _setup(num_layers=L, arch=arch)
    params = bridge.params_from_numpy(tree, device="cpu")
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=2, seq_len=16, microbatch_size=1)
    sp = pp.stack_stage_params(cfg, params, plan)
    lps, head = plan.layers_per_stage, "embed" if cfg.tie_embeddings else "lm_head"
    for r in range(S):
        got = pr.stage_slice(cfg, sp, plan, r)
        want = {"blocks"} | ({"embed"} if r == 0 else set()) | (
            {"final_norm", head} if r == S - 1 else set())
        assert set(got) == want
        for name in want - {"blocks"}:
            assert got[name] is sp[name]
        for leaf, full in zip(tree_leaves(got["blocks"][0]), tree_leaves(params["blocks"][0])):
            assert leaf.shape == (lps, *full.shape[1:])
            n = max(0, min(lps, L - r * lps))
            torch.testing.assert_close(leaf[:n], full[r * lps:r * lps + n], rtol=0, atol=0)
            assert not leaf[n:].any()  # the zero padding of a ragged last stage
            if S * lps == L:  # no padding: a view of the params, nothing copied
                assert leaf.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match=f"rank {S} of {S} stages"):
        pr.stage_slice(cfg, sp, plan, S)
    with pytest.raises(ValueError, match="stack_stage_params"):
        pr.stage_slice(cfg, params, plan, 0)


def _broken_no_prologue(plan):
    """Stage 1 without its ACK-bypass prologue: stage 0 waits for an ACK
    nobody sends."""
    body = plan.programs[1].ld.instructions[2:-1]
    plan.programs[1].ld = Program.assemble(Group.LD, body, rounds=plan.microbatches,
                                           loop_ba=0, name="stage1.LD")
    return plan


def _broken_bid(plan):
    """Stage 1's WAIT_REQ does not cycle its BID: its second round waits on
    B0 while stage 0 sends B1."""
    ops = plan.programs[1].ld.instructions[:-1]
    assert ops[2].op == Opcode.WAIT_REQ
    ops[2] = Sync(op=Opcode.WAIT_REQ, pid=0, bid=0, nc=0)
    plan.programs[1].ld = Program.assemble(Group.LD, ops, rounds=plan.microbatches, loop_ba=2,
                                           name="stage1.LD")
    return plan


@pytest.mark.parametrize("broken,match", [
    (_broken_no_prologue, "WAIT on ACK 1->0 B0 timed out after 5 s"),
    (_broken_bid, "REQ 0->1 carried B1, the program waits on B0"),
])
def test_broken_programs_raise_across_processes(broken, match):
    """The broken programs of tests/test_torch_pipeline.py, four ranks: the
    call raises with the failing ranks' tracebacks, within the WAITs'
    timeout, and leaves no process behind."""
    _, cfg, tree = _setup()
    plan = broken(pp.plan_pipeline(cfg, n_stages=4, microbatches=2, seq_len=16,
                                   microbatch_size=1))
    with pytest.raises(RuntimeError, match=match) as err:
        _spawn(cfg, plan, bridge.params_from_numpy(tree, device="cpu"),
               torch.zeros((2, 1, 16), dtype=torch.long), wait_timeout_s=BROKEN_WAIT_S)
    assert "ranks failed" in str(err.value) and "Traceback" in str(err.value)
    assert not torch.multiprocessing.active_children()


def test_a_call_past_its_timeout_terminates_every_rank():
    """A program whose WAIT would block for a minute, in a call bounded at a
    few seconds: every rank is terminated and the call raises."""
    _, cfg, tree = _setup()
    plan = _broken_no_prologue(pp.plan_pipeline(cfg, n_stages=2, microbatches=2, seq_len=16,
                                                microbatch_size=1))
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 still running"):
        _spawn(cfg, plan, bridge.params_from_numpy(tree, device="cpu"),
               torch.zeros((2, 1, 16), dtype=torch.long), wait_timeout_s=120.0, timeout_s=8.0)
    assert not torch.multiprocessing.active_children()


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b", "gemma3-4b", "dbrx-132b",
                                  "internvl2-76b"])
def test_other_stacks_are_refused_by_name(arch):
    cfg = get_config(arch).reduced()
    plan = pp.plan_pipeline(cfg, n_stages=2, microbatches=2, seq_len=16, microbatch_size=1)
    with pytest.raises(ValueError, match="ROADMAP queue 3: uniform dense stacks only"):
        pr.RankPipelineForward(cfg, plan, 0, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP queue 3: uniform dense stacks only"):
        pr.stage_slice(cfg, {"blocks": []}, plan, 0)


def test_device_none_means_cuda_and_the_group_is_checked():
    cfg = get_config(ARCH).reduced()
    plan = pp.plan_pipeline(cfg, n_stages=2, microbatches=2, seq_len=16, microbatch_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pr.spawn_stages(2, pr.forward_rank, device=None)
        with pytest.raises(RuntimeError, match="CUDA"):
            pr.RankPipelineForward(cfg, plan, 0)
    with pytest.raises(RuntimeError, match="no process group"):
        pr.RankPipelineForward(cfg, plan, 0, device="cpu")
    with pytest.raises(ValueError, match="nccl runs on cards"):
        pr.spawn_stages(2, pr.forward_rank, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="2 items for 3 ranks"):
        pr.spawn_stages(3, pr.forward_rank, pr.PerRank([0, 1]), device="cpu")
