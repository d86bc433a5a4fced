"""The port's copy of the event simulator (``repro_torch.core``: events, pu,
isu, icu, simulator) against the JAX package's ``repro.core``, field for
field and exactly: the same programs (the port's pipeline plans, and the
paper's Fig. 3 two-PU programs, each encoded in one package and decoded in
the other) give the same end cycle, tokens, rounds, deadlock verdict,
member latencies, per-PU group statistics and blocked processes. The fault
hooks of the copy raise until the fault package is copied."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from repro import core as jcore  # noqa: E402
from repro.core.demo import GemmShape, build_two_pu_pipeline  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime import pipeline as pp  # noqa: E402

PLANS = [(1, 8), (3, 4), (4, 6), (4, 8)]  # tests/test_torch_pipeline.py
ROUNDS = 12  # tests/test_two_pu_pipeline.py
SHAPE = GemmShape(m=64, n=1024, k=576)
BIG = GemmShape(m=64, n=2048, k=576)
FIG3 = {"balanced": (0, 1, SHAPE, SHAPE), "consumer-limited": (0, 1, SHAPE, BIG),
        "producer-limited": (0, 1, BIG, SHAPE), "heterogeneous": (0, 5, SHAPE, BIG)}


def _convert(pu, to):
    """A PUProgram encoded in one package and decoded into ``to``'s classes."""
    return to.PUProgram(pu.pid, *(to.Program.decode(to.Group(p.group.value), p.encode(), p.name)
                                  for p in (pu.ld, pu.cp, pu.st)), label=pu.label)


def _stage_pus(mod, n):
    return [mod.PUSpec(pid=i, kind="PU2x", sa_rows=64, sa_cols=8, slr=i // 2) for i in range(n)]


def _stats(res):
    return {pid: {g.name: dataclasses.asdict(st) for g, st in groups.items()}
            for pid, groups in res.pu_stats.items()}


def _assert_same(got, want):
    assert got.end_cycles == want.end_cycles
    assert got.tokens_sent == want.tokens_sent
    assert got.rounds == want.rounds
    assert got.deadlocked == want.deadlocked
    assert got.round_latencies_cycles == want.round_latencies_cycles
    assert got.round_end_cycles == want.round_end_cycles
    assert [(m.rounds, m.end_cycles, m.round_latencies_cycles, m.round_end_cycles)
            for m in got.members] == [(m.rounds, m.end_cycles, m.round_latencies_cycles,
                                       m.round_end_cycles) for m in want.members]
    assert _stats(got) == _stats(want)
    assert [tuple(b) for b in got.blocked] == [tuple(b) for b in want.blocked]
    assert got.throughput_fps() == want.throughput_fps()
    assert got.latency_seconds() == want.latency_seconds()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-3-4b"])
@pytest.mark.parametrize("S,M", PLANS)
def test_pipeline_plans_simulate_equal(arch, S, M):
    plan = pp.plan_pipeline(get_config(arch), n_stages=S, microbatches=M, seq_len=1024,
                            microbatch_size=2)
    member = dict(first_pid=0, last_pid=S - 1, label="lm", pids=tuple(range(S)))
    got = core.MultiPUSimulator(_stage_pus(core, S)).run(
        plan.programs, members=[core.PipelineMember(**member)])
    want = jcore.MultiPUSimulator(_stage_pus(jcore, S)).run(
        [_convert(p, jcore) for p in plan.programs], members=[jcore.PipelineMember(**member)])
    _assert_same(got, want)
    assert not got.deadlocked and got.rounds == M
    sends = sum(c["SEND_REQ"] + c["SEND_ACK"] for c in pp.program_sync_counts(plan))
    assert got.tokens_sent == sends


@pytest.mark.parametrize("case", sorted(FIG3))
def test_fig3_two_pu_programs_simulate_equal(case):
    """The Fig. 3 programs of ``repro.core.demo`` on the default U50 system."""
    pid_a, pid_b, a, b = FIG3[case]
    programs = build_two_pu_pipeline(pid_a, pid_b, a, b, rounds=ROUNDS)
    got = core.simulate([_convert(p, core) for p in programs])
    want = jcore.simulate(programs)
    _assert_same(got, want)
    assert got.tokens_sent == 2 * ROUNDS + 2 and not got.deadlocked


def test_deadlock_blocks_the_same_processes():
    """Stage 1 without its ACK-bypass prologue: stage 0's ST waits for an
    ACK nobody sends; both simulators park the same decoders, with the same
    descriptions, at the same cycles."""
    plan = pp.plan_pipeline(get_config("h2o-danube-3-4b").reduced(), n_stages=3,
                            microbatches=4, seq_len=64, microbatch_size=1)
    ld = plan.programs[1].ld
    plan.programs[1].ld = core.Program.assemble(core.Group.LD, ld.instructions[2:-1], rounds=4,
                                                loop_ba=0, name=ld.name)
    got = core.MultiPUSimulator(_stage_pus(core, 3)).run(plan.programs)
    want = jcore.MultiPUSimulator(_stage_pus(jcore, 3)).run(
        [_convert(p, jcore) for p in plan.programs])
    _assert_same(got, want)
    assert got.deadlocked and got.blocked
    assert any("WAIT_ACK" in b.desc for b in got.blocked)


def test_system_model_is_the_same():
    got, want = core.make_u50_system(), jcore.make_u50_system()
    assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    assert core.system_peak_tops(got) == jcore.system_peak_tops(want)
    assert core.latency_matrix(got) == jcore.latency_matrix(want)
    assert [[core.token_latency_cycles(s, d) for d in got] for s in got] == \
        core.latency_matrix(got)
    assert core.MultiPUSimulator().peak_tops == jcore.MultiPUSimulator().peak_tops


def test_reset_switches_programs_on_the_same_machine():
    """examples/pipeline_parallel.py's strategy switch: after ``reset`` a
    re-planned schedule runs on the same simulated machine, as in JAX."""
    cfg = get_config("h2o-danube-3-4b").reduced()
    sims = core.MultiPUSimulator(_stage_pus(core, 4)), jcore.MultiPUSimulator(_stage_pus(jcore, 4))
    for S in (4, 2):
        plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=4, seq_len=32, microbatch_size=1)
        for sim in sims:
            sim.reset()
        got = sims[0].run(plan.programs, members=[core.PipelineMember(0, S - 1, f"{S}stg")])
        want = sims[1].run([_convert(p, jcore) for p in plan.programs],
                           members=[jcore.PipelineMember(0, S - 1, f"{S}stg")])
        _assert_same(got, want)
        assert got.members[0].throughput_fps() == want.members[0].throughput_fps()


def test_fault_hooks_raise_until_the_fault_package_is_copied():
    sim = core.MultiPUSimulator()
    programs = [_convert(p, core) for p in build_two_pu_pipeline(0, 1, SHAPE, SHAPE, rounds=2)]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 16"):
        sim.inject(object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 16"):
        sim.clear_faults()
    with pytest.raises(NotImplementedError, match="watchdog"):
        sim.run(programs, watchdog=object())
    res = sim.run(programs)  # the refusals left the simulator as it was
    assert not res.deadlocked and res.rounds == 2 and res.faults == []
