"""The port's static program verifier (``repro_torch.verify``) against the
JAX package's ``repro.verify``: on clean deployments of every target of
``python -m repro.verify --quick`` and on each planted defect of
``mutate.py`` the two give the same reports (code, severity, location,
message), the same mutated programs word for word and the same simulations
and runtime detectors over the same trace; the command line prints the same
lines, times aside, with the same exit status."""
import argparse
import dataclasses
import enum
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from test_torch_core_sim import _assert_same  # noqa: E402

import repro.verify as jv  # noqa: E402
import repro.verify.__main__ as jmain  # noqa: E402
import repro.verify.mutate as jmut  # noqa: E402
from repro import deploy as jd  # noqa: E402
from repro.compiler import zoo as jzoo  # noqa: E402
from repro.core.isa import Sync as JSync  # noqa: E402
from repro.core.simulator import MultiPUSimulator as JSim  # noqa: E402
import repro_torch.verify as tv  # noqa: E402
import repro_torch.verify.__main__ as tmain  # noqa: E402
import repro_torch.verify.mutate as tmut  # noqa: E402
from repro_torch import deploy as td  # noqa: E402
from repro_torch.compiler import zoo as tzoo  # noqa: E402
from repro_torch.core.isa import Sync as TSync  # noqa: E402
from repro_torch.core.simulator import MultiPUSimulator as TSim  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PKGS = {"jax": (jzoo, jd, jv, jmut, jmain, JSim, JSync),
        "torch": (tzoo, td, tv, tmut, tmain, TSim, TSync)}
QUICK = argparse.Namespace(quick=True, depth=None, seq_len=None, input_hw=None,
                           decode_steps=None, config=None, rounds=None)


def _plain(x):
    """A value with every dataclass and enum of either package made plain."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def _diags(rep):
    return (rep.label, rep.ok, rep.summary(),
            [(d.code.name, d.severity.name, d.location, d.message, str(d))
             for d in rep.diagnostics])


def _encoded(programs):
    return [(p.pid, p.label, p.encode()) for p in programs]


def _insts(programs):
    """Programs as plain instruction fields (a planted overflow does not encode)."""
    return [(p.pid, p.label, [_plain(i) for i in g.instructions])
            for p in programs for g in (p.ld, p.cp, p.st)]


def _bundle(dep):
    m = dep.members[0]
    return m.compiled.programs, m.compiled.mem, m.compiled.pu_specs


# -- clean: every target of the --quick sweep ----------------------------------
@pytest.mark.parametrize("name", jmain.MODELS)
def test_quick_target_reports_match_jax(name):
    out = {}
    for pkg, (_, d, v, _, main, _, _) in PKGS.items():
        g, strat, rounds, label = main._target(name, QUICK)
        dep = d.compile_deployment(g, strat, rounds=rounds, verify=False)
        out[pkg] = (label, dep, v.verify_deployment(dep))
    (label, dep, rep), (jlabel, jdep, jrep) = out["torch"], out["jax"]
    assert label == jlabel
    assert _encoded(dep.programs()) == _encoded(jdep.programs())
    assert _diags(rep) == _diags(jrep)
    assert rep.ok and not rep.warnings


def test_clean_deployment_simulates_like_jax():
    """verify=True passes on the tiny_cnn target, and the raw simulation's
    result, trace and both runtime detectors equal JAX's (and find nothing)."""
    out = {}
    for pkg, (_, d, _, mut, main, _, _) in PKGS.items():
        g, strat, rounds, _ = main._target("tiny_cnn", QUICK)
        dep = d.compile_deployment(g, strat, rounds=rounds)
        member_of = {p.pid: m.index for m in dep.members for p in m.compiled.programs}
        res, trace = mut.simulate_raw(dep.programs(), dep.pus, trace=True)
        out[pkg] = (res, _plain(trace), mut.runtime_hazards(trace, member_of=member_of),
                    mut.stale_reads(trace))
    (res, trace, hazards, stale), want = out["torch"], out["jax"]
    _assert_same(res, want[0])
    assert trace == want[1] and len(trace) > 100
    assert (hazards, stale) == (want[2], want[3]) == ([], [])
    assert not res.deadlocked


# -- planted defects -----------------------------------------------------------
@pytest.fixture(scope="module")
def deps():
    """tiny_cnn (2,1) at 4 rounds, the encoder (2,2) and the cnn + encoder
    tenant pair at 4 (tests/test_verify.py), per package. The encoder runs 5
    rounds where the JAX package's test runs 8: the shrunk region's stale
    reads show from 5 on, and ``runtime_hazards`` grows with the square of
    the trace."""
    out = {}
    for pkg, (z, d, *_) in PKGS.items():
        enc = z.transformer_encoder(seq_len=64, depth=2)
        pair = d.Strategy.tenants([(d.Workload(z.tiny_cnn(), "cnn"), 1, 1),
                                   (d.Workload(z.transformer_encoder(seq_len=64, depth=2),
                                               "enc"), 1, 1)])
        out[pkg] = {"cnn": d.compile_deployment(z.tiny_cnn(), d.Strategy.single(2, 1), rounds=4),
                    "enc": d.compile_deployment(enc, d.Strategy.single(2, 2), rounds=5),
                    "pair": d.compile_deployment(None, pair, rounds=4)}
    return out


def _mutate(kind, mut, dep):
    """One defect planted by ``mut`` (a package's mutate module): the
    mutation, its static report and the bundles to simulate."""
    programs, mem, specs = _bundle(dep)
    if kind == "overflow_field":  # the intended image and the one hardware runs
        m, truncated = mut.overflow_field(programs)
        bundles = [m.programs, truncated]
    else:  # tid 7: tests/test_verify.py's known shrink_region witness
        m = (mut.shrink_region(programs, mem, tid=7) if kind == "shrink_region"
             else getattr(mut, kind)(programs))
        bundles = [m.programs]
    return m, mut.verify_mutation(m, mem=mem, pu_specs=specs), bundles


CODES = {"drop_send_ack": ("SYNC_TOKEN_STARVE", "HAZ_UNGUARDED_READ"),
         "swap_bids": ("HAZ_BID_MISMATCH",), "shrink_region": ("HAZ_PINGPONG",),
         "overflow_field": ("LINT_FIELD_OVERFLOW",)}


@pytest.mark.parametrize("kind,target", [("drop_send_ack", "cnn"), ("swap_bids", "cnn"),
                                         ("shrink_region", "enc"), ("overflow_field", "cnn")])
def test_mutation_matches_jax(deps, kind, target):
    out = {}
    for pkg, (_, _, _, mut, *_rest) in PKGS.items():
        dep = deps[pkg][target]
        m, rep, bundles = _mutate(kind, mut, dep)
        sims = [mut.simulate_raw(b, dep.pus, trace=True) for b in bundles]
        out[pkg] = (m, rep, bundles, [(res, _plain(trace), mut.runtime_hazards(trace),
                                       mut.stale_reads(trace)) for res, trace in sims])
    (m, rep, bundles, sims), (jm, jrep, jbundles, jsims) = out["torch"], out["jax"]
    assert (m.name, m.detail) == (jm.name, jm.detail)
    assert [_insts(b) for b in bundles] == [_insts(b) for b in jbundles]
    assert _diags(rep) == _diags(jrep)
    assert not rep.ok and all(any(d.code.name == c for d in rep.diagnostics)
                              for c in CODES[kind])
    for (res, trace, hazards, stale), (jres, jtrace, jhazards, jstale) in zip(sims, jsims):
        _assert_same(res, jres)
        assert (trace, hazards, stale) == (jtrace, jhazards, jstale)
    # each defect is also real at runtime, as in the JAX package's tests
    if kind in ("drop_send_ack", "swap_bids"):
        assert sims[0][0].deadlocked
    elif kind == "shrink_region":
        assert sims[0][3]  # stale reads
    else:
        assert sims[0][0].end_cycles != sims[1][0].end_cycles


def test_hijack_channel_matches_jax(deps):
    """The isolation breach: both packages redirect the same store, report
    the same shared channel and overlap, and see the same runtime hazards."""
    out = {}
    for pkg, (_, _, v, mut, *_rest) in PKGS.items():
        dep = deps[pkg]["pair"]
        muts, detail = mut.hijack_channel([m.compiled.programs for m in dep.members])
        rep = v.check_isolation([(f"m{m.index}", progs, m.compiled.mem)
                                 for m, progs in zip(dep.members, muts)])
        member_of = {p.pid: m.index for m, progs in zip(dep.members, muts) for p in progs}
        res, trace = mut.simulate_raw([p for progs in muts for p in progs], dep.pus, trace=True)
        out[pkg] = (detail, [_encoded(p) for p in muts], _diags(rep), res,
                    mut.runtime_hazards(trace, member_of=member_of), mut.stale_reads(trace))
    got, want = out["torch"], out["jax"]
    assert got[:3] == want[:3] and "redirected" in got[0]
    assert {c for c, *_ in got[2][3]} >= {"HAZ_CHANNEL_SHARED", "HAZ_MEMBER_OVERLAP"}
    _assert_same(got[3], want[3])
    assert got[4:] == want[4:] and got[4]


def _sync_sites(programs, sync):
    return [(pi, gname, idx) for pi, pu in enumerate(programs) for gname in ("ld", "cp", "st")
            for idx in range(getattr(pu, gname).progctrl.icu_ba,
                             len(getattr(pu, gname).instructions))
            if isinstance(getattr(pu, gname).instructions[idx], sync)]


def test_every_sync_deletion_reported_as_jax(deps):
    """Deleting any loop-body SEND or WAIT of the tiny_cnn deployment is an
    error, with the same report in both packages."""
    reps = {}
    for pkg, (_, _, v, _, _, _, sync) in PKGS.items():
        programs, mem, specs = _bundle(deps[pkg]["cnn"])
        reps[pkg] = []
        for pi, gname, idx in _sync_sites(programs, sync):
            muts = [p.clone() for p in programs]
            del getattr(muts[pi], gname).instructions[idx]
            reps[pkg].append(_diags(v.verify_programs(muts, mem=mem, pu_specs=specs)))
    assert reps["torch"] == reps["jax"] and len(reps["torch"]) >= 8
    assert not any(ok for _, ok, _, _ in reps["torch"])


def test_deadlock_names_the_blocked_channel_as_jax(deps):
    blocked = {}
    for pkg, (_, _, _, mut, _, sim_cls, _) in PKGS.items():
        dep = deps[pkg]["cnn"]
        sim = sim_cls(dep.pus)
        res = sim.run(mut.drop_send_ack(_bundle(dep)[0]).programs)
        assert res.deadlocked
        blocked[pkg] = [(b.name, b.desc) for b in sim.kernel.blocked_procs()]
    assert blocked["torch"] == blocked["jax"]
    assert any("channel (src_pid=" in desc for _, desc in blocked["torch"])


def test_exports_match_jax():
    assert tv.__all__ == jv.__all__
    assert [c.name for c in tv.Code] == [c.name for c in jv.Code]
    assert [(s.name, s.value) for s in tv.Severity] == [(s.name, s.value) for s in jv.Severity]


def test_command_line_prints_the_jax_lines():
    """``python -m repro_torch.verify --quick`` against ``python -m
    repro.verify --quick``, run side by side: the same lines with the
    compile and verify times masked, the same exit status (0, all clean)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), *filter(None, [os.environ.get("PYTHONPATH")])])}
    procs = {pkg: subprocess.Popen([sys.executable, "-m", f"{pkg}.verify", "--quick"],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True, env=env)
             for pkg in ("repro", "repro_torch")}
    outs = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        outs[pkg] = (proc.returncode, re.sub(r"\d+\.\d\ds", "T", out))
        assert proc.returncode == 0, err[-2000:]
    assert outs["repro_torch"] == outs["repro"]
    lines = outs["repro_torch"][1].splitlines()
    assert len(lines) == 8 and lines[-1] == "OK: 7 target(s) verified clean"
