"""The port's serving control plane (``repro_torch.serve``) against the JAX
package's ``repro.serve``, on the cases of ``tests/test_serve.py``'s
``TestPackedDecode`` (slot-packed decode members: deployments word for word,
simulated runs field for field, within 5 % of the analytic model) and
``TestServer`` (admission, continuous-batching slot reuse, SLO replan and
eviction, join/leave mid-service, incremental re-placement): each scenario
runs through both packages and the event logs, requests, placements and
``RunReport``s are compared field for field. ``tests/test_torch_serve.py``
is the tensor-level ``ServingEngine``'s."""
import dataclasses
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from test_torch_deploy import _assert_same_deployment, _assert_same_run  # noqa: E402
from test_torch_faults import _placement, _server  # noqa: E402

from repro import compiler as jc, deploy as jd, dse as jdse, serve as js, verify as jv  # noqa: E402
from repro_torch import compiler as tc, deploy as td, dse as tdse, serve as ts  # noqa: E402
from repro_torch import verify as tv  # noqa: E402

PKGS = {"jax": SimpleNamespace(c=jc, d=jd, x=jdse, s=js, v=jv),
        "torch": SimpleNamespace(c=tc, d=td, x=tdse, s=ts, v=tv)}
SLOTS = {"classic": None, "one": (64,), "two": (64, 32), "four": (128, 96, 64, 32)}


def _both(fn):
    return {name: fn(p) for name, p in PKGS.items()}


def _decode(p, slots):
    g = (p.c.zoo.transformer_decoder(seq_len=64, decode_steps=8, depth=1) if slots is None
         else p.c.zoo.transformer_decoder(slots=slots, decode_steps=8, depth=1))
    dep = p.d.compile_deployment(g, p.d.Strategy.single(2, 2))
    return dep, p.d.System().load(dep).run()


@pytest.fixture(scope="module")
def packed():
    """The classic decode member and the 1-, 2- and 4-slot packed ones,
    compiled and simulated in both packages."""
    return {k: _both(lambda p: _decode(p, slots)) for k, slots in SLOTS.items()}


class TestPackedDecode:
    @pytest.mark.parametrize("case", sorted(SLOTS))
    def test_deployment_and_run_equal_jax(self, packed, case):
        (dep, rep), (jdep, jrep) = packed[case]["torch"], packed[case]["jax"]
        _assert_same_deployment(dep, jdep)
        _assert_same_run(rep, jrep)
        assert [dataclasses.astuple(m) for m in rep.members] == \
            [dataclasses.astuple(m) for m in jrep.members]

    def test_one_slot_packed_is_bit_identical_to_classic(self, packed):
        assert packed["one"]["torch"][1].aggregate_fps() == pytest.approx(
            packed["classic"]["torch"][1].aggregate_fps(), rel=1e-12)

    @pytest.mark.parametrize("case", ["two", "four"])
    def test_slots_within_5pct_of_analytic(self, packed, case):
        dep, rep = packed[case]["torch"]
        pred = dep.predicted_throughput
        assert not rep.deadlocked
        assert abs(rep.aggregate_fps() - pred) / pred < 0.05

    def test_slot_token_accounting(self, packed):
        rep = packed["two"]["torch"][1]
        (m,) = rep.members
        assert m.n_slots == 2 and m.tokens == 2 * m.rounds
        assert rep.aggregate_token_rate() == pytest.approx(2 * rep.aggregate_fps(), rel=1e-9)

    def test_packed_deployment_is_verifier_clean(self, packed):
        def check(p, dep):
            out = []
            for m in dep.members:
                rep = p.v.verify_programs(m.compiled.programs, mem=m.compiled.mem,
                                          member=m.workload.label)
                out.append((rep.ok, [str(d) for d in rep.diagnostics]))
            return out

        got = {n: check(p, packed["two"][n][0]) for n, p in PKGS.items()}
        assert got["torch"] == got["jax"]
        assert all(ok for ok, _ in got["torch"])


def _served(srv, rep=None):
    out = _server(srv, rep)
    out["tenants"] = sorted(srv._tenants)
    out["generated"] = [r.generated for r in srv.requests]
    return out


class TestServer:
    def test_request_validation(self):
        def go(p):
            srv, errs = p.s.Server(), []
            for call in (lambda: srv.submit(p.s.Request("ghost", prompt_tokens=8,
                                                        max_new_tokens=4)),
                         lambda: srv.join("a", depth=1, window=4),
                         lambda: srv.join("a"),
                         lambda: srv.join("b", window=0),
                         lambda: srv.join("c", max_slots=0),
                         lambda: srv.submit(p.s.Request("a", prompt_tokens=8, max_new_tokens=4)),
                         lambda: srv.leave("a"),  # still has queued work
                         lambda: srv.leave("zed"),
                         lambda: srv.leave("a", force=True),
                         lambda: p.s.Request("a", prompt_tokens=0, max_new_tokens=4),
                         lambda: p.s.Request("a", prompt_tokens=4, max_new_tokens=0)):
                try:
                    call()
                    errs.append(None)
                except (KeyError, ValueError) as e:
                    errs.append((type(e).__name__, str(e)))
            return errs, _served(srv)

        got = _both(go)
        assert got["torch"] == got["jax"]
        errs, srv = got["torch"]
        assert [e and e[0] for e in errs] == ["KeyError", None, "ValueError", "ValueError",
                                              "ValueError", None, "ValueError", "KeyError",
                                              None, "ValueError", "ValueError"]
        assert srv["evicted"] == [True] and srv["completed"] == [False]

    def test_admission_is_fifo_in_tenant_order(self):
        def go(p):
            srv = p.s.Server()
            srv.join("a", depth=1, max_slots=1, window=4)
            srv.join("b", depth=1, max_slots=1, window=4)
            srv.submit(p.s.Request("b", prompt_tokens=32, max_new_tokens=8))   # b-1
            srv.submit(p.s.Request("a", prompt_tokens=32, max_new_tokens=4))   # a-2
            srv.submit(p.s.Request("a", prompt_tokens=16, max_new_tokens=4))   # a-3
            return _served(srv, srv.drain())

        got = _both(go)
        assert got["torch"] == got["jax"]
        admits = [e[3].split()[0] for e in got["torch"]["events"] if e[1] == "admit"]
        assert admits == ["a-2", "b-1", "a-3"] and all(got["torch"]["completed"])

    def test_slot_reuse_matches_separate_runs(self):
        def go(p):
            srv = p.s.Server()
            srv.join("t", depth=1, max_slots=2, window=4)
            reqs = [p.s.Request("t", prompt_tokens=48, max_new_tokens=8),
                    p.s.Request("t", prompt_tokens=24, max_new_tokens=4),
                    p.s.Request("t", prompt_tokens=32, max_new_tokens=4)]
            for r in reqs:
                srv.submit(r)
            rep = srv.drain()
            a, b = srv.placement.config_for("t")
            separate = 0
            for r in reqs:
                g = p.c.zoo.transformer_decoder(seq_len=r.prompt_tokens,
                                                decode_steps=r.max_new_tokens, depth=1)
                dep = p.d.compile_deployment(g, p.d.Strategy.single(a, b))
                separate += p.d.System().load(dep).run().total_tokens
            return _served(srv, rep), separate

        got = _both(go)
        assert got["torch"] == got["jax"]
        srv, separate = got["torch"]
        assert all(srv["completed"]) and srv["generated"] == [8, 4, 4]
        assert srv["windows"] == 2  # r2 retires at the boundary, r3 takes its slot
        assert srv["report"][2]["t"][4] == separate == 16

    def test_slo_violation_replans_then_evicts(self):
        def go(p):
            srv = p.s.Server(slo_patience=2)
            srv.join("lo", depth=1, max_slots=1, window=4,
                     slo=p.d.SLO(min_tokens_per_s=1e12))  # unattainable rate floor
            srv.submit(p.s.Request("lo", prompt_tokens=32, max_new_tokens=32))
            return _served(srv, srv.drain())

        got = _both(go)
        assert got["torch"] == got["jax"]
        srv = got["torch"]
        assert ("replan", "lo", "slo remediation") in [e[1:4] for e in srv["events"]]
        assert "evict" in [e[1] for e in srv["events"]]
        assert srv["evicted"] == [True] and 0 < srv["generated"][0] < 32
        assert srv["report"][2]["lo"][-1] == 0.0  # slo_attainment

    def test_two_tenants_join_leave_mid_service(self):
        def go(p):
            srv = p.s.Server()
            srv.join("alice", depth=1, max_slots=2, window=8)
            srv.join("bob", depth=1, max_slots=2, window=8)
            srv.submit(p.s.Request("alice", prompt_tokens=64, max_new_tokens=12))
            srv.submit(p.s.Request("alice", prompt_tokens=32, max_new_tokens=20))
            srv.submit(p.s.Request("bob", prompt_tokens=48, max_new_tokens=10))
            srv.submit(p.s.Request("bob", prompt_tokens=40, max_new_tokens=8, arrival_s=1e-4))
            first = _served(srv, srv.drain())
            srv.leave("bob")
            srv.submit(p.s.Request("alice", prompt_tokens=16, max_new_tokens=6,
                                   arrival_s=srv.now))
            return first, _served(srv, srv.drain())

        got = _both(go)
        assert got["torch"] == got["jax"]
        first, second = got["torch"]
        assert all(first["completed"]) and all(second["completed"])
        assert sum(t[4] for t in first["report"][2].values()) == 50
        assert second["tenants"] == ["alice"] and "bob" not in second["report"][2]

    def test_incremental_replacement_equals_from_scratch(self):
        def go(p):
            srv = p.s.Server()
            srv.join("a", depth=1, max_slots=1, window=4)
            srv.join("b", depth=1, max_slots=1, window=4)
            srv.submit(p.s.Request("a", prompt_tokens=32, max_new_tokens=16))
            srv.submit(p.s.Request("b", prompt_tokens=32, max_new_tokens=16))
            assert srv.step()  # places {a, b}
            first = _placement(srv.placement)
            srv.join("c", depth=1, max_slots=1, window=4)
            srv.submit(p.s.Request("c", prompt_tokens=24, max_new_tokens=8, arrival_s=srv.now))
            assert srv.step()  # membership change -> incremental replan
            second = _placement(srv.placement)
            replans = [e.kind for e in srv.events].count("replan")
            ws = [srv._tenants[n].workload for n in ("a", "b", "c")]
            scratch = p.x.explore_multi(ws, n_pu1x=srv.n_pu1x, n_pu2x=srv.n_pu2x).balanced
            return first, second, replans, dataclasses.astuple(scratch), _served(srv, srv.drain())

        got = _both(go)
        assert got["torch"] == got["jax"]
        first, second, replans, scratch, srv = got["torch"]
        assert second != first and second[2] == scratch and replans == 2
        assert all(srv["completed"])

    def test_exports_match_jax(self):
        assert ts.__all__ == js.__all__ and ts.MAX_WINDOW == js.MAX_WINDOW
        assert issubclass(ts.DrainStuckError, RuntimeError)
