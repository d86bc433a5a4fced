"""Paper-reproduction benchmarks: one function per table/figure.

  fig2c_isu_latency    -- Fig. 2(c): PU-to-PU control-token latency matrix
  fig3_two_pu_pipeline -- Fig. 3: balanced / consumer-limited / producer-
                          limited pipeline cases on the simulator
  fig6a_single_batch   -- Fig. 6(a): 35 single-batch configs + Pareto front
  fig6b_multi_batch    -- Fig. 6(b): hybrid multi-batch schedules + DP-A/B/C
  table3_comparison    -- Table III: our design points vs prior accelerators
  simulated_design_points -- DP-A/B/C executed on the discrete-event
                          simulator (not just the analytic model)
  transformer_point    -- beyond the paper: the transformer frontend
                          (ViT-Base + qwen3 encoder stack) through the same
                          DSE, with compute efficiency and one simulated run
  multi_tenant_point   -- beyond the paper: FPGA-virtualization-style
                          multi-tenancy — ResNet-50 + ViT co-explored, the
                          max-min-fair split deployed, and a mid-session
                          switch from single-tenant DP-A to the two-tenant
                          deployment with no reconfiguration
  decode_point         -- beyond the paper: autoregressive decode serving —
                          the qwen3 decode graph (growing K/V caches via the
                          AddrLen/CYCLE_LEN length-advance instructions)
                          through the same DSE, one full decode window
                          simulated, and a prefill->decode hot swap

The twin of the JAX package's ``benchmarks/paper_repro.py``: the same
figure functions over the port's compiler, DSE, deploy layer, serving
control plane and simulator copy, with the same rows. Host code on the
simulator's virtual clock (the U50 model of the paper): it touches no
tensor and needs no card. Run as a script for the CI conformance smoke::

    PYTHONPATH=src python -m repro_torch.benchmarks.paper_repro --ci [--out PATH]

(``PATH`` defaults to ``build/BENCH_ci.json`` under the working directory.)
``--ci`` executes a tiny fixed set of deployments (CNN, prefill transformer,
decode transformer), records per-point analytic-vs-simulated prediction
error into a JSON artifact, and exits nonzero if any point exceeds its
conformance tolerance.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..compiler import zoo
from ..core import Group, MultiPUSimulator, latency_matrix, make_u50_system
from ..core.demo import GemmShape, build_two_pu_pipeline
from ..deploy import SLO, Strategy, System, compile_deployment
from ..serve import Request, Server
from ..dse import explore, explore_multi

GOPS_224EQ_PER_FRAME = 7.72  # canonical ResNet-50 GOPs (224x224, Table III)
SYSTEM_PEAK_TOPS = 4.608


def _gopf(g) -> float:
    return 2 * g.total_macs() / 1e9


def fig2c_isu_latency() -> list[str]:
    pus = make_u50_system()
    mat = latency_matrix(pus)
    rows = ["fig2c.header," + ",".join(f"PU{p.pid}" for p in pus)]
    for p, row in zip(pus, mat):
        rows.append(f"fig2c.PU{p.pid}," + ",".join(str(c) for c in row))
    same_slr = [mat[i][j] for i in range(10) for j in range(10)
                if i != j and pus[i].slr == pus[j].slr]
    cross = [mat[i][j] for i in range(10) for j in range(10) if pus[i].slr != pus[j].slr]
    rows.append(f"fig2c.summary,same_pu=2,same_slr={min(same_slr)}-{max(same_slr)},"
                f"cross_slr={min(cross)}-{max(cross)}")
    return rows


def fig3_two_pu_pipeline() -> list[str]:
    shape = GemmShape(m=64, n=1024, k=576)
    big = GemmShape(m=64, n=2048, k=576)
    cases = {
        "case1_balanced": (0, 1, shape, shape),
        "case2_consumer_limited": (0, 1, shape, big),
        "case3_producer_limited": (0, 1, big, shape),
        "heterogeneous_1x_2x": (0, 5, shape, big),
    }
    rows = []
    for name, (pa, pb, sa, sb) in cases.items():
        sim = MultiPUSimulator()
        t0 = time.perf_counter()
        res = sim.run(build_two_pu_pipeline(pa, pb, sa, sb, rounds=12))
        wall_us = (time.perf_counter() - t0) * 1e6
        fps = res.throughput_fps(warmup=3)
        st_wait = res.pu_stats[pa][Group.ST].sync_wait / res.end_cycles
        ld_wait = res.pu_stats[pb][Group.LD].sync_wait / res.end_cycles
        rows.append(
            f"fig3.{name},{wall_us:.0f},fps={fps:.1f};tokens={res.tokens_sent};"
            f"prod_st_wait={st_wait:.2f};cons_ld_wait={ld_wait:.2f}"
        )
    return rows


def fig6a_single_batch(dse=None) -> list[str]:
    g = zoo.resnet50(256)
    dse = dse or explore(g)
    gopf = _gopf(g)
    frontier = {p.config for p in dse.single_frontier}
    rows = []
    for p in sorted(dse.single, key=lambda p: (p.a, p.b)):
        rows.append(
            f"fig6a.cfg_{p.a}_{p.b},,fps224eq={p.fps * gopf / GOPS_224EQ_PER_FRAME:.1f};"
            f"latency_ms={p.latency*1e3:.2f};tops={p.tops:.3f};pbe={p.pbe:.3f};"
            f"pareto={int(p.config in frontier)}"
        )
    return rows


def fig6b_multi_batch(dse=None) -> list[str]:
    g = zoo.resnet50(256)
    dse = dse or explore(g, tolerance=0.01)
    gopf = _gopf(g)
    rows = [f"fig6b.schedules,,count={len(dse.multi)};frontier={len(dse.multi_frontier)}"]
    for name, dp in (("DP-A", dse.dp_a), ("DP-B", dse.dp_b), ("DP-C", dse.dp_c)):
        gops = dp.throughput * gopf
        rows.append(
            f"fig6b.{name},,batch={dp.batch};thr_fps224eq={gops / GOPS_224EQ_PER_FRAME:.1f};"
            f"latency_ms={dp.latency*1e3:.2f};gops={gops:.0f};ce={gops/ (SYSTEM_PEAK_TOPS*1e3):.3f};"
            f"configs={'+'.join(f'{a}x1_{b}x2' for a, b in dp.configs)}"
        )
    return rows


# Table III prior-work rows (FPS/TOPS and GOPS/W taken from the paper) for
# the ratio claims: 1.0-2.7x FPS/TOPS, CE 1.0-1.9x.
PRIOR_WORKS = {
    "DPU_XCU50": dict(fps_per_tops=77.7, ce=0.598),
    "ShortcutFuse": dict(fps_per_tops=47.7, ce=0.561),
    "FullStack": dict(fps_per_tops=120.4, ce=0.927),
    "Rotated": dict(fps_per_tops=94.6, ce=0.732),
    "xDNN": dict(fps_per_tops=65.2, ce=0.502),
    "UnifiedAcc": dict(fps_per_tops=93.0, ce=0.720),
    "Amoeba": dict(fps_per_tops=87.2, ce=0.699),
    "DCP": dict(fps_per_tops=126.9, ce=0.977),
}


def table3_comparison(dse=None) -> list[str]:
    g = zoo.resnet50(256)
    dse = dse or explore(g)
    gopf = _gopf(g)
    rows = []
    points = {
        "DP-A": (dse.dp_a.fps, dse.dp_a.latency, 1),
        "DP-B": (dse.dp_b.throughput, dse.dp_b.latency, dse.dp_b.batch),
        "DP-C": (dse.dp_c.throughput, dse.dp_c.latency, dse.dp_c.batch),
    }
    for name, (thr, lat, batch) in points.items():
        gops = thr * gopf
        fps224 = gops / GOPS_224EQ_PER_FRAME
        fps_per_tops = fps224 / SYSTEM_PEAK_TOPS
        ce = gops / (SYSTEM_PEAK_TOPS * 1e3)
        gops_per_dsp = gops / 3860.0
        rows.append(
            f"table3.{name},,batch={batch};latency_ms={lat*1e3:.2f};fps={fps224:.1f};"
            f"gops={gops:.0f};ce={ce:.3f};gops_per_dsp={gops_per_dsp:.2f};"
            f"fps_per_tops={fps_per_tops:.1f}"
        )
    # headline ratios for DP-B (the paper's focus configuration)
    thr, _, _ = points["DP-B"]
    fps_per_tops_b = thr * gopf / GOPS_224EQ_PER_FRAME / SYSTEM_PEAK_TOPS
    ce_b = thr * gopf / (SYSTEM_PEAK_TOPS * 1e3)
    r_min = min(fps_per_tops_b / w["fps_per_tops"] for w in PRIOR_WORKS.values())
    r_max = max(fps_per_tops_b / w["fps_per_tops"] for w in PRIOR_WORKS.values())
    c_min = min(ce_b / w["ce"] for w in PRIOR_WORKS.values())
    c_max = max(ce_b / w["ce"] for w in PRIOR_WORKS.values())
    rows.append(
        f"table3.ratios_DPB,,fps_per_tops_gain={r_min:.2f}x-{r_max:.2f}x;"
        f"ce_gain={c_min:.2f}x-{c_max:.2f}x (paper: 1.0x-2.7x, 1.0x-1.9x)"
    )
    return rows


def simulated_design_points(dse=None) -> list[str]:
    """Execute DP-A / DP-B / DP-C on one System session: each DSE design
    point compiles to a Deployment (disjoint PUs + HBM channel pools handled
    by the deploy layer) and the strategies are hot-swapped on the same
    fixed machine — the paper's runtime switching, measured."""
    g = zoo.resnet50(256)
    gopf = _gopf(g)
    dse = dse or explore(g)
    system = System()
    rows = []
    measured: dict[str, float] = {}

    plan = [
        ("DP-A_pipeline_all", dse.dp_a, 6),
        ("DP-B_hybrid", dse.dp_b, 5),
        ("DP-C_10_independent", dse.dp_c, 5),
    ]
    for label, point, rounds in plan:
        dep = dse.deploy(point, rounds=rounds)
        system.load(dep) if system.deployment is None else system.switch(dep)
        t0 = time.perf_counter()
        res = system.run()
        wall_us = (time.perf_counter() - t0) * 1e6
        fps = res.aggregate_fps(warmup=2)
        gops = fps * gopf
        measured[label] = fps
        rows.append(
            f"sim.{label},{wall_us:.0f},batch={dep.batch};"
            f"fps224eq={gops/GOPS_224EQ_PER_FRAME:.1f};gops={gops:.0f};"
            f"ce={gops/(SYSTEM_PEAK_TOPS*1e3):.3f};"
            f"latency_ms={res.member_latency_seconds()*1e3:.2f};"
            f"pred_err={abs(fps - dep.predicted_throughput)/dep.predicted_throughput:.3f};"
            f"deadlock={int(res.deadlocked)}"
        )

    # The switching story in one row: DP-A -> DP-C mid-session, both rates
    # measured on the unchanged PU array.
    rows.append(
        "sim.switch_DPA_to_DPC,,"
        f"fps224eq_before={measured['DP-A_pipeline_all'] * gopf / GOPS_224EQ_PER_FRAME:.1f};"
        f"fps224eq_after={measured['DP-C_10_independent'] * gopf / GOPS_224EQ_PER_FRAME:.1f};"
        f"loads={len(system.history)};reconfigured=0"
    )
    return rows


def transformer_point() -> list[str]:
    """The instruction compiler's transformer frontend on the same machine:
    ViT-Base/16 at 224 (the vision analogue of ResNet-50) and a qwen3-0.6b
    encoder stack, each through the full DSE. Reports analytic compute
    efficiency for DP-A/B/C plus one simulated DP-A deployment per graph as
    the conformance anchor."""
    rows = []
    graphs = [
        ("vit_base_224", zoo.vit(224)),
        ("qwen3_enc4_s256", zoo.transformer_encoder("qwen3-0.6b",
                                                    seq_len=256, depth=4)),
    ]
    for gname, g in graphs:
        gopf = _gopf(g)
        dse = explore(g)
        for name, dp in (("DP-A", dse.dp_a), ("DP-B", dse.dp_b), ("DP-C", dse.dp_c)):
            thr = dp.throughput
            gops = thr * gopf
            rows.append(
                f"transformer.{gname}.{name},,batch={dp.batch};"
                f"fps={thr:.1f};gops={gops:.0f};"
                f"ce={gops / (SYSTEM_PEAK_TOPS * 1e3):.3f};"
                f"latency_ms={dp.latency*1e3:.2f}"
            )
        dep = dse.deploy(dse.dp_a, rounds=5)
        t0 = time.perf_counter()
        sim = System().load(dep).run()
        wall_us = (time.perf_counter() - t0) * 1e6
        fps = sim.aggregate_fps(warmup=2)
        rows.append(
            f"transformer.{gname}.sim_DP-A,{wall_us:.0f},fps={fps:.1f};"
            f"ce={fps * gopf / (SYSTEM_PEAK_TOPS * 1e3):.3f};"
            f"pred_err={abs(fps - dep.predicted_throughput) / dep.predicted_throughput:.3f};"
            f"deadlock={int(sim.deadlocked)}"
        )
    return rows


def multi_tenant_point() -> list[str]:
    """Different models for different tenants on one fixed machine: ResNet-50
    and ViT-Base/16 co-explored (`explore_multi`), the max-min-fair joint
    placement compiled as a two-tenant deployment on disjoint PU/HBM slices,
    and a running single-tenant DP-A session hot-swapped to it — new
    instruction programs only, no reconfiguration."""
    g_res, g_vit = zoo.resnet50(256), zoo.vit(224)
    res = explore_multi([g_res, g_vit])
    pick = res.balanced
    rows = [f"mt.joint_space,,points={len(res.points)};pareto={len(res.frontier)}"]
    for i, g in enumerate((g_res, g_vit)):
        a, b = pick.configs[i]
        rows.append(
            f"mt.tenant_{g.name},,config={a}x1_{b}x2;fps={pick.fps[i]:.1f};"
            f"solo_frac={pick.fps[i] / res.best_solo_fps(i):.3f};"
            f"latency_ms={pick.latency[i]*1e3:.2f}"
        )

    system = System()
    best_solo = max(res.singles[0], key=lambda p: p.fps)
    sim_solo = system.load(
        compile_deployment(g_res, Strategy.single(*best_solo.config),
                           rounds=5)).run()
    dep = res.deploy(pick, rounds=4)
    t0 = time.perf_counter()
    sim = system.switch(dep).run()  # same PU array, two tenants now
    wall_us = (time.perf_counter() - t0) * 1e6
    errs = [
        abs(m.throughput_fps(warmup=2) - f) / f
        for m, f in zip(sim.members, pick.fps)
    ]
    tenant_rates = ";".join(
        f"{label}={fps:.1f}" for label, fps in sim.fps_by_workload(warmup=2).items())
    rows.append(
        f"mt.switch_single_to_two_tenant,{wall_us:.0f},"
        f"fps_before={sim_solo.aggregate_fps(warmup=2):.1f};{tenant_rates};"
        f"max_pred_err={max(errs):.3f};deadlock={int(sim.deadlocked)};"
        f"loads={len(system.history)};reconfigured=0"
    )
    return rows


def decode_point() -> list[str]:
    """Autoregressive decode serving on the same machine: the qwen3 decode
    graph (one token per round, K/V caches growing via CYCLE_LEN) through
    the full DSE, DP-A simulated over one complete decode window, and the
    prefill->decode hot swap measured on one fixed PU array."""
    seq, steps, depth = 256, 64, 4
    prefill = zoo.transformer_encoder("qwen3-0.6b", seq_len=seq, depth=depth)
    decode = zoo.transformer_decoder("qwen3-0.6b", seq_len=seq,
                                     decode_steps=steps, depth=depth)
    dse = explore(decode)
    rows = []
    for name, dp in (("DP-A", dse.dp_a), ("DP-B", dse.dp_b), ("DP-C", dse.dp_c)):
        rows.append(
            f"decode.{decode.name}.{name},,batch={dp.batch};"
            f"tok_s={dp.throughput:.1f};latency_ms={dp.latency*1e3:.3f}"
        )

    system = System()
    sim_pre = system.load(compile_deployment(prefill, Strategy.single(2, 2),
                                             rounds=4)).run()
    dep = dse.deploy(dse.dp_a)  # rounds default to the decode window
    t0 = time.perf_counter()
    sim = system.switch(dep).run()
    wall_us = (time.perf_counter() - t0) * 1e6
    tok_s = sim.aggregate_fps(warmup=2)
    rows.append(
        f"decode.switch_prefill_to_decode,{wall_us:.0f},"
        f"prefill_seq_s={sim_pre.aggregate_fps(warmup=2):.1f};"
        f"decode_tok_s={tok_s:.1f};steps={sim.members[0].rounds};"
        f"pred_err={abs(tok_s - dep.predicted_throughput)/dep.predicted_throughput:.3f};"
        f"deadlock={int(sim.deadlocked)};loads={len(system.history)};reconfigured=0"
    )
    return rows


def serving_point() -> list[str]:
    """Online serving control plane: two tenants with different SLOs share
    one machine, their decode sessions continuously batched into slot-packed
    members (per-slot AddrLen streams); a third tenant joins mid-service,
    triggering an incremental re-placement and a hot swap. Reported through
    the unified :class:`repro_torch.deploy.RunReport` schema."""
    srv = Server()
    srv.join("chat", depth=2, max_slots=2, window=8,
             slo=SLO(min_tokens_per_s=100.0, priority=1))
    srv.join("batch", depth=2, max_slots=2, window=8)
    for p, n in ((128, 24), (64, 16), (96, 32)):
        srv.submit(Request("chat", prompt_tokens=p, max_new_tokens=n))
    for p, n in ((256, 32), (192, 16)):
        srv.submit(Request("batch", prompt_tokens=p, max_new_tokens=n))
    srv.step()  # serve one window before the third tenant arrives
    srv.join("burst", depth=2, max_slots=1, window=8)
    srv.submit(Request("burst", prompt_tokens=32, max_new_tokens=16,
                       arrival_s=srv.now))
    t0 = time.perf_counter()
    rep = srv.drain()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for name, t in sorted(rep.tenants.items()):
        attain = ("" if t.slo_attainment is None
                  else f";slo_attain={t.slo_attainment:.2f}")
        rows.append(
            f"serve.tenant_{name},,tok_s={t.token_rate:.1f};"
            f"tokens={t.tokens};p50_ms={t.latency_p50 * 1e3:.2f};"
            f"p95_ms={t.latency_p95 * 1e3:.2f}{attain}"
        )
    kinds = [e.kind for e in srv.events]
    completed = sum(r.completed for r in srv.requests)
    rows.append(
        f"serve.control_plane,{wall_us:.0f},"
        f"windows={srv.windows};swaps={kinds.count('swap')};"
        f"replans={kinds.count('replan')};evictions={kinds.count('evict')};"
        f"completed={completed}/{len(srv.requests)};"
        f"tokens={rep.total_tokens};wall_s={rep.wall_s:.4f}"
    )
    return rows


def run() -> list[str]:
    out = []
    g = zoo.resnet50(256)
    dse = explore(g, tolerance=0.01)
    out += fig2c_isu_latency()
    out += fig3_two_pu_pipeline()
    out += fig6a_single_batch(dse)
    out += fig6b_multi_batch(dse)
    out += table3_comparison(dse)
    out += simulated_design_points(dse)
    out += transformer_point()
    out += multi_tenant_point()
    out += decode_point()
    out += serving_point()
    return out


# ----------------------------------------------------------- CI conformance --
def ci_points() -> list[dict]:
    """Tiny fixed deployments spanning the three frontends (CNN, prefill
    transformer, decode transformer), each simulated on a fresh System and
    scored as analytic-vs-simulated relative error against the same fixed
    tolerances the JAX package's conformance tests lock in."""
    from ..configs import get_config

    dp_c = Strategy.multi([(1, 0)] * 5 + [(0, 1)] * 5)
    plan = [
        # (point name, graph, strategy, rounds override, tolerance)
        ("tiny_cnn.dp_a", zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
         Strategy.single(5, 5), 6, 0.08),
        ("tiny_cnn.dp_c", zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
         dp_c, 5, 0.03),
        # fixed (2,2)+(3,3) hybrid (not the explore-selected DP-B, which the
        # conformance tests lock at 4.5%): observed 5.1%, guarded at 6%
        ("tiny_cnn.hybrid", zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
         Strategy.multi([(2, 2), (3, 3)]), 5, 0.06),
        ("qwen3_enc.dp_a", zoo.transformer_encoder("qwen3-0.6b", seq_len=64,
                                                   depth=1),
         Strategy.single(2, 2), 5, 0.08),
        # decode points tightened 10% -> 5% with the pipeline coupling model
        # (residual serialization, HBM port contention, credit-loop bound)
        ("qwen3_dec.dp_a", zoo.transformer_decoder("qwen3-0.6b", seq_len=64,
                                                   decode_steps=8, depth=4),
         Strategy.single(5, 5), None, 0.05),
        ("qwen3_dec_reduced.dp_c",
         zoo.transformer_decoder(get_config("qwen3-0.6b").reduced(),
                                 seq_len=64, decode_steps=8, depth=4),
         dp_c, None, 0.05),
        # slot-packed decode: two sessions at different cache depths share
        # one member via per-slot AddrLen streams (continuous batching)
        ("qwen3_dec_packed.2slot",
         zoo.transformer_decoder("qwen3-0.6b", slots=(64, 32),
                                 decode_steps=8, depth=1),
         Strategy.single(2, 2), None, 0.05),
        # ten single-node tiny stages: the credit loop binds here — the
        # uncoupled model used to run 15-20% hot on this shape
        ("deep_chain.dp_a", zoo.linear_chain(10, ch=8, hw=8),
         Strategy.single(5, 5), 10, 0.03),
    ]
    points = []
    for name, g, strategy, rounds, tol in plan:
        dep = compile_deployment(g, strategy, rounds=rounds)
        t0 = time.perf_counter()
        sim = System().load(dep).run()
        wall_s = time.perf_counter() - t0
        meas = sim.aggregate_fps(warmup=2)
        pred = dep.predicted_throughput
        err = abs(meas - pred) / pred if pred else float("inf")
        points.append({
            "name": name,
            "graph": g.name,
            "batch": dep.batch,
            "analytic_fps": pred,
            "simulated_fps": meas,
            "rel_err": err,
            "tolerance": tol,
            "deadlocked": sim.deadlocked,
            "ok": (not sim.deadlocked) and err <= tol,
            "sim_wall_s": wall_s,
        })
    return points


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ci", action="store_true",
                    help="tiny conformance smoke: JSON artifact + pass/fail")
    ap.add_argument("--out", default=os.path.join("build", "BENCH_ci.json"),
                    help="artifact path for --ci mode")
    args = ap.parse_args()

    if not args.ci:
        for row in run():
            print(row)
        return 0

    points = ci_points()
    report = {
        "points": points,
        "max_rel_err": max(p["rel_err"] for p in points),
        "ok": all(p["ok"] for p in points),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    for p in points:
        print(f"{p['name']:28s} analytic={p['analytic_fps']:9.1f} "
              f"simulated={p['simulated_fps']:9.1f} err={p['rel_err']:.3f} "
              f"tol={p['tolerance']:.3f} {'ok' if p['ok'] else 'FAIL'}")
    print(f"max_rel_err={report['max_rel_err']:.3f} -> {args.out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
