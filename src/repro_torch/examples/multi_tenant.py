"""Multi-tenant deployments: different models for different tenants on one
fixed machine (FPGA-virtualization style, cf. arXiv:2003.12101) — the
paper's Sec. V deployment machinery generalized so every member pipeline
carries its own :class:`repro_torch.deploy.Workload`.

The co-exploration (``explore_multi``) searches joint placements of the
tenants on the shared PU array and Pareto-filters by the vector of
per-tenant rates; any point compiles to an executable two-tenant deployment
on disjoint PU/HBM slices, and a running single-tenant session hot-swaps to
it mid-session — new instruction programs only, no reconfiguration.

The twin of the JAX package's ``examples/multi_tenant.py``, with its
arguments and printed lines. It is host code over the port's compiler,
DSE, deploy layer and simulator copy and touches no tensor, so it takes
no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant          # ResNet-50 + ViT
    PYTHONPATH=src python -m repro_torch.examples.multi_tenant --small  # tiny pair (CI)
"""
import argparse

from repro_torch.compiler import zoo
from repro_torch.deploy import Strategy, System, compile_deployment
from repro_torch.dse import explore_multi


def tenant_graphs(small: bool):
    if small:
        return (zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
                zoo.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1))
    return zoo.resnet50(256), zoo.vit(224)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny tenant pair (fast; used by the CI smoke job)")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    g_a, g_b = tenant_graphs(args.small)
    print(f"tenant A: {g_a.name}   tenant B: {g_b.name}\n")

    # --- co-exploration: joint placements of both tenants -------------------
    res = explore_multi([g_a, g_b])
    print(f"joint placements: {len(res.points)}, "
          f"Pareto frontier (fps_A, fps_B): {len(res.frontier)}")
    solo = [res.best_solo_fps(i) for i in range(2)]
    print(f"best solo rates (whole machine to itself): "
          f"A {solo[0]:.1f} fps, B {solo[1]:.1f} fps\n")
    for p in sorted(res.frontier, key=lambda p: -p.fps[0])[:10]:
        (a0, b0), (a1, b1) = p.configs
        print(f"  A({a0},{b0}) {p.fps[0]:9.1f} fps ({p.fps[0]/solo[0]*100:5.1f}% of solo)"
              f"   B({a1},{b1}) {p.fps[1]:9.1f} fps ({p.fps[1]/solo[1]*100:5.1f}% of solo)")

    pick = res.balanced
    print(f"\nmax-min-fair point: {pick}")

    # --- a running single-tenant session hot-swaps to the two-tenant split --
    best_a = max(res.singles[0], key=lambda p: p.fps)
    dep_solo = compile_deployment(g_a, Strategy.single(*best_a.config),
                                  rounds=args.rounds + 1)
    dep_two = res.deploy(pick, rounds=args.rounds)

    system = System()
    sim_solo = system.load(dep_solo).run()
    print(f"\nsingle-tenant DP-A ({g_a.name} on {best_a.config}): "
          f"{sim_solo.aggregate_fps(warmup=2):.1f} fps, "
          f"deadlock={sim_solo.deadlocked}")

    sim_two = system.switch(dep_two).run()  # same PU array, new programs
    print(f"switched to two-tenant split (no reconfiguration, "
          f"loads={len(system.history)}):")
    rates = sim_two.fps_by_workload(warmup=2)
    for (label, meas), pred in zip(rates.items(), pick.fps):
        print(f"  {label:24s} measured {meas:9.1f} fps   "
              f"analytic {pred:9.1f} fps   ({abs(meas - pred)/pred*100:4.1f}% off)")
    print(f"  deadlock={sim_two.deadlocked}, "
          f"members={[m.label for m in sim_two.members]}")


if __name__ == "__main__":
    main()
