"""Design-space exploration on ResNet-50 (paper Sec. V-A, Figs. 5/6):
enumerate 35 single-batch configs, compose hybrid multi-batch schedules,
Pareto-filter, print the DP-A/B/C design points with Table III metrics —
then make them *executable*: every DSE point deploys with one call
(``res.deploy(...)``) and a :class:`repro_torch.deploy.System` session runs DP-A
and hot-switches to DP-C on the same fixed machine, reporting measured vs
predicted throughput for both.

The twin of the JAX package's ``examples/resnet50_dse.py``, with its
arguments and printed lines. It is host code over the port's compiler,
DSE, deploy layer and simulator copy and touches no tensor, so it takes
no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.resnet50_dse [--max-latency-ms 20]
"""
import argparse

from repro_torch.compiler import zoo
from repro_torch.deploy import System
from repro_torch.dse import constrained, explore

GOPS_224EQ = 7.72
PEAK_TOPS = 4.608


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-latency-ms", type=float, default=None)
    ap.add_argument("--min-fps", type=float, default=None)
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the deploy/run/switch simulation demo")
    args = ap.parse_args()

    g = zoo.resnet50(256)
    gopf = 2 * g.total_macs() / 1e9
    res = explore(g, tolerance=0.01)

    print(f"step 1: {len(res.single)} single-batch configurations")
    print(f"step 2: {len(res.multi)} multi-batch schedules")
    print(f"step 3: Pareto frontier keeps {len(res.multi_frontier)}\n")

    for name, dp in (("DP-A", res.dp_a), ("DP-B", res.dp_b), ("DP-C", res.dp_c)):
        gops = dp.throughput * gopf
        print(
            f"{name}: batch={dp.batch:2d}  "
            f"fps(224eq)={gops/GOPS_224EQ:6.1f}  latency={dp.latency*1e3:5.2f} ms  "
            f"CE={gops/(PEAK_TOPS*1e3):.3f}  "
            f"configs={'+'.join(f'({a},{b})' for a, b in dp.configs)}"
        )

    if args.max_latency_ms or args.min_fps:
        lim = constrained(
            res.multi,
            max_latency=(args.max_latency_ms or 1e9) / 1e3,
            min_throughput=(args.min_fps or 0.0) / (gopf / GOPS_224EQ),
        )
        best = max(lim, key=lambda s: s.throughput) if lim else None
        print(f"\nconstrained pick ({len(lim)} feasible):", best and best.configs)

    print("\nthroughput-latency frontier (multi-batch):")
    for s in sorted(res.multi_frontier, key=lambda s: s.latency)[:12]:
        gops = s.throughput * gopf
        print(
            f"  batch={s.batch:2d} fps={gops/GOPS_224EQ:6.1f} "
            f"lat={s.latency*1e3:5.2f} ms tops={s.tops:.2f} pbe={s.system_pbe:.3f}"
        )

    if args.no_sim:
        return

    # ---- deploy / run / switch: the DSE points as executable programs ------
    print("\nruntime strategy switching on one fixed machine:")
    system = System()
    dep_a = res.deploy(res.dp_a, rounds=6)
    sim_a = system.load(dep_a).run()
    dep_c = res.deploy(res.dp_c, rounds=5)
    sim_c = system.switch(dep_c).run()  # same PU array, new programs
    for name, dep, sim in (("DP-A", dep_a, sim_a), ("DP-C", dep_c, sim_c)):
        meas, pred = sim.aggregate_fps(warmup=2), dep.predicted_throughput
        print(
            f"  {name}: measured {meas * gopf / GOPS_224EQ:6.1f} fps(224eq) "
            f"vs predicted {pred * gopf / GOPS_224EQ:6.1f} "
            f"({abs(meas - pred) / pred * 100:4.1f}% off, "
            f"{dep.batch} member pipeline(s), deadlock={sim.deadlocked})"
        )


if __name__ == "__main__":
    main()
