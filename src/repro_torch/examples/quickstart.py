"""Quickstart: compile ResNet-50 into multi-PU instruction programs and
execute them on the discrete-event simulator — the paper's core loop
(Sec. IV compilation -> Sec. III coordination -> Sec. V performance).

The twin of the JAX package's ``examples/quickstart.py``, with its
arguments and printed lines. It is host code over the port's compiler,
DSE, deploy layer and simulator copy and touches no tensor, so it takes
no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--pu1x 2 --pu2x 3]
"""
import argparse

from repro_torch.compiler import compile_model, zoo
from repro_torch.core import simulate


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pu1x", type=int, default=5)
    ap.add_argument("--pu2x", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()

    g = zoo.resnet50(256)
    print(g.summary())

    cm = compile_model(g, args.pu1x, args.pu2x, rounds=args.rounds)
    print(f"\ncompiled to {len(cm.programs)} pipeline stages:")
    for s in cm.part.stages:
        if not s.nids:
            continue
        pid = cm.pid_map[s.index]
        print(
            f"  stage {s.index} -> PU{pid} ({s.pu_kind}): {len(s.nids)} nodes, "
            f"{cm.stage_times[s.index]*1e3:.2f} ms/round "
            f"({cm.programs[s.index].total_instructions()} instructions)"
        )
    print(f"\npredicted: {cm.predicted_fps:.1f} fps, PBE {cm.pbe():.3f}")

    last = max(s.index for s in cm.part.stages if s.nids)
    res = simulate(cm.programs, first_pid=cm.pid_map[0], last_pid=cm.pid_map[last])
    fps = res.throughput_fps(warmup=2)
    gops = 2 * cm.graph.total_macs() * fps / 1e9
    print(
        f"simulated: {fps:.1f} fps | {gops:.0f} GOPS | "
        f"CE {gops / (cm.used_tops * 1e3):.3f} vs used PUs | "
        f"latency {res.latency_seconds()*1e3:.2f} ms | "
        f"{res.tokens_sent} REQ/ACK tokens | deadlock={res.deadlocked}"
    )

    # peek at one instruction program
    print("\nfirst stage LD program:")
    print(cm.programs[0].ld.disassemble())


if __name__ == "__main__":
    main()
