"""Transformer DSE: the compilation framework beyond CNNs.

The same three-step exploration (Sec. V-A) over the transformer frontend:
ViT-Base/16 (the vision analogue of ResNet-50) or a qwen3-0.6b encoder
stack parameterized from ``repro_torch.configs``. Attention score/context GEMMs
stream their second operand through the SA weight port, FFN matrices SMOF-
stream out of HBM, layernorm/softmax run in the PU vector units — and every
design point deploys and hot-swaps on the fixed U50 machine exactly like
ResNet-50 does.

The twin of the JAX package's ``examples/transformer_dse.py``, with its
arguments and printed lines. It is host code over the port's compiler,
DSE, deploy layer and simulator copy and touches no tensor, so it takes
no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.transformer_dse  # ViT-Base/224
    PYTHONPATH=src python -m repro_torch.examples.transformer_dse --model qwen3 --depth 4
"""
import argparse

from repro_torch.compiler import zoo
from repro_torch.deploy import System
from repro_torch.dse import explore

PEAK_TOPS = 4.608


def build_graph(args):
    if args.model == "vit":
        return zoo.vit(args.input_hw)
    return zoo.transformer_encoder("qwen3-0.6b", seq_len=args.seq_len,
                                   depth=args.depth)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("vit", "qwen3"), default="vit")
    ap.add_argument("--input-hw", type=int, default=224, help="ViT input size")
    ap.add_argument("--seq-len", type=int, default=256, help="qwen3 sequence")
    ap.add_argument("--depth", type=int, default=4,
                    help="qwen3 block count (28 = the full config)")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the deploy/run/switch simulation demo")
    args = ap.parse_args()

    g = build_graph(args)
    gopf = 2 * g.total_macs() / 1e9  # GOPs per frame/sequence
    print(g.summary())
    res = explore(g, tolerance=0.01)

    print(f"step 1: {len(res.single)} single-batch configurations")
    print(f"step 2: {len(res.multi)} multi-batch schedules")
    print(f"step 3: Pareto frontier keeps {len(res.multi_frontier)}\n")

    for name, dp in (("DP-A", res.dp_a), ("DP-B", res.dp_b), ("DP-C", res.dp_c)):
        gops = dp.throughput * gopf
        print(
            f"{name}: batch={dp.batch:2d}  "
            f"fps={dp.throughput:8.1f}  latency={dp.latency*1e3:6.2f} ms  "
            f"CE={gops/(PEAK_TOPS*1e3):.3f}  "
            f"configs={'+'.join(f'({a},{b})' for a, b in dp.configs)}"
        )

    if args.no_sim:
        return

    print("\nruntime strategy switching on one fixed machine:")
    system = System()
    dep_a = res.deploy(res.dp_a, rounds=5)
    sim_a = system.load(dep_a).run()
    dep_c = res.deploy(res.dp_c, rounds=4)
    sim_c = system.switch(dep_c).run()  # same PU array, new programs
    for name, dep, sim in (("DP-A", dep_a, sim_a), ("DP-C", dep_c, sim_c)):
        meas, pred = sim.aggregate_fps(warmup=2), dep.predicted_throughput
        print(
            f"  {name}: measured {meas:8.1f} fps vs predicted {pred:8.1f} "
            f"({abs(meas - pred) / pred * 100:4.1f}% off, "
            f"{dep.batch} member pipeline(s), deadlock={sim.deadlocked})"
        )


if __name__ == "__main__":
    main()
