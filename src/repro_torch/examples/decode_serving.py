"""Autoregressive decode serving: KV-cache scheduling through the ISA,
compiler and deploy stack.

``zoo.transformer_decoder`` models the decode half of a serving workload:
one program round = one new token, attention score/context GEMMs stream a
per-block K/V cache region whose valid prefix *grows* every round (the
AddrLen/CYCLE_LEN length-advance instructions, cf. the paper's AddrCyc
cyclic addressing). The graph flows through the unchanged DSE and deploy
stack, and a running :class:`repro_torch.deploy.System` hot-swaps between the
prefill tenant and the decode tenant with no reconfiguration — the paper's
runtime strategy switching applied to the two phases of LLM serving.

The twin of the JAX package's ``examples/decode_serving.py``, with its
arguments and printed lines. It is host code over the port's compiler,
DSE, deploy layer and simulator copy and touches no tensor, so it takes
no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.decode_serving           # full
    PYTHONPATH=src python -m repro_torch.examples.decode_serving --small   # CI
    PYTHONPATH=src python -m repro_torch.examples.decode_serving --no-sim  # analytic
"""
import argparse

from repro_torch.compiler import zoo
from repro_torch.deploy import Strategy, System, compile_deployment
from repro_torch.dse import explore


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--seq-len", type=int, default=256,
                    help="prefill prefix length (K/V cache base rows)")
    ap.add_argument("--steps", type=int, default=64,
                    help="decode window (one program round per token)")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes + few simulated steps (CI smoke mode)")
    ap.add_argument("--no-sim", action="store_true",
                    help="analytic DSE only, skip the simulated hot swap")
    args = ap.parse_args()
    if args.small:
        args.seq_len, args.steps, args.depth = 64, 8, 4

    prefill = zoo.transformer_encoder(args.arch, seq_len=args.seq_len,
                                      depth=args.depth)
    decode = zoo.transformer_decoder(args.arch, seq_len=args.seq_len,
                                     decode_steps=args.steps, depth=args.depth)
    print(f"prefill: {prefill.summary()}")
    print(f"decode:  {decode.summary()}")
    print(f"decode round = 1 token; cache grows {args.seq_len}+1 .. "
          f"{args.seq_len + args.steps} rows over the window\n")

    # --- the decode workload through the unchanged 3-step DSE ---------------
    res = explore(decode)
    print("decode design points (analytic; fps = tokens/s per sequence):")
    for name, dp in (("DP-A", res.dp_a), ("DP-B", res.dp_b), ("DP-C", res.dp_c)):
        print(f"  {name}: batch={dp.batch} tok/s={dp.throughput:9.1f} "
              f"latency_ms={dp.latency * 1e3:7.3f} "
              f"configs={'+'.join(f'{a}x1_{b}x2' for a, b in dp.configs)}")
    if args.no_sim:
        return

    # --- prefill tenant -> decode tenant on one fixed machine ---------------
    dep_pre = compile_deployment(prefill, Strategy.single(2, 2), rounds=4)
    dep_dec = res.deploy(res.dp_a)  # rounds default to the decode window

    system = System()
    sim_pre = system.load(dep_pre).run()
    print(f"\nprefill deployment (2,2): {sim_pre.aggregate_fps(warmup=2):.1f} "
          f"seq/s, deadlock={sim_pre.deadlocked}")

    sim_dec = system.switch(dep_dec).run()  # same PU array, new programs
    meas = sim_dec.aggregate_fps(warmup=2)
    pred = dep_dec.predicted_throughput
    print(f"switched to decode DP-A (no reconfiguration, "
          f"loads={len(system.history)}):")
    print(f"  {meas:.1f} tok/s measured over {sim_dec.members[0].rounds} "
          f"decode steps   analytic {pred:.1f} tok/s   "
          f"({abs(meas - pred) / pred * 100:.1f}% off), "
          f"deadlock={sim_dec.deadlocked}")

    back = system.switch(dep_pre).run()  # and back to prefill
    print(f"switched back to prefill: {back.aggregate_fps(warmup=2):.1f} "
          f"seq/s (loads={len(system.history)}, reconfigured=0)")


if __name__ == "__main__":
    main()
