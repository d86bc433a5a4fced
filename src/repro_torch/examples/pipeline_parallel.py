"""The paper's coordination technique across processes, the twin of
``examples/pipeline_parallel.py``: pipeline an LM over ranks with
compiler-emitted instruction programs, check the schedule on the port's
copy of the discrete-event simulator, execute one stage a rank (the REQ/ACK
tokens as messages between processes), and switch strategy (pipeline depth)
on the same simulated machine. Runs on the card unless ``--device cpu`` is
given; the ranks talk over gloo, so every rank fits on one card.

    PYTHONPATH=src python -m repro_torch.examples.pipeline_parallel --device cpu
"""
import argparse

import torch

from repro_torch import hw, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import MultiPUSimulator, PipelineMember, PUSpec
from repro_torch.models import transformer as tf
from repro_torch.runtime.pipeline import layer_cost_seconds, plan_pipeline, stack_stage_params
from repro_torch.runtime.pipeline_ranks import PerRank, forward_rank, spawn_stages, stage_slice

POOL = 8  # cards in the analytic sweep: one H100 node


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    dev = resolve_device(args.device)
    B, S = 4, 32
    mb = B // args.microbatches

    # --- step 1: the compiler plans the pipeline + emits ISA programs ------
    plan = plan_pipeline(cfg, n_stages=args.stages, microbatches=args.microbatches,
                         seq_len=S, microbatch_size=mb)
    print(f"plan: {plan.n_stages} stages x {plan.layers_per_stage} layers, "
          f"boundaries {plan.boundaries}")
    print(f"analytic (H100 fp32 rates): {plan.predicted_throughput:.1f} microbatches/s, "
          f"latency {plan.predicted_latency * 1e6:.2f} us")
    print("\nstage 1 instruction programs (coordination expressed in the ISA):")
    print(plan.programs[1].ld.disassemble())

    # --- step 2: check the schedule on the discrete-event simulator --------
    pus = [PUSpec(pid=i, kind="PU2x", sa_rows=64, sa_cols=8, slr=i // 2)
           for i in range(args.stages)]
    sim = MultiPUSimulator(pus)
    member = PipelineMember(first_pid=0, last_pid=args.stages - 1, label="lm")
    res = sim.run(plan.programs, members=[member])
    mres = res.members[0]
    print(f"\nsimulator: {mres.rounds} microbatches drained, "
          f"{mres.throughput_fps(warmup=1):.1f} microbatches/s, "
          f"deadlock={res.deadlocked}, {res.tokens_sent} REQ/ACK tokens")

    # --- step 3: execute one stage a rank, tokens as messages --------------
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    sparams = stack_stage_params(cfg, params, plan)
    slices = PerRank([stage_slice(cfg, sparams, plan, r) for r in range(args.stages)])
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.microbatches, mb, S), generator=gen)
    ranks = spawn_stages(args.stages, forward_rank, cfg, plan, slices, toks,
                         backend="gloo", device=dev)
    out = ranks[-1]["logits"]
    ref, _ = tf.forward(cfg, params, {"tokens": toks.reshape(B, S).to(dev)})
    err = float((out.reshape(B, S, -1) - ref.cpu()).abs().max())
    sends = sum(r["counts"]["SEND_REQ"] + r["counts"]["SEND_ACK"] for r in ranks)
    print(f"\nrank execution ({args.stages} processes over gloo on {dev}): logits "
          f"{tuple(out.shape)}, max |delta| vs plain forward = {err:.2e}; "
          f"{sends} REQ/ACK messages sent (the simulator's {res.tokens_sent})")
    for i, r in enumerate(ranks):
        print(f"  rank {i}: {r['counts']}")

    # --- step 4: strategy switching without reconfiguration ----------------
    # 4a. On the simulator: the PU array is fixed; sim.reset() clears only
    # the transient ICU/ISU state and a re-planned instruction schedule with
    # fewer stages runs on the same machine.
    print("\nruntime switching on the fixed simulated machine:")
    for n_stages in sorted({args.stages, max(1, args.stages // 2)}, reverse=True):
        alt = plan_pipeline(cfg, n_stages=n_stages, microbatches=args.microbatches,
                            seq_len=S, microbatch_size=mb)
        sim.reset()
        r = sim.run(alt.programs,
                    members=[PipelineMember(0, n_stages - 1, f"{n_stages}stg")])
        print(f"  stages={n_stages}: {r.members[0].throughput_fps(warmup=1):8.1f} "
              f"microbatches/s measured (deadlock={r.deadlocked})")

    # 4b. On a node of H100s: the same trade-off, analytically, at the port's
    # fp32 rates (hw.py).
    full = get_config(args.arch)
    print(f"\nanalytic deployment sweep ({POOL} cards at {hw.FP32_FLOPS / 1e12:.0f} TFLOP/s "
          f"fp32, {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s; new instruction programs):")
    t = layer_cost_seconds(full, 4096, 4, 1)
    for n_stages in (1, 2, 4, 8):
        dp = POOL // n_stages
        per_stage = -(-full.num_layers // n_stages) * t
        thr = dp / per_stage  # dp replicas x pipeline rate
        lat = (n_stages + args.microbatches - 1) * per_stage
        print(f"  stages={n_stages:2d} dp={dp:3d}: throughput {thr:9.2f} mb/s, "
              f"latency {lat * 1e3:8.2f} ms")


if __name__ == "__main__":
    main()
