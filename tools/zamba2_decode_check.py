#!/usr/bin/env python3
"""Zamba2-7B-Instruct served token by token through the port's serve step,
at published widths and full depth on one card, against the benchmark's
plain reference (``cardbench/reference/zamba2.py``).

    python3 tools/zamba2_decode_check.py [--seed N] [--lanes 2] [--prompt 64] [--steps 32]

Each lane's prompt of ``--prompt`` random ids is fed through
``make_serve_step`` a position a step (every shared call into its own KV
cache, every mamba layer into its conv history and SSM state), then
``--steps`` greedy steps follow. Once the program's weights are freed the
reference runs its full forward over each lane's prompt and served tokens,
and the logits of every served position are compared in units of the
reference's RMS (``logit_err``), beside the limit of the ``zamba2.prefill``
cell. Prints one JSON line. ``--config`` and ``--device cpu`` run another
hybrid file (a tiny one) on the CPU.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--config", default=str(ROOT / "cardbench/configs/zamba2-7b-instruct.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from cardbench import compare, hybrid, hybrid_weights, weights
    from cardbench.reference import zamba2
    from repro_torch.configs.base import HybridConfig
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    file = json.loads(Path(args.config).read_text())
    h = hybrid.hybrid_dims(file)
    cfg = HybridConfig(**hybrid.port_fields(h))
    B, P, n = args.lanes, args.prompt, args.steps
    params = hybrid_weights.model(h, args.seed, dev)
    caches = tf.init_cache(cfg, B, P + n, torch.float32, dev)
    step = make_serve_step(cfg, dev)
    prompts = weights.tokens(args.seed, "prompt", (B, P), h.vocab, dev)
    for t in range(P):
        logits, _ = step(params, caches, {"tokens": prompts[:, t:t + 1]}, t)
    got, served = [logits[:, -1].cpu()], [logits[:, -1].argmax(-1)]
    t0 = time.monotonic()
    for t in range(P, P + n):
        logits, _ = step(params, caches, {"tokens": served[-1][:, None]}, t)
        got.append(logits[:, -1].cpu())  # the host's read: the step has finished
        served.append(logits[:, -1].argmax(-1))
    step_ms = 1e3 * (time.monotonic() - t0) / n
    del params, caches, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    seq = torch.cat([prompts, torch.stack(served[:-1], 1)], 1)
    glob = {k: hybrid_weights.global_leaf(h, args.seed, k, dev) for k in ("embed", "final_norm")}
    ref = zamba2.logits(h, lambda i: hybrid_weights.mamba_layer(h, args.seed, i, dev),
                        lambda b: hybrid_weights.shared_block(h, args.seed, b, dev),
                        lambda j: hybrid_weights.call(h, args.seed, j, dev), glob, seq,
                        rows=torch.arange(P - 1, P + n, device=dev))["fp32"]
    got = torch.stack(got, 1).to(dev)
    limit = json.loads((ROOT / "cardbench/workloads/zamba2.prefill.json").read_text())[
        "limits"]["logit_err"]
    out = {"config": h.name, "seed": args.seed, "lanes": B, "prompt": P, "steps": n,
           "positions": B * (n + 1), "logit_err": compare.logit_err(got, ref),
           "greedy_gap": compare.greedy_gap(ref, torch.stack(served, 1)), "limit": limit,
           "decode_step_ms": step_ms,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    out["within_limit"] = out["logit_err"] <= limit
    print(json.dumps(out), flush=True)
    return 0 if out["within_limit"] else 1


if __name__ == "__main__":
    sys.exit(main())
