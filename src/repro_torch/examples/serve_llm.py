"""End-to-end serving driver, the twin of ``examples/serve_llm.py``: build an
architecture (reduced config by default, the full one with ``--full``) with
random fp32 weights, run batched requests through the continuous-batching
engine, report throughput and latency. Runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.serve_llm --arch qwen3-0.6b --requests 8
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.runtime.serve import ServingEngine
from repro_torch.tree import tree_leaves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="use the full config")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.frontend == "frame_embed":
        raise SystemExit("use an LM/VLM arch for the serving example")
    dev = resolve_device(args.device)

    print(f"initializing {args.arch} ({cfg.num_layers}L d={cfg.d_model}) on {dev} ...")
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  {n_params/1e6:.1f}M params")

    eng = ServingEngine(cfg, params, batch_slots=args.slots, max_len=256, device=dev)
    t0 = time.time()
    for i in range(args.requests):
        prompt = [(7 * i + j) % (cfg.vocab_size - 1) + 1 for j in range(5)]
        eng.submit(prompt, max_new_tokens=args.new_tokens)
    done = eng.run_until_drained()
    dt = time.time() - t0

    total_tokens = sum(len(r.generated) for r in done)
    lats = [r.finished_at - r.submitted_at for r in done]
    print(f"\nserved {len(done)} requests, {total_tokens} tokens in {dt:.1f}s")
    print(f"  throughput: {total_tokens/dt:.1f} tok/s")
    print(f"  request latency: mean {sum(lats)/len(lats):.2f}s  max {max(lats):.2f}s")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt {r.prompt} -> {r.generated}")



if __name__ == "__main__":
    main()
