#!/usr/bin/env python3
"""Times the port's unsharded serving path of qwen3-0.6b on the card, so that
two checkouts can be compared on one machine: a warm prefill of
B x S tokens and a warm decode step of B lanes and of one lane, through
``make_prefill`` / ``make_serve_step`` with no policy (CUDA events: the mean
of 5 prefills and of ITERS decode steps, after WARMUP calls), fp32, random
weights from seed 0.

    python3 tools/unsharded_serving_time.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so the same script times an older checkout:
run it parent, change, change, parent on one card, one after another. Prints
one line a run, with the card's name and power limit.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ARCH, B, S, STEPS_CACHE, WARMUP, ITERS = "qwen3-0.6b", 4, 1024, 32, 3, 100


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def cuda_ms(torch, fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("unsharded_serving_time: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import make_prefill, make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    params = tf.init_params(cfg, seed=0, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(0))
    tokens = tokens.to("cuda")
    prefill, step = make_prefill(cfg), make_serve_step(cfg)
    with torch.inference_mode():
        pre_ms = cuda_ms(torch, lambda: prefill(params, {"tokens": tokens}), iters=5)
        times = {}
        for lanes in (B, 1):
            cache = tf.init_cache(cfg, lanes, S + STEPS_CACHE, torch.float32)
            one = {"tokens": tokens[:lanes, :1]}
            times[lanes] = cuda_ms(torch, lambda: step(params, cache, one, S))
    print(f"{ARCH} unsharded, {args.src}: prefill {B} x {S} {pre_ms:.4f} ms, decode step "
          f"{B} lanes {times[B]:.4f} ms, 1 lane {times[1]:.4f} ms  [{card_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
