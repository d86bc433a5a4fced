#!/usr/bin/env python3
"""Times the port's unsharded train step of qwen3-0.6b on the card, so that
two checkouts can be compared on one machine: one AdamW step of B x S tokens
through ``make_train_step`` with no policy, fp32, random weights from seed
0, with and without remat. Each line gives the step's wall (CUDA events, the
mean of ITERS steps from the same state after WARMUP steps) and the
allocator's peak during one step above what the params and the optimizer
state hold before it.

    python3 tools/unsharded_train_time.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so the same script times an older checkout:
run it parent, change, change, parent on one card, one after another. Prints
one line a run and remat setting, with the card's name and power limit.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ARCH, B, S, WARMUP, ITERS, LR = "qwen3-0.6b", 4, 1024, 2, 5, 1e-4


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("unsharded_train_time: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.runtime import train
    from repro_torch.runtime.optimizer import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=0)
    params, state = train.init_train_state(cfg, opt_cfg, seed=0, dtype=torch.float32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    toks = torch.as_tensor(toks, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    card = card_line()
    for remat in (True, False):
        step = train.make_train_step(cfg, opt_cfg, remat=remat)
        for _ in range(WARMUP):
            out = step(params, state, batch)
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = step(params, state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        nll = float(out[2]["nll"])
        del out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            out = step(params, state, batch)
            del out
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / ITERS
        print(f"{ARCH} unsharded train step {B} x {S}, remat {remat}, {args.src}: "
              f"{ms:.4f} ms, allocator peak {peak} B above the {held} B held (nll "
              f"{nll:.7f})  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
