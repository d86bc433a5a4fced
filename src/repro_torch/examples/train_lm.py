"""End-to-end training driver with fault tolerance, the twin of
``examples/train_lm.py``: train an LM on the synthetic token stream,
checkpoint every ``--ckpt-every`` steps, resume from the latest checkpoint
after an interruption. A reduced config by default, the full one with
``--full``; runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 --ckpt-every 50
    # stop it mid-run, then run the same command again: it resumes.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.data import DataConfig, DataState, TokenStream
from repro_torch.runtime.optimizer import AdamWConfig
from repro_torch.tree import tree_leaves
from repro_torch.runtime.train import init_train_state, make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--full", action="store_true", help="use the full config")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat=False, device=dev)

    params, opt = init_train_state(cfg, opt_cfg, seed=0, dtype=torch.float32, device=dev)
    stream = TokenStream(dcfg)
    start = 0

    # fault tolerance: auto-resume from the latest checkpoint
    if ckpt.latest_step(args.ckpt_dir) is not None:
        restored, start, extra = ckpt.restore_checkpoint(
            args.ckpt_dir, {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        stream = TokenStream(dcfg, DataState.from_dict(extra["data"]))
        print(f"resumed from step {start}")

    n = sum(p.numel() for p in tree_leaves(params))
    print(f"training {args.arch} ({n/1e6:.1f}M params) on {dev} for {args.steps} steps")

    t0, first_loss, m = time.time(), None, None
    for step in range(start, args.steps):
        params, opt, m = step_fn(params, opt, stream.next())
        if first_loss is None:
            first_loss = float(m["nll"])
        if (step + 1) % 10 == 0:
            print(f"step {step+1:4d}  nll {float(m['nll']):.4f}  "
                  f"lr {float(m['lr']):.2e}  |g| {float(m['grad_norm']):.2f}")
        if (step + 1) % args.ckpt_every == 0:
            path = ckpt.save_checkpoint(args.ckpt_dir, step + 1, {"params": params, "opt": opt},
                                        extra={"data": stream.state.as_dict()})
            print(f"  checkpoint -> {path}")

    if m is None:
        print(f"\nnothing to do: the checkpoint is at step {start} of {args.steps}")
    else:
        print(f"\ndone in {time.time()-t0:.1f}s; loss {first_loss:.3f} -> {float(m['nll']):.3f}")


if __name__ == "__main__":
    main()
