#!/usr/bin/env python3
"""The executor across processes on one card a rank: h2o-danube-3-4b at full
width (fp32, random weights from seed 0), 4 stages, 4 microbatches of 1 x
4608 tokens, as ``chip_smoke.py``'s pipeline phases run it, here over NCCL
with rank r on ``cuda:r`` (the device transport), beside the gloo ranks all
on ``cuda:0`` (the host transport) and the one-card executor, in one call.

    python3 tools/pipeline_ranks_cards.py     # needs 4 cards

Prints the card, each route's wall (host clock; the ranks from a barrier to
the last rank's return), the ranks' Compute ms by stage and microbatch and
their send-recv ms by message, and each route's logits against the plain
forward's. Exits non-zero with fewer than 4 cards or if a route's logits are
off the plain forward by more than 2e-3.
"""
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ARCH, STAGES, MICROBATCHES, MB, LEN, CALLS, SEED, TOL = "h2o-danube-3-4b", 4, 4, 1, 4608, 2, 0, 2e-3


def rank_body(rank, device, cfg, plan, local, tokens, want, calls) -> dict:
    """Copy this rank's params to its card, then ``calls`` calls after a
    barrier each; the last rank holds its logits to ``want`` (on card 0)."""
    import torch.distributed as dist
    from repro_torch.runtime import pipeline_ranks as pr
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    local = tree_map(lambda x: x.to(device), local)
    fn = pr.RankPipelineForward(cfg, plan, rank, device)
    tokens = tokens.to(device)
    out = {"wall_ms": [], "stage_ms": [], "messages": []}
    for _ in range(calls):
        dist.barrier()
        t0 = time.perf_counter()
        logits = fn(local, tokens)
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["stage_ms"].append(fn.stage_ms)
        out["messages"].append(fn.messages)
    if logits is not None:
        out["max_diff"] = (logits.to(want.device) - want).abs().max().item()
    return out


def report(name, ranks, card):
    last = ranks[-1]
    print(f"{name}: wall " + " / ".join(f"{ms:.1f}" for ms in last["wall_ms"])
          + f" ms, logits vs the plain forward max |diff| {last['max_diff']:.3e}  [{card}]")
    for c in range(len(last["wall_ms"])):
        print(f"  call {c + 1} Compute ms: " + "; ".join(
            f"stage {i} " + " ".join(f"{ms:.1f}" for ms in r["stage_ms"][c])
            for i, r in enumerate(ranks)))
        print(f"  call {c + 1} send-recv ms: " + "; ".join(
            f"{i - 1}->{i} " + " ".join(f"{ms:.2f}" for what, _, ms in r["messages"][c]
                                      if what == "send_recv")
            for i, r in enumerate(ranks) if i))


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < STAGES:
        print(f"pipeline_ranks_cards: needs {STAGES} CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import SOURCES, _build
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import pipeline as pp
    from repro_torch.runtime import pipeline_ranks as pr

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.device_count()} x " + card.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build({"flash_attention": SOURCES["flash_attention"]})  # the ranks only load it
    cfg = get_config(ARCH)
    S, M, mb, s, V = STAGES, MICROBATCHES, MB, LEN, cfg.vocab_size
    params = tf.init_params(cfg, seed=SEED, dtype=torch.float32)
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    sparams = pp.stack_stage_params(cfg, params, plan)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, V, (M, mb, s)), device="cuda")
    want = tf.forward(cfg, params, {"tokens": tokens.reshape(M * mb, s)})[0].view(M, mb, s, V)

    one_fn = pp.make_pipeline_forward(cfg, plan)
    walls = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = one_fn(sparams, tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    one_diff = (one - want).abs().max().item()
    del one
    print(f"one-card executor (cuda:0, 4 streams): wall " + " / ".join(f"{ms:.1f}" for ms in walls)
          + f" ms, logits vs the plain forward max |diff| {one_diff:.3e}  [{card}]")

    slices = pr.PerRank([pr.stage_slice(cfg, sparams, plan, r) for r in range(S)])
    last_want = pr.PerRank([None] * (S - 1) + [want])
    diffs = [one_diff]
    for backend, name in (("nccl", "nccl ranks (rank r on cuda:r)"),
                          ("gloo", "gloo ranks (all on cuda:0)")):
        ranks = pr.spawn_stages(S, rank_body, cfg, plan, slices, tokens.cpu(), last_want, CALLS,
                                backend=backend, timeout_s=600)
        report(name, ranks, card)
        diffs.append(ranks[-1]["max_diff"])
    return 0 if max(diffs) <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
