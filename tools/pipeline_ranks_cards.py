#!/usr/bin/env python3
"""The executor across processes on one card a rank: h2o-danube-3-4b at full
width (fp32, random weights from seed 0), 4 stages, 4 microbatches of 1 x
4608 tokens, as ``chip_smoke.py``'s pipeline phases run it, here over NCCL
with rank r on ``cuda:r`` (the device transport), beside the gloo ranks all
on ``cuda:0`` (the host transport) and the one-card executor, in one call.

    python3 tools/pipeline_ranks_cards.py     # needs 4 cards

Prints the card, each route's wall (host clock; the ranks from a barrier to
the last rank's return) and its logits against the plain forward's, and from
each rank's ``timeline`` (CUDA events on its stream): the Compute ms by stage
and microbatch, the last stage's ST ms by microbatch (the head), each WAIT's
stall by token, each rank's launches of the 3xTF32 GEMM and the products
its route declined a call, and the first microbatch's latency, from the
earliest rank's call entry to the end of the last rank's round-0 ST, on the
host clock that the ranks' processes share. On the NCCL route it then times a call under a
torch profiler with the executor's spans on and with ``span`` forced off
(``record_function`` a null context), in turns on, off, off, on. Exits
non-zero with fewer than 4 cards or if a route's logits are off the plain
forward by more than 2e-3.
"""
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ARCH, STAGES, MICROBATCHES, MB, LEN, CALLS, SEED, TOL = "h2o-danube-3-4b", 4, 4, 1, 4608, 2, 0, 2e-3


def rank_body(rank, device, cfg, plan, local, tokens, want, calls, traced) -> dict:
    """Copy this rank's params to its card, then ``calls`` calls after a
    barrier each; the last rank holds its logits to ``want`` (on card 0).
    Then, if ``traced``, four calls under a profiler: spans on, off, off, on."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.gemm_f32 import kernel as f32_kernel
    from repro_torch.kernels.gemm_f32 import ops as f32_ops
    from repro_torch.runtime import pipeline_ranks as pr
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    local = tree_map(lambda x: x.to(device), local)
    fn = pr.RankPipelineForward(cfg, plan, rank, device)
    tokens = tokens.to(device)
    out = {"wall_ms": [], "stage_ms": [], "timeline": [], "anchor_ns": [], "traced_ms": [],
           "f32": []}
    for _ in range(calls):
        dist.barrier()
        counts = f32_kernel.launches, f32_ops.declined
        t0 = time.perf_counter()
        logits = fn(local, tokens)
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["f32"].append((f32_kernel.launches - counts[0], f32_ops.declined - counts[1]))
        out["stage_ms"].append(fn.stage_ms)
        out["timeline"].append(fn.timeline)
        out["anchor_ns"].append(fn.anchor_ns)
    if logits is not None:
        out["max_diff"] = (logits.to(want.device) - want).abs().max().item()
    del logits
    record_function, off = torch.profiler.record_function, contextlib.nullcontext()
    try:
        for spans in ("on", "off", "off", "on") if traced else ():
            torch.profiler.record_function = (record_function if spans == "on"
                                              else lambda name: off)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                dist.barrier()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                fn(local, tokens)
                out["traced_ms"].append((spans, (time.perf_counter() - t0) * 1e3))
    finally:
        torch.profiler.record_function = record_function
    return out


def _ms(values) -> str:
    return " ".join(f"{ms:.1f}" for ms in values)


def _durations(timeline, what) -> list:
    """The ms of a rank's ``timeline`` entries of one kind, round by round."""
    return [end - start for kind, _, _, start, end in timeline if kind == what]


def report(name, ranks, card):
    last = ranks[-1]
    print(f"{name}: wall " + " / ".join(f"{ms:.1f}" for ms in last["wall_ms"])
          + f" ms, logits vs the plain forward max |diff| {last['max_diff']:.3e}  [{card}]")
    S = len(ranks)
    for c in range(len(last["wall_ms"])):
        tls = [r["timeline"][c] for r in ranks]
        print(f"  call {c + 1} Compute ms: " + "; ".join(
            f"stage {i} {_ms(_durations(tls[i], 'CP'))}" for i in range(S)))
        print(f"  call {c + 1} last stage's ST (the head) ms: {_ms(_durations(tls[-1], 'ST'))}")
        print(f"  call {c + 1} gemm_f32 launches / products declined by rank: " + "; ".join(
            f"{r['f32'][c][0]} / {r['f32'][c][1]}" for r in ranks))
        print(f"  call {c + 1} WAIT stalls ms (device clock): " + "; ".join(
            [f"REQ {i - 1}->{i} {_ms(_durations(tls[i], 'WAIT_REQ'))}" for i in range(1, S)]
            + [f"ACK {i + 1}->{i} {_ms(_durations(tls[i], 'WAIT_ACK'))}" for i in range(S - 1)]))
        entry_ns = min(r["anchor_ns"][c] for r in ranks)
        st0 = next(e for w, rd, _, _, e in tls[-1] if w == "ST" and rd == 0)
        first_ms = (last["anchor_ns"][c] - entry_ns) / 1e6 + st0
        print(f"  call {c + 1} first microbatch's latency {first_ms:.1f} ms (the earliest "
              f"rank's entry to the last rank's round-0 ST end); rank entries after the "
              f"earliest " + " ".join(f"{(r['anchor_ns'][c] - entry_ns) / 1e6:.1f}"
                                      for r in ranks) + " ms")
    if last["traced_ms"]:
        print("  a call under the profiler, spans on / off, the last rank's ms: " + ", ".join(
            f"{spans} {ms:.1f}" for spans, ms in last["traced_ms"]))


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
    # the ranks only load them
    _build.build({name: SOURCES[name] for name in ("flash_attention", "gemm_f32")})
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
                                backend == "nccl", backend=backend, timeout_s=600)
        report(name, ranks, card)
        diffs.append(ranks[-1]["max_diff"])
    return 0 if max(diffs) <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
