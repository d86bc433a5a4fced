"""The pipeline executor across ranks (``runtime/pipeline_ranks.py``): one
stage a process, one process a card, each stage's LD / CP / ST programs
walked round by round and the REQ / ACK tokens sent as NCCL messages
between neighbouring ranks (gloo on the CPU, in the tests).

``spawn_stages`` starts the ranks and hands each only the seed and the
cell's parameters; each rank makes its own stage's weights on its card
(``weights.stage``). Set-up ends with one call that runs every shape and
message of a call. The window is back-to-back calls of ``microbatches`` x
``microbatch_size`` x ``seq_len`` random tokens, new ones from the seed for
every call, each begun after a barrier: rank 0 begins calls while
``--seconds`` have not passed, and the window ends at the barrier after the
last call, when every rank has finished it.

Checked once the window has closed (on the last rank, after its state is
freed): two microbatches' logits, one from the first half of the
microbatches and one from the second, each from a call drawn from the seed
(a reservoir of one call a half, so that two microbatches are kept however
long the window), against the plain reference (``reference/dense.py``), which makes every layer
again from the seed; the number compared is the largest distance of a logit
from the reference's, in units of the reference's RMS. Every call's token
operations must be the programs' and, on the card, every call must launch the
flash kernel once a layer and microbatch.
"""
from __future__ import annotations

import time

import torch

from .. import compare, trace, weights
from ..harness import forbidden_loaded
from ..model_config import dims
from . import arch_config
from ..reference import dense

SPAWN_TIMEOUT_S = 900.0  # beyond the window: a first run in a checkout builds the kernel


def run(spec: dict) -> list[dict]:
    from repro_torch.runtime import pipeline_ranks as pr

    cuda = spec["device"] == "cuda"
    S, tr = spec["chips"], spec["traffic"]
    ranks = pr.spawn_stages(S, rank_body, spec, backend="nccl" if cuda else "gloo",
                            device="cuda:0" if cuda else "cpu",
                            timeout_s=SPAWN_TIMEOUT_S + spec["seconds"] * len(spec["seeds"]))
    M, mb, s = tr["microbatches"], tr["microbatch_size"], tr["seq_len"]
    records = []
    for k in range(len(spec["seeds"])):
        per = [r[k] for r in ranks]
        first, last = per[0], per[-1]
        rec = {"setup_s": first["t_start"] - (spec["t0"] if k == 0 else first["t_seed"]),
               "window_s": first["window_s"], "attempted": first["calls"] * M, "failed": 0,
               "prefill_tokens": first["calls"] * M * mb * s, "calls": first["calls"],
               "call_s": first["call_s"], "stage_ms": [r["stage_ms"] for r in per],
               "reference_s": last["reference_s"],
               "config": spec["config"], "traffic": tr, "chips": S,
               "device": {"platform": "gpu" if cuda else "cpu", "kind": first["kind"],
                          "count": S, "memory_peak_bytes": max(r["memory_peak"] for r in per)},
               "forbidden_modules": sorted({m for r in per for m in r["forbidden"]})}
        rec["checks"] = {
            **last["checks"],
            "sync_ops_off": {"value": sum(r["counts_off"] for r in per), "limit": 0},
            "flash_launches_off": {"value": sum(r["launches_off"] for r in per), "limit": 0}}
        if "control" in last:
            rec["control"] = last["control"]
        if spec["trace"]:
            rec["trace"] = trace.combine([r["trace"] for r in per])
        records.append(rec)
    return records


def _pick(seed: int, call: int, M: int) -> tuple[int, int]:
    """The microbatches of ``call`` kept for the check: one of each half."""
    h = M // 2
    return (weights.mix(seed, "pick", "a", call) % h,
            h + weights.mix(seed, "pick", "b", call) % (M - h))


def _replaces(seed: int, half: str, call: int) -> bool:
    """Whether ``call`` takes the reservoir's place for ``half``: with
    chance 1 / (call + 1), so the call kept is uniform over the window's."""
    return weights.mix(seed, "reservoir", half, call) % (call + 1) == 0


def rank_body(rank: int, device: torch.device, spec: dict) -> list[dict]:
    """One rank of the run, for ``spawn_stages``: a result a seed."""
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.runtime import pipeline as pp
    from repro_torch.runtime import pipeline_ranks as pr

    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    d, cfg, tr, seconds = dims(spec["config"]), arch_config(spec["config"]), spec["traffic"], \
        spec["seconds"]
    S, M, mb, s = spec["chips"], tr["microbatches"], tr["microbatch_size"], tr["seq_len"]
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    fn = pr.RankPipelineForward(cfg, plan, rank, device)
    want_counts = pp.program_sync_counts(plan)[rank]
    lps = plan.layers_per_stage
    layers = range(rank * lps, min((rank + 1) * lps, d.layers))
    first, last = rank == 0, rank == S - 1
    flag = torch.zeros(1, dtype=torch.int64, device=device)

    def barrier() -> float:
        flag.zero_()
        dist.all_reduce(flag)
        flag.item()
        return time.monotonic()

    def decide(go: bool) -> bool:
        """Rank 0's ``go``, on every rank."""
        flag.fill_(int(go and first))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    out = []
    for seed in spec["seeds"]:
        t_seed = time.monotonic()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        local = weights.stage(d, seed, layers, device, first=first, last=last)
        toks = torch.zeros((M, mb, s), dtype=torch.int64, device=device)

        def call(tag):
            if first:  # only the first stage reads the ids; the others take the shape
                toks.copy_(weights.tokens(seed, tag, (M, mb, s), d.vocab, device))
            return fn(local, toks)

        call("warm-up")
        launches0 = fa.launches
        res = {"t_seed": t_seed, "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "call_s": [], "stage_ms": [], "counts_off": 0}
        kept = {}
        t_start = t_prev = barrier()
        calls = 0
        while decide(t_prev - t_start < seconds):
            logits = call(("call", calls))
            res["stage_ms"].append(fn.stage_ms)
            res["counts_off"] += fn.counts != want_counts
            if last:
                for half, m in zip("ab", _pick(seed, calls, M)):
                    if _replaces(seed, half, calls):
                        kept[half] = (calls, logits[m].clone())
            del logits
            t_b = barrier()
            res["call_s"].append(t_b - t_prev)
            t_prev, calls = t_b, calls + 1
        res.update(t_start=t_start, window_s=t_prev - t_start, calls=calls)
        res["launches_off"] = (abs(fa.launches - launches0 - calls * M * len(layers))
                               if cuda else 0)
        if spec["trace"]:
            done: list = []
            with trace.profiler(tr["trace_calls"], done) as prof:
                for j in range(tr["trace_calls"] + 1):
                    barrier()
                    call(("trace", j))
                    barrier()
                    prof.step()
            res["trace"] = done[0]
        res["memory_peak"] = torch.cuda.max_memory_allocated(device) if cuda else 0
        del local
        if last:
            res.update(_check(spec, d, seed, calls, kept, device))
        del kept
        if cuda:
            torch.cuda.empty_cache()
        res["forbidden"] = forbidden_loaded()
        out.append(res)
    return out


def _check(spec: dict, d, seed: int, calls: int, kept: dict, device) -> dict:
    """The last rank's check against the reference (module docstring)."""
    t_ref = time.monotonic()
    tr = spec["traffic"]
    M, mb, s = tr["microbatches"], tr["microbatch_size"], tr["seq_len"]
    (c1, got_a), (c2, got_b) = kept["a"], kept["b"]
    a, b = _pick(seed, c1, M)[0], _pick(seed, c2, M)[1]
    got = torch.cat([got_a, got_b])
    kept.clear()
    seq = torch.cat([weights.tokens(seed, ("call", c1), (M, mb, s), d.vocab, device)[a],
                     weights.tokens(seed, ("call", c2), (M, mb, s), d.vocab, device)[b]])
    glob = {k: weights.global_leaf(d, seed, k, device) for k in ("embed", "final_norm", "lm_head")}
    ref = dense.logits(d, lambda i: weights.layer(d, seed, i, device), glob, seq,
                       precisions=("fp32", "tf32") if spec["control"] else ("fp32",))
    res = {"checks": {"logit_err": {"value": compare.logit_err(got, ref["fp32"]),
                                    "limit": spec["limits"]["logit_err"]}}}
    if spec["control"]:
        res["control"] = {"logit_err": compare.logit_err(ref["tf32"], ref["fp32"])}
    res["reference_s"] = time.monotonic() - t_ref
    return res
