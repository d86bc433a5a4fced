"""Batched greedy decode through the port's serve step
(``runtime/serve.py`` ``make_serve_step``), closed loop: ``lanes`` sequences
decode together, each step gives every lane one token, and each step's
tokens are read to the host, as a streaming server reads them.

Set-up: the weights on the card from the seed, the cache
(``transformer.init_cache(cfg, lanes, cache_len)``), and each lane's prompt
of ``prompt_len`` random tokens fed through the serve step a position a step
(the port has no prefill that fills a cache), which runs every shape the
window runs. The window then decodes until ``--seconds`` have passed; a
token gap is the host time from one step's tokens to the next's.

Checked once the window has closed and the cache is freed: ``sample_lanes``
lanes, one drawn from the seed in each equal share of the batch, their
prompts and every token served to them through the plain reference
(``reference/dense.py``), which makes every layer's weights again from the
seed once the program's are freed. Compared: the logits the serve
step gave those lanes at every served position (``logit_err``), and the
widest gap by which a served token's reference logit lies below the
reference's best (``greedy_gap``, held to twice ``logit_err``'s limit,
``compare.py``). With ``spec["control"]`` the reference also runs with TF32
on in the program's place, and its numbers are returned beside.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, trace, weights
from ..model_config import dims
from . import arch_config
from ..reference import dense


def run(spec: dict) -> list[dict]:
    from repro_torch.runtime.serve import make_serve_step

    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # initialises CUDA: the allocator's statistics need it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = arch_config(spec["config"])
    step = make_serve_step(cfg, dev)
    records = []
    for k, seed in enumerate(spec["seeds"]):
        t_seed = time.monotonic()
        rec = _run_seed(spec, cfg, step, dev, seed)
        rec["setup_s"] = rec.pop("t_start") - (spec["t0"] if k == 0 else t_seed)
        records.append(rec)
    return records


def _run_seed(spec: dict, cfg, step, dev: torch.device, seed: int) -> dict:
    from repro_torch.models import transformer as tf

    cuda = dev.type == "cuda"
    d, tr, seconds = dims(spec["config"]), spec["traffic"], spec["seconds"]
    B, P, C = tr["lanes"], tr["prompt_len"], tr["cache_len"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = weights.model(d, seed, dev)
    caches = tf.init_cache(cfg, B, C, torch.float32, dev)
    prompts = weights.tokens(seed, "prompt", (B, P), d.vocab, dev)
    share = B // tr["sample_lanes"]  # the checked lanes: one from each share, from the seed
    rng = np.random.default_rng(weights.mix(seed, "sample"))
    lanes = [i * share + int(rng.integers(share)) for i in range(tr["sample_lanes"])]
    picked = torch.tensor(lanes, device=dev)
    # the checked lanes' logits of every step the cache allows, on the host
    # and made before the window, so that keeping them allocates nothing there
    kept = torch.empty((C - P + 1, len(lanes), d.vocab), pin_memory=cuda)
    for t in range(P):
        logits, _ = step(params, caches, {"tokens": prompts[:, t:t + 1]}, t)
    nxt = logits[:, -1].argmax(-1)
    kept[0].copy_(logits[picked, -1])
    served = [nxt.cpu()]

    def one(pos: int):
        nonlocal nxt
        t_call = time.monotonic()
        out, _ = step(params, caches, {"tokens": nxt[:, None]}, pos)
        t_ret = time.monotonic()
        nxt = out[:, -1].argmax(-1)
        kept[len(served)].copy_(out[picked, -1], non_blocking=True)
        served.append(nxt.cpu())  # the host's read, which also waits for the copy above
        return t_ret - t_call

    gaps, dispatch, positions = [], [], []
    t_start = last = time.monotonic()
    pos = P
    while last - t_start < seconds:
        if pos >= C - tr["trace_steps"] - 1:
            raise RuntimeError(f"the cache's {C} positions are full after {len(gaps)} steps")
        dispatch.append(one(pos))
        now = time.monotonic()
        gaps.append(now - last)
        positions.append(pos)
        last, pos = now, pos + 1
    rec = {"t_start": t_start, "window_s": last - t_start, "attempted": len(gaps) * B,
           "failed": 0, "decode_tokens": len(gaps) * B, "token_gaps_s": gaps,
           "dispatch_s": dispatch, "step_positions": positions, "lanes": B,
           "config": spec["config"]}
    if spec["trace"]:
        done: list = []
        with trace.profiler(tr["trace_steps"], done) as prof:
            for _ in range(tr["trace_steps"] + 1):
                one(pos)  # ends in the host's read of the step's tokens
                pos += 1
                prof.step()
        rec["trace"] = {**done[0], "steps": tr["trace_steps"]}
    rec["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1,
                     "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    del caches, logits, params
    if cuda:
        torch.cuda.empty_cache()

    # the reference over every served token of the sampled lanes
    t_ref = time.monotonic()
    served_t = torch.stack(served, 1)  # (B, n): token j was produced at position P - 1 + j
    n = served_t.shape[1]
    got = kept[:n].to(dev).transpose(0, 1)  # (lanes, n, V)
    seq = torch.cat([prompts[lanes], served_t[lanes, :-1].to(dev)], 1)
    glob = {k: weights.global_leaf(d, seed, k, dev) for k in ("embed", "final_norm", "lm_head")}
    ref = dense.logits(d, lambda i: weights.layer(d, seed, i, dev), glob, seq,
                       rows=torch.arange(P - 1, P - 1 + n, device=dev),
                       precisions=("fp32", "tf32") if spec["control"] else ("fp32",))
    limit = spec["limits"]["logit_err"]
    rec["checks"] = {
        "logit_err": {"value": compare.logit_err(got, ref["fp32"]), "limit": limit},
        "greedy_gap": {"value": compare.greedy_gap(ref["fp32"], served_t[lanes].to(dev)),
                       "limit": 2 * limit}}
    if spec["control"]:
        rec["control"] = {"logit_err": compare.logit_err(ref["tf32"], ref["fp32"]),
                          "greedy_gap": compare.greedy_gap(ref["fp32"], ref["tf32"].argmax(-1))}
    rec["reference_s"] = time.monotonic() - t_ref
    del ref, glob, got, kept
    if cuda:
        torch.cuda.empty_cache()
    return rec
