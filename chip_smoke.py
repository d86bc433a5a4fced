#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a non-zero exit:

1. setup: card name and power limit (nvidia-smi), TF32 off, build every CUDA
   kernel from the sources in this checkout with nvcc (sm_90a), one nvcc per
   source, all started together;
2. kernel check: each kernel against its plain PyTorch version on the card
   (flash attention, head dims 112 and 120 included; wkv6, also against its
   tile size and with the state updated in place; the SSD scan, y and final
   state, also against the chunked plain version and its tile size);
3. three main paths at full width, fp32, random weights from a seed, one
   after the other (each one's weights are freed before the next):
   qwen3-0.6b (28 layers, the flash-attention kernel), rwkv6-7b (32 layers,
   7.57 B params, the wkv6 kernel) and zamba2-7b (81 mamba layers and 13
   occurrences of 2 shared attention blocks, 6.95 B params, the SSD-scan and
   flash-attention kernels). Each runs
   a. prefill: 4 prompts x 1024 tokens through ``make_prefill``;
   b. consistency: one 32-token prompt decoded token by token through
      ``make_serve_step`` reproduces the prefill logits (and the same prompt
      prefilled in a batch of 4 shows how far the forward agrees with
      itself);
   c. serving: ``ServingEngine`` (4 slots) drains 8 requests;
   d. with ``--profile`` only: where the time goes, from ``torch.profiler``
      windows over one prefill and over one-lane decode steps;
4. timing: each kernel, its plain version and the PyTorch library call (where
   one exists) at its prefill shape, beside the card's bound.

Every launch count is set to 0 just before a path's prefill and read just
after its serving phase: each of the path's kernels must have launched its
expected number of times per prefill call and per decode step, and the
other kernels not at all. The last three lines are the
kernels JSON, the card, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

SEED = 0
ARCH = "qwen3-0.6b"
RWKV_ARCH = "rwkv6-7b"
ZAMBA_ARCH = "zamba2-7b"
# launches of each kernel per prefill call and per decode step, by path:
# qwen3-0.6b has 28 attention layers; rwkv6-7b 32 rwkv layers, whose decode
# runs the wkv6 kernel too; zamba2-7b 81 mamba layers (SSD scan) and 13
# shared-attention occurrences, and its decode is plain tensor code
PATHS = [
    (ARCH, {"flash_attention": 28}, {}),
    (RWKV_ARCH, {"wkv6": 32}, {"wkv6": 32}),
    (ZAMBA_ARCH, {"ssd_scan": 81, "flash_attention": 13}, {}),
]
PREFILL_BATCH, PREFILL_LEN, PREFILL_ITERS = 4, 1024, 3
CONSISTENCY_LEN = 32
SLOTS, MAX_LEN, REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 256, 8, 16, 16
# the engine decodes each prompt token once, then re-feeds the last one as
# the first of NEW_TOKENS generating steps
ENGINE_STEPS = REQUESTS * (PROMPT_LEN + NEW_TOKENS)
# rtol = atol on the consistency check of qwen3-0.6b and zamba2-7b: the
# reference test's own logits tolerance (tests/test_models.py:111, which
# holds zamba2 to it too); fp32 sums in another order (kernel vs einsum
# decode, the SSD kernel vs the per-step recurrence) differ by ~1e-6
# relative on logits of size ~1e3.
CONSISTENCY_TOL = 2e-3
# rwkv: the reference's ssm criterion (tests/test_models.py:97-109), softmax
# within 2e-2 and the same argmax everywhere. Both sides run the sequential
# kernel, so the logits differ only by the GEMMs' order of sums (M = 1 vs
# M = 32); but 32 random rwkv layers amplify that fp32 noise (the per-head
# group norm of a near-zero wkv output, at the first positions), so the
# prefill of the same prompt in a batch of 4 (M = 128) differs from the
# prefill alone too. Where that re-batched prefill already breaks the
# argmax criterion, decode is held to agree with the prefill at least as
# well as the prefill agrees with itself: no larger max |diff|, no fewer
# equal argmaxes.
SSM_PROB_TOL = 2e-2
DECODE_LEN, DECODE_WARM, DECODE_STEPS = 256, 5, 20  # --profile decode window
# wkv6 kernel check against wkv6_reference. The TestWKV6 cases
# (tests/test_kernels.py:189-229) at 2e-4; at the rwkv6-7b prefill shape, in
# the model's decay regime, |y| reaches ~30 and each output sums 64 products
# in another order and with FMAs: ~1e-5 expected, held to 1e-4.
WKV6_TOL, WKV6_PREFILL_TOL, WKV6_TILE_TOL, WKV6_CHUNKED_TOL = 2e-4, 1e-4, 1e-5, 3e-4
# SSD-scan kernel check against ssd_reference: the TestSSDScan cases
# (tests/test_kernels.py:148-184) at 2e-4, the sweep at 3e-4, the chunked
# plain version against the kernel at 2e-4 (the reference's chunked-vs-
# recurrence tolerance). At the zamba2-7b prefill shape each y sums 64
# products C_n h_n in another order and with FMAs, each h_n a decayed sum
# over steps that the kernel and the einsum recurrence round alike; |y|
# reaches ~200 at these inputs, so ~1e-6 relative is expected, held to
# rtol = atol = 1e-4 as the wkv6 prefill is.
# The tile only decides when inputs are staged: tiles agree bit for bit.
SSD_TOL, SSD_SWEEP_TOL, SSD_CHUNKED_TOL, SSD_PREFILL_TOL = 2e-4, 3e-4, 2e-4, 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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


def qkv(b, s, H, G, hd, seed, dtype, t=None, ones_v=False):
    r = np.random.default_rng(seed)
    t = s if t is None else t
    q = 0.5 * r.standard_normal((b, s, H, hd), dtype=np.float32)
    k = 0.5 * r.standard_normal((b, t, G, hd), dtype=np.float32)
    v = np.ones((b, t, G, hd), np.float32) if ones_v else r.standard_normal(
        (b, t, G, hd), dtype=np.float32)
    return tuple(torch.from_numpy(a).to("cuda", dtype) for a in (q, k, v))


def wkv6_inputs(b, s, H, P, seed, state_scale=0.0, model_decay=False):
    """TestWKV6's distributions (r, k ~ 0.5 N, v ~ N, w = sigmoid(N + 2),
    u ~ 0.5 N, state ~ state_scale N), or with ``model_decay`` the model's
    decay regime w = exp(-exp(N(0, 0.5))); on the card, fp32."""
    r = np.random.default_rng(seed)
    rr = 0.5 * r.standard_normal((b, s, H, P), dtype=np.float32)
    kk = 0.5 * r.standard_normal((b, s, H, P), dtype=np.float32)
    vv = r.standard_normal((b, s, H, P), dtype=np.float32)
    if model_decay:
        ww = np.exp(-np.exp(0.5 * r.standard_normal((b, s, H, P), dtype=np.float32)))
    else:
        ww = 1.0 / (1.0 + np.exp(-(r.standard_normal((b, s, H, P), dtype=np.float32) + 2.0)))
    uu = 0.5 * r.standard_normal((H, P), dtype=np.float32)
    st = state_scale * r.standard_normal((b, H, P, P), dtype=np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            for a in (rr, kk, vv, ww, uu, st)]


def ssd_inputs(b, s, H, P, N, seed):
    """TestSSDScan's distributions (xh, B, C ~ N(0, 1), dt = softplus(N(0, 1)),
    A = -exp(0.5 N(0, 1))), which are also how the model draws dt (its
    dt_bias is 0 and its dt projection N(0, 1)) and A (A_log ~ N(0, 0.5));
    on the card, fp32."""
    r = np.random.default_rng(seed)
    xh = r.standard_normal((b, s, H, P), dtype=np.float32)
    dt = np.logaddexp(r.standard_normal((b, s, H), dtype=np.float32), np.float32(0.0))
    A = -np.exp(0.5 * r.standard_normal(H, dtype=np.float32))
    B = r.standard_normal((b, s, N), dtype=np.float32)
    C = r.standard_normal((b, s, N), dtype=np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            for a in (xh, dt, A, B, C)]


def max_err(got, want) -> float:
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def kernel_summary(prof, n_top: int = 8) -> dict:
    """Device time by kernel name and the union of kernel intervals (us)."""
    from torch.autograd import DeviceType

    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_name[e.name] += end - start
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return {"kernels": len(spans), "busy_us": busy, "sum_us": sum(by_name.values()),
            "top": [(name[:80], round(us, 1)) for name, us in top]}


def profile_phase(cfg, params, prefill, batch, step, init_cache, rng, report) -> None:
    """Wall time without the profiler (CUDA events for prefill, host clock
    around synchronised steps for decode), then a profiler window over the
    same work: device time by kernel, busy time (union of kernel intervals)
    and the idle share 1 - busy / unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    prefill(params, batch)
    end.record()
    end.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    with profile(activities=acts) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    summ = kernel_summary(prof)
    summ.update(wall_us=wall_us, idle_share=1 - summ["busy_us"] / wall_us)
    report(f"profile {cfg.name} prefill {PREFILL_BATCH}x{PREFILL_LEN}: {json.dumps(summ)}")

    # one lane (what ServingEngine._step_slot runs); the engine reads each token
    cache = init_cache(cfg, 1, DECODE_LEN, dtype=torch.float32)
    toks = [int(x) for x in rng.integers(0, cfg.vocab_size, DECODE_WARM + 2 * DECODE_STEPS)]
    pos = 0

    def steps(n: int) -> None:
        nonlocal pos
        for _ in range(n):
            lg, _ = step(params, cache, {"tokens": [[toks[pos]]]}, pos)
            int(torch.argmax(lg[0, -1]))
            pos += 1

    steps(DECODE_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(DECODE_STEPS)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / DECODE_STEPS * 1e6
    with profile(activities=acts) as prof:
        steps(DECODE_STEPS)
        torch.cuda.synchronize()
    summ = kernel_summary(prof)
    busy = summ["busy_us"] / DECODE_STEPS
    report(f"profile {cfg.name} decode step (1 lane, cache {DECODE_LEN}): " + json.dumps(
        {"kernels_per_step": summ["kernels"] / DECODE_STEPS, "busy_us_per_step": busy,
         "wall_us_per_step": wall_us, "idle_share": 1 - busy / wall_us, "top": summ["top"]}))


def _per_call(counts: dict, calls: int, what: str) -> list:
    return [f"{name} {n} x {calls} {what}" for name, n in counts.items()]


def drive_path(arch, kernel_mods, per_prefill, per_decode, report, profile):
    """One model's serving path at full width: prefill, consistency, serving
    (and with ``profile`` the profiler windows). ``per_prefill`` and
    ``per_decode`` give each of the path's kernels' launches per prefill call
    and per decode step; every launch count in ``kernel_mods`` is set to 0
    just before the prefill and read just after serving, and must equal what
    they give (0 for a kernel they do not name). Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import ServingEngine, make_prefill, make_serve_step

    cfg = get_config(arch)
    rwkv = cfg.family == "ssm"
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, dtype=torch.float32)
    n_params = sum(p.numel() for p in _leaves(params))
    attn_shape = f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}"
    if rwkv:
        shape = (f"{cfg.d_model // cfg.ssm_head_dim} wkv heads of {cfg.ssm_head_dim}, d_ff "
                 f"{cfg.d_ff}")
    elif cfg.family == "hybrid":
        shape = (f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, "
                 f"d_inner {cfg.d_inner}; {cfg.n_shared_attn} shared attention blocks of "
                 f"{attn_shape}, d_ff {cfg.d_ff}")
    else:
        shape = attn_shape
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {shape}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e6:.1f}M params fp32 on "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # ------------------------------------------------------------- prefill --
    for mod in kernel_mods.values():
        mod.launches = 0
    decode_steps = 0
    prefill = make_prefill(cfg)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_calls = 1
    if logits.shape != (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    del logits
    prefill_ms = cuda_ms(lambda: prefill(params, batch), PREFILL_ITERS, warmup=1)
    prefill_calls += 1 + PREFILL_ITERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = {name: kernel_mods[name].launches for name in per_prefill}
    if got != {name: n * prefill_calls for name, n in per_prefill.items()}:
        raise AssertionError(f"prefill launches {got} != "
                             f"{', '.join(_per_call(per_prefill, prefill_calls, 'calls'))}")
    report(f"{arch} prefill {PREFILL_BATCH}x{PREFILL_LEN}: {prefill_ms:.3f} ms, "
           f"{PREFILL_BATCH * PREFILL_LEN / prefill_ms * 1e3:.0f} tokens/s, peak memory "
           f"{peak_gb:.2f} GB, launches {json.dumps(got)} = "
           f"{', '.join(_per_call(per_prefill, prefill_calls, 'calls'))}")

    # --------------------------------------------------------- consistency --
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, CONSISTENCY_LEN)),
                             device="cuda")
    full = prefill(params, {"tokens": prompt})[0]
    # the same prompt as row 0 of a batch of 4: how far the forward agrees
    # with itself when only the GEMMs' shapes (and so their order of sums) change
    others = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, CONSISTENCY_LEN)),
                             device="cuda")
    batched = prefill(params, {"tokens": torch.cat([prompt, others])})[0]
    prefill_calls += 2
    step = make_serve_step(cfg)
    cache = tf.init_cache(cfg, 1, CONSISTENCY_LEN, dtype=torch.float32)
    dec = []
    for t in range(CONSISTENCY_LEN):
        lg, cache = step(params, cache, {"tokens": prompt[:, t:t + 1]}, t)
        dec.append(lg[0, 0])
    decode_steps += CONSISTENCY_LEN
    dec = torch.stack(dec)
    torch.cuda.synchronize()
    diff = (dec - full).abs().max().item()
    same_top1 = int((dec.argmax(-1) == full.argmax(-1)).sum())
    floor = (batched - full).abs().max().item()
    floor_top1 = int((batched.argmax(-1) == full.argmax(-1)).sum())
    rebatched = (f"the same prompt prefilled in a batch of 4 vs alone: max |diff| {floor:.3e}, "
                 f"argmax equal at {floor_top1}/{CONSISTENCY_LEN}")
    by_pos = " ".join(f"{x:.0e}" for x in (dec - full).abs().max(-1).values.tolist())
    if rwkv:
        prob_diff = (torch.softmax(dec, -1) - torch.softmax(full, -1)).abs().max().item()
        as_reference = same_top1 == CONSISTENCY_LEN
        within_floor = diff <= floor and same_top1 >= floor_top1
        if prob_diff > SSM_PROB_TOL or not (as_reference or within_floor):
            raise AssertionError(
                f"decode vs prefill: argmax equal at {same_top1}/{CONSISTENCY_LEN}, max |diff| "
                f"{diff:.3e}, max |softmax diff| {prob_diff:.3e}; {rebatched}")
        criterion = (f"max |softmax diff| {prob_diff:.3e} (tol {SSM_PROB_TOL}); {rebatched}; "
                     f"held to "
                     f"{'argmax equal everywhere' if as_reference else 'that re-batching noise'}")
    else:
        if not torch.allclose(dec, full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL):
            raise AssertionError(
                f"decode vs prefill: max |diff| {diff:.3e} beyond rtol=atol={CONSISTENCY_TOL}, "
                f"argmax equal at {same_top1}/{CONSISTENCY_LEN}; {rebatched}; max |diff| by "
                f"position: {by_pos}")
        criterion = f"rtol=atol={CONSISTENCY_TOL}; {rebatched}"
    report(f"{arch} consistency: decode vs prefill over {CONSISTENCY_LEN} positions, max "
           f"|diff| {diff:.3e}, max |logit| {full.abs().max().item():.1f} ({criterion}); "
           f"argmax equal at {same_top1}/{CONSISTENCY_LEN}; max |diff| by position: {by_pos}")
    del cache, full, batched

    # ------------------------------------------------------------- serving --
    eng = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN)
    for _ in range(REQUESTS):
        eng.submit([int(x) for x in rng.integers(1, cfg.vocab_size, PROMPT_LEN)],
                   max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    decode_steps += ENGINE_STEPS
    n_tok = sum(len(r.generated) for r in done)
    if len(done) != REQUESTS or any(len(r.generated) != NEW_TOKENS for r in done):
        raise AssertionError(f"engine finished {len(done)} requests: "
                             f"{[len(r.generated) for r in done]}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("engine produced a token outside the vocabulary")
    report(f"{arch} serving: {len(done)} requests, {n_tok} new tokens ({ENGINE_STEPS} decode "
           f"steps with prompts) in {serve_s:.3f} s, {n_tok / serve_s:.1f} new tokens/s, "
           f"{serve_s / ENGINE_STEPS * 1e3:.1f} ms per step")
    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    want = {name: per_prefill.get(name, 0) * prefill_calls
            + per_decode.get(name, 0) * decode_steps for name in kernel_mods}
    how = " + ".join(_per_call(per_prefill, prefill_calls, "prefill calls")
                     + _per_call(per_decode, decode_steps, "decode steps"))
    if launches != want:
        raise AssertionError(f"{arch} main path launched {launches}, want {want} ({how})")
    report(f"{arch} launches on the main path: {json.dumps(launches)} = {how}")
    del eng

    if profile:
        profile_phase(cfg, params, prefill, batch, step, tf.init_cache, rng, report)
    return launches


def check_flash_attention(fa_kernel, mha_reference, report) -> float:
    """The flash-attention kernel against its plain version; returns the
    larger error at the two prefill shapes (qwen3-0.6b, zamba2-7b) in fp32."""
    # (b, s, H, G, hd, window, dtype, tol, label): tests/test_kernels.py:28-85
    # shapes and tolerances, head dims 112 (zamba2-7b's shared blocks: MHA,
    # 32 heads) and 120 (h2o-danube-3-4b, windowed), plus the prefills'
    # attention shapes, where the kernel's online softmax sums 1024 terms in
    # another order than the plain dense softmax (held to 1e-4).
    # bf16 3e-2 is near the size of the outputs themselves (~1/sqrt(row)),
    # so in bf16 the kernel is also held to at most twice the plain bf16
    # version's own error, both against fp32 math on the same bf16 inputs.
    cases = [
        (2, 64, 4, 4, 32, None, torch.float32, 2e-5, "MHA"),
        (2, 64, 8, 2, 32, None, torch.float32, 2e-5, "GQA 4:1"),
        (2, 96, 4, 1, 64, None, torch.float32, 2e-5, "MQA ragged s=96"),
        (2, 128, 2, 2, 16, None, torch.float32, 2e-5, "hd 16"),
        (1, 128, 4, 2, 32, 16, torch.float32, 2e-5, "window 16"),
        (1, 128, 4, 2, 32, 32, torch.float32, 2e-5, "window 32"),
        (1, 128, 4, 2, 32, 100, torch.float32, 2e-5, "window 100"),
        (1, 64, 4, 2, 32, None, torch.bfloat16, 3e-2, "bf16"),
        (1, 200, 8, 4, 256, None, torch.float32, 2e-5, "hd 256 ragged"),
        (PREFILL_BATCH, PREFILL_LEN, 16, 8, 128, None, torch.bfloat16, 3e-2, "prefill bf16"),
        (PREFILL_BATCH, PREFILL_LEN, 16, 8, 128, None, torch.float32, 1e-4, "prefill fp32"),
        (2, 96, 32, 32, 112, None, torch.float32, 2e-5, "hd 112 MHA"),
        (1, 64, 4, 4, 112, None, torch.bfloat16, 3e-2, "hd 112 bf16"),
        (1, 130, 4, 2, 120, 64, torch.float32, 2e-5, "hd 120 window 64 ragged"),
        (1, 64, 4, 2, 120, None, torch.bfloat16, 3e-2, "hd 120 bf16"),
        (PREFILL_BATCH, PREFILL_LEN, 32, 32, 112, None, torch.float32, 1e-4,
         "zamba2 prefill fp32"),
    ]
    slice_err = 0.0
    for i, (b, s, H, G, hd, window, dtype, tol, label) in enumerate(cases):
        q, k, v = qkv(b, s, H, G, hd, seed=SEED + i, dtype=dtype)
        out = fa_kernel.flash_attention_cuda(q, k, v, causal=True, window=window)
        ref = mha_reference(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        extra = ""
        if dtype == torch.bfloat16:
            exact = mha_reference(q.float(), k.float(), v.float(), causal=True, window=window)
            k_err = (out.float() - exact).abs().max().item()
            p_err = (ref.float() - exact).abs().max().item()
            if k_err > 2 * p_err:
                raise AssertionError(f"bf16 {label}: kernel error {k_err:.3e} vs fp32 math is "
                                     f"above twice the plain version's {p_err:.3e}")
            extra = f"; vs fp32 math: kernel {k_err:.3e}, plain bf16 {p_err:.3e} (want <= 2x)"
        torch.cuda.synchronize()
        report(f"kernel check flash_attention {label} b={b} s={s} H={H} G={G} hd={hd} "
               f"window={window} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol}){extra}")
        if label.endswith("prefill fp32"):
            slice_err = max(slice_err, err)
    q, k, v = qkv(1, 64, 2, 2, 32, seed=SEED, dtype=torch.float32, ones_v=True)
    out = fa_kernel.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-5, atol=1e-5)
    report("kernel check flash_attention rows sum to one (v = 1): ok")
    return slice_err


def check_wkv6(wkv6_kernel, report) -> float:
    """The wkv6 kernel against wkv6_reference; returns the error at the
    rwkv6-7b prefill shape."""
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_reference

    # (b, s, H, P, state scale): the TestWKV6 inputs, tests/test_kernels.py:
    # 199-229 (s 48/64/50 at P 16, the nonzero state, s 16/32/40 at P 8)
    cases = [(1, 48, 2, 16, 0.0), (1, 64, 2, 16, 0.0), (1, 50, 2, 16, 0.0),
             (1, 32, 2, 16, 1.0), (1, 16, 2, 8, 0.0), (1, 32, 2, 8, 0.0), (1, 40, 2, 8, 0.0)]
    for i, (b, s, H, P, sc) in enumerate(cases):
        args = wkv6_inputs(b, s, H, P, seed=SEED + 100 + i, state_scale=sc)
        got = wkv6_kernel.wkv6_cuda(*args)
        want = wkv6_reference(*args)
        chunked = wkv6_chunked(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=WKV6_TOL, atol=WKV6_TOL)
        for c, g in zip(chunked, got):
            torch.testing.assert_close(c, g, rtol=WKV6_CHUNKED_TOL, atol=WKV6_CHUNKED_TOL)
        report(f"kernel check wkv6 TestWKV6 b={b} s={s} H={H} P={P} state={sc}: max_abs_err "
               f"{max_err(got, want):.3e} (tol {WKV6_TOL}); chunked plain version vs kernel "
               f"{max_err(chunked, got):.3e} (tol {WKV6_CHUNKED_TOL})")

    args = wkv6_inputs(1, 64, 2, 16, seed=SEED + 4)
    y8 = wkv6_kernel.wkv6_cuda(*args, chunk=8)
    y32 = wkv6_kernel.wkv6_cuda(*args, chunk=32)
    torch.cuda.synchronize()
    for a, b in zip(y8, y32):
        torch.testing.assert_close(a, b, rtol=WKV6_TILE_TOL, atol=WKV6_TILE_TOL)
    report(f"kernel check wkv6 tile 8 vs 32 (s=64, P=16): max diff {max_err(y8, y32):.3e} "
           f"(tol {WKV6_TILE_TOL})")

    b, s, H, P = PREFILL_BATCH, PREFILL_LEN, 64, 64
    args = wkv6_inputs(b, s, H, P, seed=SEED + 5, model_decay=True)
    got = wkv6_kernel.wkv6_cuda(*args)
    want = wkv6_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=WKV6_PREFILL_TOL, atol=WKV6_PREFILL_TOL)
    prefill_err = max_err(got, want)
    report(f"kernel check wkv6 prefill b={b} s={s} H={H} P={P}, w = exp(-exp(N(0, 0.5))): "
           f"max_abs_err {prefill_err:.3e} (tol {WKV6_PREFILL_TOL}), max |y| "
           f"{want[0].abs().max().item():.2f}")

    args = wkv6_inputs(1, 1, H, P, seed=SEED + 6, state_scale=0.5, model_decay=True)
    state = args[5]
    want = wkv6_reference(*args[:5], state.clone())
    y, out = wkv6_kernel.wkv6_cuda(*args, state_out=state)
    torch.cuda.synchronize()
    if out is not state:
        raise AssertionError("wkv6 did not write the state in place")
    for g, w in zip((y, state), want):
        torch.testing.assert_close(g, w, rtol=WKV6_TOL, atol=WKV6_TOL)
    report(f"kernel check wkv6 decode step b=1 s=1 H={H} P={P}, state written in place: "
           f"max_abs_err {max_err((y, state), want):.3e} (tol {WKV6_TOL})")
    return prefill_err


def check_ssd_scan(ssd_kernel, report) -> float:
    """The SSD-scan kernel against ssd_reference (y and the final state);
    returns the error at the zamba2-7b prefill shape."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_reference

    # (s, tile): the TestSSDScan (s, chunk) pairs, tests/test_kernels.py:148,
    # at b=1, H=2, P=16, N=8, the TPU kernel's chunk taken as the tile
    for i, (s, tile) in enumerate([(64, 16), (64, 64), (96, 32), (100, 32)]):
        args = ssd_inputs(1, s, 2, 16, 8, seed=SEED + 200 + i)
        got = ssd_kernel.ssd_scan_cuda(*args, chunk=tile)
        want = ssd_reference(*args)
        chunked = ssd_chunked(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL)
        torch.testing.assert_close(chunked, got[0], rtol=SSD_CHUNKED_TOL, atol=SSD_CHUNKED_TOL)
        report(f"kernel check ssd_scan TestSSDScan b=1 s={s} H=2 P=16 N=8 tile={tile}: "
               f"max_abs_err (y, final state) {max_err(got, want):.3e} (tol {SSD_TOL}); "
               f"chunked plain version vs kernel {max_err([chunked], got[:1]):.3e} "
               f"(tol {SSD_CHUNKED_TOL})")

    # the property sweep, tests/test_kernels.py:176-184, every draw
    sweep = []
    for s in (32, 48, 64):
        for P in (8, 16):
            for N in (4, 8):
                args = ssd_inputs(1, s, 2, P, N, seed=s + P + N)
                got = ssd_kernel.ssd_scan_cuda(*args, chunk=16)
                want = ssd_reference(*args)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=SSD_SWEEP_TOL, atol=SSD_SWEEP_TOL)
                sweep.append(max_err(got, want))
    report(f"kernel check ssd_scan sweep s in (32, 48, 64), P in (8, 16), N in (4, 8), "
           f"tile 16: max_abs_err {max(sweep):.3e} over {len(sweep)} shapes "
           f"(tol {SSD_SWEEP_TOL})")

    args = ssd_inputs(1, 100, 4, 64, 64, seed=SEED + 210)
    outs = [ssd_kernel.ssd_scan_cuda(*args, chunk=c) for c in (8, 32, 42)]
    torch.cuda.synchronize()
    for y, h in outs[1:]:
        if not (torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])):
            raise AssertionError("ssd_scan: tiles 8, 32 and 42 do not agree bit for bit")
    report("kernel check ssd_scan tiles 8, 32, 42 (s=100, P=64, N=64): bit-equal")

    b, s, H, P, N = PREFILL_BATCH, PREFILL_LEN, 112, 64, 64
    args = ssd_inputs(b, s, H, P, N, seed=SEED + 211)
    got = ssd_kernel.ssd_scan_cuda(*args)
    want = ssd_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=SSD_PREFILL_TOL, atol=SSD_PREFILL_TOL)
    prefill_err = max_err(got, want)
    report(f"kernel check ssd_scan prefill b={b} s={s} H={H} P={P} N={N}: max_abs_err "
           f"(y, final state) {prefill_err:.3e} (tol {SSD_PREFILL_TOL}), max |y| "
           f"{want[0].abs().max().item():.2f}, max |h| {want[1].abs().max().item():.2f}")
    return prefill_err


def time_flash(fa_kernel, mha_reference, hw, b, s, H, G, hd, report) -> dict:
    """Kernel, plain and SDPA time of causal fp32 attention at one shape,
    and its bound."""
    q, k, v = qkv(b, s, H, G, hd, seed=SEED, dtype=torch.float32)
    kernel_ms = cuda_ms(lambda: fa_kernel.flash_attention_cuda(q, k, v), 20)
    plain_ms = cuda_ms(lambda: mha_reference(q, k, v), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    kernel_ms2 = cuda_ms(lambda: fa_kernel.flash_attention_cuda(q, k, v), 20)
    pairs = s * (s + 1) // 2  # causal: the (row, col) pairs this run needs
    flops = 4 * hd * b * H * pairs
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v)) + q.numel() * 4
    bound_s, bound_by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    report(f"timing flash_attention fp32 b={b} s={s} H={H} G={G} hd={hd} causal: kernel "
           f"{kernel_ms:.4f} / {kernel_ms2:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA, "
           f"enable_gqa) {library_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms by {bound_by} "
           f"({flops / 1e9:.2f} GFLOP at fp32 CUDA-core peak {hw.FP32_FLOPS / 1e12:.0f} "
           f"TFLOP/s; {n_bytes / 1e6:.1f} MB at {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break prefill and decode time down by kernel (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.kernels import SOURCES, _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import mha_reference
    from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_reference
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_reference

    # ---------------------------------------------------------------- setup --
    t_start = time.time()
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: fp32 products run in full fp32")

    def report(msg: str) -> None:
        print(f"{msg}  [{card}]")

    t0 = time.time()
    built = _build.build(SOURCES)
    for b in built.values():
        summary = [ln for ln in b.log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"built {b.name} -> {b.path.name}" + ("" if b.log else " (cached)"))
        for ln in summary:
            print(f"  ptxas: {ln.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    # --------------------------------------------------------- kernel check --
    fa_err = check_flash_attention(fa_kernel, mha_reference, report)
    wkv6_err = check_wkv6(wkv6_kernel, report)
    ssd_err = check_ssd_scan(ssd_kernel, report)

    # ---------------------------------------------------------- main paths --
    kernel_mods = {"flash_attention": fa_kernel, "wkv6": wkv6_kernel, "ssd_scan": ssd_kernel}
    launches = {name: 0 for name in kernel_mods}
    for arch, per_prefill, per_decode in PATHS:
        path = drive_path(arch, kernel_mods, per_prefill, per_decode, report, args.profile)
        launches = {name: launches[name] + path[name] for name in kernel_mods}
        torch.cuda.empty_cache()  # the path's weights are gone; hand their memory back

    # ----------------------------------------------------------- timing --
    cfg = get_config(ARCH)
    b, s = PREFILL_BATCH, PREFILL_LEN
    fa_times = time_flash(fa_kernel, mha_reference, hw, b, s, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, report)
    zcfg = get_config(ZAMBA_ARCH)
    time_flash(fa_kernel, mha_reference, hw, b, s, zcfg.num_heads, zcfg.num_kv_heads,
               zcfg.resolved_head_dim, report)
    fa_row = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
              "launches": launches["flash_attention"], "max_abs_err": fa_err, **fa_times}

    rcfg = get_config(RWKV_ARCH)
    P = rcfg.ssm_head_dim
    H = rcfg.d_model // P
    wargs = wkv6_inputs(b, s, H, P, seed=SEED + 5, model_decay=True)
    wkv_ms = cuda_ms(lambda: wkv6_kernel.wkv6_cuda(*wargs), 20)
    wkv_plain_ms = cuda_ms(lambda: wkv6_chunked(*wargs), 5)
    wkv_seq_ms = cuda_ms(lambda: wkv6_reference(*wargs), 2, warmup=1)
    wkv_ms2 = cuda_ms(lambda: wkv6_kernel.wkv6_cuda(*wargs), 20)
    flops = 5 * b * s * H * P * P  # r.S (2 P^2) and w*S + k*v (3 P^2) a step and head
    n_bytes = sum(x.numel() * 4 for x in wargs) + wargs[0].numel() * 4 + wargs[5].numel() * 4
    wbound_s, wbound_by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    report(f"timing wkv6 fp32 b={b} s={s} H={H} P={P}: kernel {wkv_ms:.4f} / {wkv_ms2:.4f} ms, "
           f"plain (wkv6_chunked) {wkv_plain_ms:.4f} ms, sequential plain (wkv6_reference) "
           f"{wkv_seq_ms:.4f} ms, library none (no PyTorch call computes this recurrence), "
           f"bound {wbound_s * 1e3:.4f} ms by {wbound_by} ({n_bytes / 1e6:.1f} MB at "
           f"{hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s; {flops / 1e9:.2f} GFLOP at fp32 CUDA-core "
           f"peak {hw.FP32_FLOPS / 1e12:.0f} TFLOP/s)")
    wkv_row = {"name": "wkv6", "route": "cuda",
               "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
               "replaces": "src/repro/kernels/rwkv6/kernel.py:57",
               "launches": launches["wkv6"], "max_abs_err": wkv6_err, "ms": wkv_ms,
               "plain_ms": wkv_plain_ms, "bound_ms": wbound_s * 1e3, "bound_by": wbound_by,
               "library_ms": None}
    del wargs

    H, P, N = zcfg.ssm_heads, zcfg.ssm_head_dim, zcfg.ssm_state
    sargs = ssd_inputs(b, s, H, P, N, seed=SEED + 211)
    ssd_ms = cuda_ms(lambda: ssd_kernel.ssd_scan_cuda(*sargs), 20)
    ssd_plain_ms = cuda_ms(lambda: ssd_chunked(*sargs), 5)
    ssd_seq_ms = cuda_ms(lambda: ssd_reference(*sargs), 2, warmup=1)
    ssd_ms2 = cuda_ms(lambda: ssd_kernel.ssd_scan_cuda(*sargs), 20)
    flops = 4 * b * s * H * P * N  # decay*h + (dt x) B and C.h: 4 N P a step and head
    n_bytes = 4 * (sum(x.numel() for x in sargs) + sargs[0].numel() + b * H * N * P)
    sbound_s, sbound_by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    report(f"timing ssd_scan fp32 b={b} s={s} H={H} P={P} N={N}: kernel {ssd_ms:.4f} / "
           f"{ssd_ms2:.4f} ms, plain (ssd_chunked) {ssd_plain_ms:.4f} ms, sequential plain "
           f"(ssd_reference) {ssd_seq_ms:.4f} ms, library none (no PyTorch call computes the "
           f"SSD scan), bound {sbound_s * 1e3:.4f} ms by {sbound_by} ({flops / 1e9:.2f} GFLOP "
           f"at fp32 CUDA-core peak {hw.FP32_FLOPS / 1e12:.0f} TFLOP/s; {n_bytes / 1e6:.1f} MB "
           f"at {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    ssd_row = {"name": "ssd_scan", "route": "cuda",
               "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
               "replaces": "src/repro/kernels/ssd_scan/kernel.py:78",
               "launches": launches["ssd_scan"], "max_abs_err": ssd_err, "ms": ssd_ms,
               "plain_ms": ssd_plain_ms, "bound_ms": sbound_s * 1e3, "bound_by": sbound_by,
               "library_ms": None}
    print(f"total: {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [fa_row, wkv_row, ssd_row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
