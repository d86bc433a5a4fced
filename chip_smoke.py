#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a non-zero exit:

1. setup: card name and power limit (nvidia-smi), TF32 off, build every CUDA
   kernel from the sources in this checkout with nvcc (sm_90a), one nvcc per
   source, all started together;
2. kernel check: each kernel against its plain PyTorch version on the card
   (flash attention; wkv6, also against its tile size and with the state
   updated in place);
3. two main paths at full width, fp32, random weights from a seed, one after
   the other (the first one's weights are freed before the second):
   qwen3-0.6b (28 layers, the flash-attention kernel) and rwkv6-7b
   (32 layers, 7.57 B params, the wkv6 kernel). Each runs
   a. prefill: 4 prompts x 1024 tokens through ``make_prefill``;
   b. consistency: one 32-token prompt decoded token by token through
      ``make_serve_step`` reproduces the prefill logits;
   c. serving: ``ServingEngine`` (4 slots) drains 8 requests;
   d. with ``--profile`` only: where the time goes, from ``torch.profiler``
      windows over one prefill and over one-lane decode steps;
4. timing: each kernel, its plain version and the PyTorch library call (where
   one exists) at its prefill shape, beside the card's bound.

Every launch count is set to 0 just before a path's prefill and read just
after its serving phase: the path's kernel must have launched once per layer
and per call, and the other kernels not at all. The last three lines are the
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
PREFILL_BATCH, PREFILL_LEN, PREFILL_ITERS = 4, 1024, 3
CONSISTENCY_LEN = 32
SLOTS, MAX_LEN, REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 256, 8, 16, 16
# the engine decodes each prompt token once, then re-feeds the last one as
# the first of NEW_TOKENS generating steps
ENGINE_STEPS = REQUESTS * (PROMPT_LEN + NEW_TOKENS)
# rtol = atol on the consistency check: the reference test's own logits
# tolerance (tests/test_models.py:111); fp32 sums in another order (kernel
# vs einsum decode) differ by ~1e-6 relative on logits of size ~1e3.
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


def drive_path(arch, kernel_mods, path_kernel, report, profile):
    """One model's serving path at full width: prefill, consistency, serving
    (and with ``profile`` the profiler windows). Every launch count in
    ``kernel_mods`` is set to 0 just before the prefill and read just after
    serving; returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import ServingEngine, make_prefill, make_serve_step

    cfg = get_config(arch)
    rwkv = cfg.family == "ssm"
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, dtype=torch.float32)
    n_params = sum(p.numel() for p in _leaves(params))
    shape = (f"{cfg.d_model // cfg.ssm_head_dim} wkv heads of {cfg.ssm_head_dim}, d_ff "
             f"{cfg.d_ff}" if rwkv else f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
             f"{cfg.resolved_head_dim}")
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, {shape}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e6:.1f}M params fp32 on "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # ------------------------------------------------------------- prefill --
    for mod in kernel_mods.values():
        mod.launches = 0
    decode_steps = 0  # the path kernel launches per layer at every decode step (rwkv)
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
    kmod = kernel_mods[path_kernel]
    if kmod.launches != cfg.num_layers * prefill_calls:
        raise AssertionError(f"{path_kernel} launches {kmod.launches} != "
                             f"{cfg.num_layers} x {prefill_calls} prefill calls")
    report(f"{arch} prefill {PREFILL_BATCH}x{PREFILL_LEN}: {prefill_ms:.3f} ms, "
           f"{PREFILL_BATCH * PREFILL_LEN / prefill_ms * 1e3:.0f} tokens/s, peak memory "
           f"{peak_gb:.2f} GB, {path_kernel} launches {kmod.launches} = "
           f"{cfg.num_layers} x {prefill_calls} calls")

    # --------------------------------------------------------- consistency --
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, CONSISTENCY_LEN)),
                             device="cuda")
    full = prefill(params, {"tokens": prompt})[0]
    prefill_calls += 1
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
    if rwkv:
        others = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, CONSISTENCY_LEN)),
                                 device="cuda")
        batched = prefill(params, {"tokens": torch.cat([prompt, others])})[0]
        prefill_calls += 1
        torch.cuda.synchronize()
        floor = (batched - full).abs().max().item()
        floor_top1 = int((batched.argmax(-1) == full.argmax(-1)).sum())
        prob_diff = (torch.softmax(dec, -1) - torch.softmax(full, -1)).abs().max().item()
        as_reference = same_top1 == CONSISTENCY_LEN
        within_floor = diff <= floor and same_top1 >= floor_top1
        if prob_diff > SSM_PROB_TOL or not (as_reference or within_floor):
            raise AssertionError(
                f"decode vs prefill: argmax equal at {same_top1}/{CONSISTENCY_LEN}, max |diff| "
                f"{diff:.3e}, max |softmax diff| {prob_diff:.3e}; prefill in a batch of 4 vs "
                f"alone: max |diff| {floor:.3e}, argmax equal at {floor_top1}/{CONSISTENCY_LEN}")
        by_pos = " ".join(f"{x:.0e}" for x in (dec - full).abs().max(-1).values.tolist())
        criterion = (f"max |softmax diff| {prob_diff:.3e} (tol {SSM_PROB_TOL}); the same prompt "
                     f"prefilled in a batch of 4 vs alone: max |diff| {floor:.3e}, argmax equal "
                     f"at {floor_top1}/{CONSISTENCY_LEN}; held to "
                     f"{'argmax equal everywhere' if as_reference else 'that re-batching noise'}"
                     f"; max |diff| by position: {by_pos}")
    else:
        torch.testing.assert_close(dec, full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
        criterion = f"rtol=atol={CONSISTENCY_TOL}"
    report(f"{arch} consistency: decode vs prefill over {CONSISTENCY_LEN} positions, max "
           f"|diff| {diff:.3e}, max |logit| {full.abs().max().item():.1f} ({criterion}); "
           f"argmax equal at {same_top1}/{CONSISTENCY_LEN}")
    del cache

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
    want = {name: 0 for name in kernel_mods}
    want[path_kernel] = cfg.num_layers * (prefill_calls + (decode_steps if rwkv else 0))
    if launches != want:
        raise AssertionError(f"{arch} main path launched {launches}, want {want} ("
                             f"{cfg.num_layers} layers, {prefill_calls} prefill calls"
                             + (f", {decode_steps} decode steps)" if rwkv else ")"))
    report(f"{arch} launches on the main path: {json.dumps(launches)} = {cfg.num_layers} x "
           f"({prefill_calls} prefill calls" + (f" + {decode_steps} decode steps)" if rwkv
                                                else ")"))
    del eng

    if profile:
        profile_phase(cfg, params, prefill, batch, step, tf.init_cache, rng, report)
    return launches


def check_flash_attention(fa_kernel, mha_reference, report) -> float:
    """The flash-attention kernel against its plain version; returns the
    error at the prefill shape in fp32."""
    # (b, s, H, G, hd, window, dtype, tol, label): tests/test_kernels.py:28-85
    # shapes and tolerances, plus the prefill's attention shape, where the
    # kernel's online softmax sums 1024 terms in another order than the
    # plain dense softmax (measured error reported below, held to 1e-4).
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
    ]
    slice_err = None
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
        if label == "prefill fp32":
            slice_err = err
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

    # ---------------------------------------------------------- main paths --
    kernel_mods = {"flash_attention": fa_kernel, "wkv6": wkv6_kernel}
    fa_launches = drive_path(ARCH, kernel_mods, "flash_attention", report,
                             args.profile)["flash_attention"]
    torch.cuda.empty_cache()  # the qwen3 weights are gone; hand their memory back
    wkv6_launches = drive_path(RWKV_ARCH, kernel_mods, "wkv6", report, args.profile)["wkv6"]
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- timing --
    cfg = get_config(ARCH)
    b, s, H, G, hd = PREFILL_BATCH, PREFILL_LEN, cfg.num_heads, cfg.num_kv_heads, 128
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
    fa_row = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
              "launches": fa_launches, "max_abs_err": fa_err, "ms": kernel_ms,
              "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
              "library_ms": library_ms}
    del q, k, v, qt, kt, vt

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
               "launches": wkv6_launches, "max_abs_err": wkv6_err, "ms": wkv_ms,
               "plain_ms": wkv_plain_ms, "bound_ms": wbound_s * 1e3, "bound_by": wbound_by,
               "library_ms": None}
    print(f"total: {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [fa_row, wkv_row]}))
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
