#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a non-zero exit:

1. setup: card name and power limit (nvidia-smi), TF32 off, build every CUDA
   kernel from the sources in this checkout with nvcc (sm_90a);
2. kernel check: each kernel against its plain PyTorch version on the card;
3. prefill: qwen3-0.6b at full width (28 layers, fp32, random weights from a
   seed), 4 prompts x 1024 tokens through ``make_prefill``;
4. consistency: one 32-token prompt decoded token by token through
   ``make_serve_step`` reproduces the prefill logits;
5. serving: ``ServingEngine`` (4 slots) drains 8 requests;
6. with ``--profile`` only: where the time goes, from ``torch.profiler``
   windows over one prefill and over one-lane decode steps;
7. timing: each kernel, its plain version and the PyTorch library call at
   the prefill's attention shape, beside the card's bound.

The kernels' launch counts are set to 0 before phase 3 and read after phase
5. The last three lines are the kernels JSON, the card, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the rest
of the repository, it exits non-zero and prints no result.
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
PREFILL_BATCH, PREFILL_LEN, PREFILL_ITERS = 4, 1024, 3
CONSISTENCY_LEN = 32
SLOTS, MAX_LEN, REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 256, 8, 16, 16
# rtol = atol on the consistency check: the reference test's own logits
# tolerance (tests/test_models.py:111); fp32 sums in another order (kernel
# vs einsum decode) differ by ~1e-6 relative on logits of size ~1e3.
CONSISTENCY_TOL = 2e-3
DECODE_LEN, DECODE_WARM, DECODE_STEPS = 256, 5, 20  # --profile decode window


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
    report(f"profile prefill {PREFILL_BATCH}x{PREFILL_LEN}: {json.dumps(summ)}")

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
    report(f"profile decode step (1 lane, cache {DECODE_LEN}): " + json.dumps(
        {"kernels_per_step": summ["kernels"] / DECODE_STEPS, "busy_us_per_step": busy,
         "wall_us_per_step": wall_us, "idle_share": 1 - busy / wall_us, "top": summ["top"]}))


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
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import ServingEngine, make_prefill, make_serve_step

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

    # ------------------------------------------------- main path: prefill --
    cfg = get_config(ARCH)
    fa_kernel.launches = 0
    params = tf.init_params(cfg, seed=SEED, dtype=torch.float32)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}, {n_params / 1e6:.1f}M params "
          f"fp32 on {torch.cuda.get_device_name(0)}")
    prefill = make_prefill(cfg)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
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
    if fa_kernel.launches != cfg.num_layers * prefill_calls:
        raise AssertionError(f"flash_attention launches {fa_kernel.launches} != "
                             f"{cfg.num_layers} x {prefill_calls} prefill calls")
    report(f"prefill {PREFILL_BATCH}x{PREFILL_LEN}: {prefill_ms:.3f} ms, "
           f"{PREFILL_BATCH * PREFILL_LEN / prefill_ms * 1e3:.0f} tokens/s, peak memory "
           f"{peak_gb:.2f} GB, flash_attention launches {fa_kernel.launches} = "
           f"{cfg.num_layers} x {prefill_calls} calls")

    # ------------------------------------------- main path: consistency --
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
    dec = torch.stack(dec)
    torch.cuda.synchronize()
    diff = (dec - full).abs().max().item()
    torch.testing.assert_close(dec, full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    report(f"consistency: decode vs prefill over {CONSISTENCY_LEN} positions, max |diff| "
           f"{diff:.3e}, max |logit| {full.abs().max().item():.1f} "
           f"(rtol=atol={CONSISTENCY_TOL}); argmax equal at "
           f"{int((dec.argmax(-1) == full.argmax(-1)).sum())}/{CONSISTENCY_LEN}")
    del cache

    # ----------------------------------------------- main path: serving --
    eng = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN)
    for _ in range(REQUESTS):
        eng.submit([int(x) for x in rng.integers(1, cfg.vocab_size, PROMPT_LEN)],
                   max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in done)
    if len(done) != REQUESTS or any(len(r.generated) != NEW_TOKENS for r in done):
        raise AssertionError(f"engine finished {len(done)} requests: "
                             f"{[len(r.generated) for r in done]}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("engine produced a token outside the vocabulary")
    report(f"serving: {len(done)} requests, {n_tok} new tokens ({REQUESTS * (PROMPT_LEN + 1 + NEW_TOKENS)} "
           f"decode steps with prompts) in {serve_s:.3f} s, {n_tok / serve_s:.1f} new tokens/s")
    launches = fa_kernel.launches
    if launches != cfg.num_layers * prefill_calls:
        raise AssertionError(f"main path launched flash_attention {launches} times, want "
                             f"{cfg.num_layers} x {prefill_calls}")
    del eng

    # ------------------------------------------------ profile (optional) --
    if args.profile:
        profile_phase(cfg, params, prefill, batch, step, tf.init_cache, rng, report)
    del params

    # ----------------------------------------------------------- timing --
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
    print(f"total: {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        "launches": launches,
        "max_abs_err": slice_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
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
