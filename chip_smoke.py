#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a non-zero exit:

1. setup: card name and power limit (nvidia-smi), TF32 off, build every CUDA
   kernel from the sources in this checkout with nvcc (sm_90a), one nvcc per
   source, all started together;
2. kernel check: each kernel against its plain PyTorch version on the card
   (flash attention, head dims 112, 120 and 256 included, gemma3-4b's band
   beyond its window too; wkv6, also against its tile size and with the
   state updated in place; the SSD scan, y and final
   state, also against the chunked plain version and its tile size; the INT8
   GEMM bit for bit, w row-major and column-major, at the TestGemmInt8
   inputs and at few-block long-K shapes that split K, and the int32 wrap
   at K = 2^17);
3. eight serving paths at full width, fp32, random weights from a seed, one
   after the other (each one's weights are freed before the next):
   qwen3-0.6b (28 layers, the flash-attention kernel), gemma3-4b (34 layers,
   window 1024 on 5 of every 6, hd 256, a tied 262144-row head), rwkv6-7b (32 layers,
   7.57 B params, the wkv6 kernel), zamba2-7b (81 mamba layers and 13
   occurrences of 2 shared attention blocks, 6.95 B params, the SSD-scan and
   flash-attention kernels), dbrx-132b (MoE, 16 experts top-4; depth cut
   to 4 of 40 layers to fit the card), internvl2-76b (a 256-embedding patch
   prefix at prefill; depth cut to 8 of 80 layers) and musicgen-large (frame
   embeddings, MHA at hd 64; 48 layers, depth not cut) and grok-1-314b (MoE,
   8 geglu experts of d_ff 32768 top-2; depth cut to 3 of 64 layers), each
   of the last four through flash attention. Each runs
   a. prefill: 4 prompts x 1024 tokens (or frames) through ``make_prefill``
      (internvl2: with the patch prefix, which must change the logits);
   b. consistency: one 32-token prompt decoded token by token through
      ``make_serve_step`` reproduces the prefill logits (and the same prompt
      prefilled in a batch of 4 shows how far the forward agrees with
      itself). dbrx and grok drop (token, k) pairs at capacity in prefill
      and never in decode, so each is held to its prefill on a 4-token
      prompt (one dispatch group no longer than the capacity floor 4) and
      its 32-token prompt is reported, dropped pairs and all;
   c. serving: ``ServingEngine`` (4 slots) drains 8 requests (not for
      musicgen: the engine takes tokens only, as JAX's does);
   d. with ``--profile`` only: where the time goes, from ``torch.profiler``
      windows over one prefill and over one-lane decode steps;
4. the paper's INT8 PU GEMM on ResNet-50's own GEMMs: the 54 GEMM nodes of
   the network at 256x256 (22 distinct shapes, ``RESNET50_GEMMS``), at batch
   1 and 16, each node with its own operands and its w stored column-major,
   each output bit-equal to the plain version, the network timed;
5. the pipeline executor: h2o-danube-3-4b at full width (24 layers, sliding
   window 4096) in 4 stages on one CUDA stream each, the stage programs'
   tokens as CUDA events, 4 microbatches of 1 x 4608 tokens (beyond the
   window), against the plain forward on the same tokens at 2e-3, its token
   operations equal to what the programs prescribe;
   then the executor across processes on the same model, tokens and card:
   4 ranks over gloo (one stage a rank, the REQ/ACK tokens as messages over
   pinned B0/B1 buffers), params shared by CUDA IPC, against the plain
   forward at 2e-3 and the one-card executor (bit-equal expected), its
   token operations equal to the programs' and to the simulator copy's,
   the wall of a call, each stage's Compute and each message's D2H,
   send-recv and H2D;
6. training, fp32, AdamW, 4 x 1024 tokens of the token stream a step:
   qwen3-0.6b at full width and depth, rwkv6-7b (6 of 32 layers) and
   zamba2-7b (12 of 81 layers, two shared-attention occurrences) at full
   width: one step without remat and two with from the same state (the same
   loss and grad norm), the same step with the plain forward of the path's
   recurrence (attention for qwen3; a check, rwkv held to its measured
   re-batching noise where that is larger), 5 steps on one batch (the nll
   falls); for qwen3 a checkpoint after step 2 restored and steps 3-5 run
   again (params bit-equal). Each kernel runs forward once a layer of its
   kind a step (and again with remat); each backward is a plain version's
   gradient, recomputed (``FlashAttention``, ``WKV6``, ``SSDScan``);
7. timing: each kernel, its plain version and the PyTorch library call (where
   one exists) at its main-path shapes (flash attention at five, wkv6 at the
   prefill and at the decode step), beside the card's bound, and the
   backward of wkv6 and of the SSD scan at the training shape; each row of
   the kernels line says how (``timed``: ``events``, CUDA events around
   launches from Python, or ``graph``, device time from a CUDA graph); and
   the INT8 GEMM at each of ResNet-50's 22 shapes, one line a batch;
8. dse: the paper's three-step DSE in the port (no kernel): ResNet-50 on the
   U50's 5 + 5 PUs (the Step 1/2/3 counts, DP-A/B/C); the float64 torch
   scorer on the card against the numpy scorer at 35, 1088 and 4224
   configurations (every field at rtol 1e-9 / atol 1e-12; both timed warm,
   their phases, the torch scoring's device time); the H100-pool deployment
   DSE at 8 cards (``gpu_dse.<arch>`` rows) and its prediction for the h2o
   pipeline beside what four cards measured.

Every launch count is set to 0 just before a path's first call and read just
after its last: each of the path's kernels must have launched its expected
number of times (per prefill call and decode step, per network pass, per
pipeline and forward call, per train step), and the other kernels not at all. The last three
lines are the
kernels JSON, the card, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import ExitStack, contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.compiler import fuse, zoo  # noqa: E402
from repro_torch.compiler.graph import WEIGHTED_OPS  # noqa: E402

SEED = 0
ARCH = "qwen3-0.6b"
RWKV_ARCH = "rwkv6-7b"
ZAMBA_ARCH = "zamba2-7b"
MOE_ARCH, VLM_ARCH, AUDIO_ARCH = "dbrx-132b", "internvl2-76b", "musicgen-large"
GEMMA_ARCH = "gemma3-4b"
GROK_ARCH = "grok-1-314b"
# depth cuts, full width: fp32 dbrx-132b takes 13.0 GB a layer (16 experts of
# 3 x 6144 x 10752) + 4.9 GB of embedding and head, internvl2-76b 3.42 GB a
# layer + 8.7 GB; 4 and 8 layers leave room for the activations in 80 GB.
# grok-1-314b takes 19.68 GB a layer (8 geglu experts of 3 x 6144 x 32768,
# 19.33 GB, and attention) + 6.44 GB of embedding and head: 3 layers are
# 65.5 GB, and its prefill adds ~6-7 GB (dbrx's 4.6 GB above its params, with
# 1.5x wider expert activations and a 131072-row head), a ~72 GB peak
DEPTH = {MOE_ARCH: 4, VLM_ARCH: 8, GROK_ARCH: 3}
# launches of each kernel per prefill call and per decode step, by path:
# qwen3-0.6b has 28 attention layers, gemma3-4b 34 (window 1024 on 5 of every
# 6); rwkv6-7b 32 rwkv layers, whose decode runs the wkv6 kernel too;
# zamba2-7b 81 mamba layers (SSD scan) and 13 shared-attention occurrences,
# and its decode is plain tensor code; dbrx-132b and internvl2-76b an
# attention layer each of their 4 and 8 (grok-1-314b its 3), musicgen-large
# 48; their decode is plain tensor code
PATHS = [
    (ARCH, {"flash_attention": 28}, {}),
    (GEMMA_ARCH, {"flash_attention": 34}, {}),
    (RWKV_ARCH, {"wkv6": 32}, {"wkv6": 32}),
    (ZAMBA_ARCH, {"ssd_scan": 81, "flash_attention": 13}, {}),
    (MOE_ARCH, {"flash_attention": DEPTH[MOE_ARCH]}, {}),
    (VLM_ARCH, {"flash_attention": DEPTH[VLM_ARCH]}, {}),
    (AUDIO_ARCH, {"flash_attention": 48}, {}),
    (GROK_ARCH, {"flash_attention": DEPTH[GROK_ARCH]}, {}),
]
PREFILL_BATCH, PREFILL_LEN, PREFILL_ITERS = 4, 1024, 3
CONSISTENCY_LEN = 32
# dbrx-132b's consistency prompt: 4 tokens are one dispatch group whose
# capacity is the floor 4, so prefill can drop no pair, as decode never does
MOE_SHORT_LEN = 4
FRAME_SCALE = 0.02  # frame and patch embeddings ~ 0.02 N(0, 1), tests/test_models.py:14-23
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


def resnet50_gemms() -> list[tuple]:
    """The GEMM nodes of ResNet-50 at 256x256 as the port's compiler lowers
    and fuses them (``fuse(zoo.resnet50(256))``), one row per distinct shape
    in the order of its first node, named by that node: (name, m = output
    channels, n = positions per image, k = in_ch * kh * kw, relu, residual,
    count). 54 nodes in 22 rows; every one requantises by RESNET50_SHIFT.
    tests/test_torch_gemm_int8.py holds the table to the JAX package's
    lowering."""
    rows: dict[tuple, list] = {}
    for nd in fuse(zoo.resnet50(256)).nodes:
        if nd.op in WEIGHTED_OPS:
            key = (nd.m, nd.n, nd.k, nd.relu, nd.residual_input is not None)
            rows.setdefault(key, [nd.name, *key, 0])[-1] += 1
    return [tuple(row) for row in rows.values()]


RESNET50_GEMMS = resnet50_gemms()
RESNET50_SHIFT = 7
RESNET50_BATCHES, RESNET50_ITERS = (1, 16), 10
# the gemm_int8 row of the kernels line: layer3's 3x3 conv, the most frequent
# GEMM (6 a network), at batch 16: M = 16 x 256 positions, N = 256, K = 2304
GEMM_TIMED = ("layer3.0.conv2", 16)
PIPE_ARCH = "h2o-danube-3-4b"
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_MB, PIPE_LEN = 4, 4, 1, 4608
PIPE_TOL = 2e-3  # tests/test_runtime.py MULTIDEV_SCRIPT, the JAX pipeline's own
# the dse phase: ResNet-50 at 256x256 on the paper's U50 array (5 PU1x + 5
# PU2x) and the torch scorer on the card against the numpy scorer over the
# ResNet-50 analysis at three pools built as the U50 is (PU1x on SLR 0, PU2x
# on SLR 1): 35, 1088 and 4224 configurations, at the tolerance the JAX
# package holds its accelerator scorer to (tests/test_batched_dse.py:182-184);
# each backend timed warm over the whole score_details call, DSE_REPEATS
# times in turns, the median kept
DSE_POOLS, DSE_RTOL, DSE_ATOL, DSE_REPEATS = ((5, 5), (32, 32), (64, 64)), 1e-9, 1e-12, 5
GOPS_224EQ, U50_PEAK_TOPS = 7.72, 4.608  # examples/resnet50_dse.py
# the h2o pipeline across four ranks over NCCL, one rank a card, as measured
# on four H100s at 700 W (PERF.md section 6, tools/pipeline_ranks_cards.py):
# a warm call and the range of a stage's Compute; set beside gpu_deploy's
# prediction for the same deployment
PIPE_NCCL_CALL_MS, PIPE_NCCL_STAGE_MS = 1486.0, (196.6, 202.2)
# the executor across processes: PIPE_STAGES ranks on this card over gloo,
# calls of it (the first also starts each rank's cuBLAS and pins its
# buffers), the bound of the whole spawn, and how far its logits may be from
# the one-card executor's: the same kernels on the same inputs, so bit-equal
# is expected; the fp32 copies across processes are exact
PIPE_RANK_CALLS, PIPE_RANK_TIMEOUT_S, PIPE_RANK_ONE_CARD_TOL = 2, 420.0, 1e-5
# the training path: qwen3-0.6b at full width and depth, fp32, AdamW (no
# warmup, so that 5 steps on one repeated batch move the loss), the token
# stream at its vocabulary, 4 x 1024 tokens a step; a checkpoint after step
# TRAIN_RESUME_AT. Each step launches flash attention once a layer in the
# forward, and once more a layer with remat (the recomputed forward); the
# backward recomputes attention with the plain version, which launches none.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_RESUME_AT = ARCH, 4, 1024, 5, 2
TRAIN_LR = 1e-4
# the training paths, (arch, depth cut or None), in this order; rwkv6-7b and
# zamba2-7b at full width, their depth cut so that fp32 AdamW (16 B a param:
# params, grads, m, v) and a step fit the card beside the state the path
# keeps to start each phase from: rwkv6-7b 0.2197 B params a layer + 0.537 B
# of embedding and head, 6 of 32 layers = 1.855 B, 29.7 GB; zamba2-7b 12 of
# 81 layers (two shared-attention occurrences, so flash's gradient runs too)
# = 1.58 B, 25.3 GB. wkv6 launches once an rwkv layer a step, the SSD scan
# once a mamba layer, flash once an attention layer or shared occurrence;
# each twice with remat; each backward recomputes a plain version and
# launches none (PERF.md section 4)
TRAIN_PATHS = [(TRAIN_ARCH, None), (RWKV_ARCH, 6), (ZAMBA_ARCH, 12)]
# remat vs not: the same kernels on the same inputs, so ~0 is expected; the
# kernel's forward vs the plain one: ~1e-6 relative on the loss (the kernel's
# fp32 sums in another order), and the gradient flows through activations
# that differ by as much. Random rwkv layers amplify fp32 rounding: at 6
# layers the plain fp32 recurrence's own step is 9.5e-5 off the grad norm of
# the same step with the recurrence in float64, and the kernel's 4.7e-5
# (PERF.md section 6), so a recurrence's check also reads that noise
TRAIN_TOL, TRAIN_PLAIN_GRAD_TOL = 1e-5, 1e-4


def _demangle(names: list[str]) -> dict[str, str]:
    """Mangled kernel names -> ``name<args>`` (c++filt where there is one)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    short = (d.replace("(anonymous namespace)::", "").split("(")[0] for d in out)
    return {n: d.removeprefix("void ") for n, d in zip(names, short)}


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers and spills from nvcc's -Xptxas -v output."""
    rows, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            rows[fn] = ["", ""]
        elif fn and "spill stores" in ln:
            rows[fn][1] = ln.strip()
        elif fn and "Used" in ln:
            rows[fn][0] = ln.split("Used", 1)[1].strip()
    names = _demangle(list(rows))
    return {names[fn]: tuple(v) for fn, v in rows.items()}


def sass_mma_counts(lib: Path) -> dict:
    """The tensor-core MMA instructions of each kernel in a built library, by
    opcode, from ``cuobjdump -sass`` ({} where the toolkit has none)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = defaultdict(int)
        m = re.search(r"\b([HI]G?MMA\.[\w.]+)", ln)
        if fn and m:
            counts[fn][m.group(1)] += 1
    names = _demangle(list(counts))
    return {names[fn]: ", ".join(f"{op} x {n}" for op, n in sorted(c.items()))
            for fn, c in counts.items() if c}


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


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device time a call of ``fn``, from a CUDA graph of ``calls`` calls
    replayed ``replays`` times: the host's cost of a launch (the wrapper's
    checks, ctypes) stays out of the timed region, unlike ``cuda_ms``."""
    side = torch.cuda.Stream()  # warm on a side stream, as PyTorch's CUDA-graph notes ask
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


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
    """Device time by kernel name and the union of kernel intervals (us);
    a scheduled window's ``ProfilerStep`` span is not a kernel."""
    from torch.autograd import DeviceType

    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
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


def profile_window(fn, wall_ms: float) -> dict:
    """A profiler window over a second call of ``fn`` (the first warms the
    tracer, which can miss a window's first kernels): device time by kernel,
    busy time (the union of kernel intervals) and the idle share 1 - busy /
    ``wall_ms``, the unprofiled wall of the same work. Calls ``fn`` twice."""
    from torch.profiler import ProfilerActivity, profile, schedule

    done = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(kernel_summary(p))) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    summ = done[0]
    summ.update(wall_us=wall_ms * 1e3, idle_share=1 - summ["busy_us"] / (wall_ms * 1e3))
    return summ


def profile_phase(cfg, params, prefill, batch, step, init_cache, step_input, report) -> None:
    """Wall time without the profiler (CUDA events for prefill, host clock
    around synchronised steps for decode), then a profiler window over the
    same work (``profile_window``). ``step_input(pos)`` is decode step
    ``pos``'s batch."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    prefill(params, batch)
    end.record()
    end.synchronize()
    summ = profile_window(lambda: prefill(params, batch), start.elapsed_time(end))
    report(f"profile {cfg.name} prefill {PREFILL_BATCH}x{PREFILL_LEN}: {json.dumps(summ)}")

    # one lane (what ServingEngine._step_slot runs); the engine reads each token
    cache = init_cache(cfg, 1, DECODE_LEN, dtype=torch.float32)
    pos = 0

    def steps(n: int) -> None:
        nonlocal pos
        for _ in range(n):
            lg, _ = step(params, cache, step_input(pos), pos)
            int(torch.argmax(lg[0, -1]))
            pos += 1

    steps(DECODE_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(DECODE_STEPS)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    summ = profile_window(lambda: steps(DECODE_STEPS), wall_ms)
    busy = summ["busy_us"] / DECODE_STEPS
    wall_us = wall_ms * 1e3 / DECODE_STEPS
    report(f"profile {cfg.name} decode step (1 lane, cache {DECODE_LEN}): " + json.dumps(
        {"kernels_per_step": summ["kernels"] / DECODE_STEPS, "busy_us_per_step": busy,
         "wall_us_per_step": wall_us, "idle_share": 1 - busy / wall_us, "top": summ["top"]}))


def _per_call(counts: dict, calls: int, what: str) -> list:
    return [f"{name} {n} x {calls} {what}" for name, n in counts.items()]


def drive_path(arch, kernel_mods, per_prefill, per_decode, report, profile):
    """One model's serving path at full width (depth cut where DEPTH says):
    prefill, consistency, serving (and with ``profile`` the profiler
    windows). ``per_prefill`` and ``per_decode`` give each of the path's
    kernels' launches per prefill call and per decode step; every launch
    count in ``kernel_mods`` is set to 0 just before the prefill and read
    just after serving, and must equal what they give (0 for a kernel they
    do not name). Returns the counts, and each kernel's launches split into
    prefill calls (those at the full prefill shape apart) and decode steps,
    each read from the counts on the path: after the full-shape prefills,
    after the last prefill call (before the first decode step, and checked
    there too) and after serving."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve import ServingEngine, make_prefill, make_serve_step

    cfg = get_config(arch)
    if arch in DEPTH:
        cfg = replace(cfg, num_layers=DEPTH[arch])
    rwkv = cfg.family == "ssm"
    is_moe = cfg.family == "moe"
    frames = cfg.frontend == "frame_embed"
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
    elif is_moe:
        gl = min(cfg.moe_group, PREFILL_BATCH * PREFILL_LEN)
        shape = (f"{attn_shape}; {cfg.n_experts} {cfg.mlp} experts of d_ff {cfg.d_ff}, top-"
                 f"{cfg.top_k}, dispatch groups of {gl} tokens at prefill, capacity "
                 f"{moe._capacity(cfg, gl)}")
    else:
        shape = attn_shape
        if cfg.attn == "local_global":
            shape += (f", window {cfg.window} on {cfg.global_every - 1} of every "
                      f"{cfg.global_every} layers, d_ff {cfg.d_ff} {cfg.mlp}, tied head")
        if cfg.frontend != "tokens":
            shape += (f", d_ff {cfg.d_ff} {cfg.mlp}, "
                      + ("frame embeddings in" if frames else
                         f"a {cfg.n_prefix_embeds}-embedding patch prefix at prefill"))
    depth = (f"{cfg.num_layers} of {get_config(arch).num_layers} layers (depth cut)"
             if arch in DEPTH else f"{cfg.num_layers} layers")
    print(f"{arch}: {depth}, d_model {cfg.d_model}, {shape}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e6:.1f}M params fp32 on "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    def embeds(*shape) -> torch.Tensor:
        return torch.as_tensor(FRAME_SCALE * rng.standard_normal((*shape, cfg.d_model),
                                                                 dtype=np.float32),
                               device="cuda")

    # ------------------------------------------------------------- prefill --
    for mod in kernel_mods.values():
        mod.launches = 0
    decode_steps = 0
    prefill = make_prefill(cfg)
    rng = np.random.default_rng(SEED)
    if frames:
        batch = {"frame_embeds": embeds(PREFILL_BATCH, PREFILL_LEN)}
    else:
        tokens = rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
        batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = embeds(PREFILL_BATCH, cfg.n_prefix_embeds)
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_calls = 1
    if logits.shape != (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    if "patch_embeds" in batch:  # the twin of tests/test_models.py:116
        P = cfg.n_prefix_embeds
        diff = (logits - prefill(params, {"tokens": batch["tokens"]})).abs().amax((0, 2))
        prefill_calls += 1
        if not (diff[:P].max().item() > 1e-4 and diff[P:].max().item() > 1e-4):
            raise AssertionError(f"the patch prefix does not change the logits: max |diff| "
                                 f"{diff[:P].max().item():.3e} at the prefix's positions, "
                                 f"{diff[P:].max().item():.3e} after them")
        report(f"{arch} patch prefix: prefill with vs without the {P} patch embeddings, max "
               f"|logit diff| {diff[:P].max().item():.3e} at the prefix's positions, "
               f"{diff[P:].max().item():.3e} after them (want > 1e-4 at both)")
        del diff
    del logits
    prefill_ms = cuda_ms(lambda: prefill(params, batch), PREFILL_ITERS, warmup=1)
    prefill_calls += 1 + PREFILL_ITERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    full_shape = {name: mod.launches for name, mod in kernel_mods.items()}  # PREFILL_BATCH x LEN
    got = {name: full_shape[name] for name in per_prefill}
    if got != {name: n * prefill_calls for name, n in per_prefill.items()}:
        raise AssertionError(f"prefill launches {got} != "
                             f"{', '.join(_per_call(per_prefill, prefill_calls, 'calls'))}")
    report(f"{arch} prefill {PREFILL_BATCH}x{PREFILL_LEN}: {prefill_ms:.3f} ms, "
           f"{PREFILL_BATCH * PREFILL_LEN / prefill_ms * 1e3:.0f} tokens/s, peak memory "
           f"{peak_gb:.2f} GB, launches {json.dumps(got)} = "
           f"{', '.join(_per_call(per_prefill, prefill_calls, 'calls'))}")

    # --------------------------------------------------------- consistency --
    key = "frame_embeds" if frames else "tokens"

    def draw(b: int) -> torch.Tensor:
        if frames:
            return embeds(b, CONSISTENCY_LEN)
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, CONSISTENCY_LEN)),
                               device="cuda")

    prompt = draw(1)
    if is_moe:  # the forward itself, for its count of dropped pairs
        with torch.inference_mode():
            full, aux = tf.forward(cfg, params, {key: prompt})
        full, dropped = full[0], int(aux["moe_dropped"])
    else:
        full = prefill(params, {key: prompt})[0]
    # the same prompt as row 0 of a batch of 4: how far the forward agrees
    # with itself when only the GEMMs' shapes (and so their order of sums) change
    others = draw(3)
    batched = prefill(params, {key: torch.cat([prompt, others])})[0]
    prefill_calls += 2
    if is_moe:
        short = prompt[:, :MOE_SHORT_LEN]
        short_full = prefill(params, {key: short})[0]
        prefill_calls += 1
    # every prefill call has run and no decode step yet: the prefill launches
    at_prefill = {name: mod.launches for name, mod in kernel_mods.items()}
    want = {name: per_prefill.get(name, 0) * prefill_calls for name in kernel_mods}
    if at_prefill != want:
        raise AssertionError(f"{arch} prefill calls launched {at_prefill}, want {want}")
    step = make_serve_step(cfg)

    def decode(inputs: torch.Tensor) -> torch.Tensor:
        n = inputs.shape[1]
        cache = tf.init_cache(cfg, 1, n, dtype=torch.float32)
        out = [step(params, cache, {key: inputs[:, t:t + 1]}, t)[0][0, 0] for t in range(n)]
        return torch.stack(out)

    dec = decode(prompt)
    decode_steps += CONSISTENCY_LEN
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
    elif is_moe:
        dec_short = decode(short)
        decode_steps += MOE_SHORT_LEN
        short_diff = (dec_short - short_full).abs().max().item()
        if not torch.allclose(dec_short, short_full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL):
            raise AssertionError(
                f"decode vs prefill on the {MOE_SHORT_LEN}-token prompt: max |diff| "
                f"{short_diff:.3e} beyond rtol=atol={CONSISTENCY_TOL}")
        within = torch.isclose(dec, full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL).all(-1)
        criterion = (f"not gated: the prefill dropped {dropped} (token, k) pairs of "
                     f"{CONSISTENCY_LEN * cfg.top_k * cfg.num_layers} at capacity "
                     f"{moe._capacity(cfg, CONSISTENCY_LEN)}, decode none; positions within "
                     f"rtol=atol={CONSISTENCY_TOL}: {int(within.sum())}/{CONSISTENCY_LEN}; "
                     f"{rebatched}")
        report(f"{arch} consistency: decode vs prefill over the first {MOE_SHORT_LEN} tokens "
               f"(one dispatch group of {MOE_SHORT_LEN}, capacity "
               f"{moe._capacity(cfg, MOE_SHORT_LEN)}: no pair can drop), max |diff| "
               f"{short_diff:.3e} (rtol=atol={CONSISTENCY_TOL}), max |logit| "
               f"{short_full.abs().max().item():.1f}")
        del dec_short, short_full
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
    del full, batched

    # ------------------------------------------------------------- serving --
    if not frames:  # the engine takes tokens, as JAX's does
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
        lanes = (f"every lane decoded each step, as JAX's engine does at MoE layers"
                 if is_moe else "one lane a step")
        report(f"{arch} serving: {len(done)} requests, {n_tok} new tokens ({ENGINE_STEPS} "
               f"decode steps with prompts, {lanes}) in {serve_s:.3f} s, "
               f"{n_tok / serve_s:.1f} new tokens/s, {serve_s / ENGINE_STEPS * 1e3:.1f} ms "
               f"per step")
        del eng
    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    want = {name: per_prefill.get(name, 0) * prefill_calls
            + per_decode.get(name, 0) * decode_steps for name in kernel_mods}
    how = " + ".join(_per_call(per_prefill, prefill_calls, "prefill calls")
                     + _per_call(per_decode, decode_steps, "decode steps"))
    if launches != want:
        raise AssertionError(f"{arch} main path launched {launches}, want {want} ({how})")
    report(f"{arch} launches on the main path: {json.dumps(launches)} = {how}")

    if profile:
        if frames:
            steps = embeds(1, DECODE_WARM + 3 * DECODE_STEPS)
            step_input = lambda pos: {key: steps[:, pos:pos + 1]}  # noqa: E731
        else:
            toks = [int(x) for x in rng.integers(0, cfg.vocab_size,
                                                 DECODE_WARM + 3 * DECODE_STEPS)]
            step_input = lambda pos: {key: [[toks[pos]]]}  # noqa: E731
        profile_phase(cfg, params, prefill, batch, step, tf.init_cache, step_input, report)
    # each count read on the path: after the full-shape prefills, after every
    # prefill call (before the first decode step) and after serving
    split = {name: {"prefill": at_prefill[name], "prefill_full_shape": full_shape[name],
                    "decode": launches[name] - at_prefill[name]} for name in kernel_mods}
    return launches, split


def check_flash_attention(fa_kernel, mha_reference, report) -> float:
    """The flash-attention kernel against its plain version; returns the
    largest error at the shapes the paths run in fp32 (the qwen3-0.6b,
    gemma3-4b, zamba2-7b, dbrx-132b, internvl2-76b and musicgen-large
    prefills, gemma3's band beyond its window, the h2o-danube-3-4b
    pipeline)."""
    # (b, s, H, G, hd, window, dtype, tol, label): tests/test_kernels.py:28-85
    # shapes and tolerances, head dims 112 (zamba2-7b's shared blocks: MHA,
    # 32 heads) and 120 (h2o-danube-3-4b, windowed), plus the prefills'
    # attention shapes, where the kernel's online softmax sums 1024 terms in
    # another order than the plain dense softmax (held to 1e-4).
    # bf16 3e-2 is near the size of the outputs themselves (~1/sqrt(row)),
    # so in bf16 the kernel is also held to at most twice the plain bf16
    # version's own error, both against fp32 math on the same bf16 inputs.
    # The h2o-danube-3-4b pipeline's shape (s 4608 beyond the window 4096, so
    # the window cuts keys) sums up to 4096 terms a row in another order:
    # held to 1e-4 as the prefills are.
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
        (PIPE_MB, PIPE_LEN, 32, 8, 120, 4096, torch.float32, 1e-4, "h2o pipeline fp32"),
        # the dbrx-132b, internvl2-76b and musicgen-large prefills (MHA at hd 64)
        (PREFILL_BATCH, PREFILL_LEN, 48, 8, 128, None, torch.float32, 1e-4,
         "dbrx prefill fp32"),
        (PREFILL_BATCH, PREFILL_LEN, 64, 8, 128, None, torch.float32, 1e-4,
         "internvl2 prefill fp32"),
        (PREFILL_BATCH, PREFILL_LEN, 32, 32, 64, None, torch.float32, 1e-4,
         "musicgen prefill fp32"),
        # gemma3-4b at hd 256: its prefill (window 1024 = s keeps every causal
        # pair) and s 2048 beyond the window, so the band masks
        (PREFILL_BATCH, PREFILL_LEN, 8, 4, 256, 1024, torch.float32, 1e-4,
         "gemma3 prefill fp32"),
        (1, 2 * PREFILL_LEN, 8, 4, 256, 1024, torch.float32, 1e-4, "gemma3 band fp32"),
        # the kernel's tiles (256 q rows and 32 kv rows; 64 and 16 at hd 256):
        # s a multiple of neither, windows whose left edge falls mid-tile at
        # hd 112 and 120, hd 16 and 256 at ragged s, bf16 at hd 112 ragged
        (1, 161, 4, 2, 64, None, torch.float32, 2e-5, "ragged s=161"),
        (2, 200, 8, 8, 128, None, torch.float32, 2e-5, "hd 128 ragged s=200"),
        (1, 300, 4, 4, 112, 77, torch.float32, 2e-5, "hd 112 window 77 mid-tile"),
        (1, 333, 8, 2, 120, 45, torch.float32, 2e-5, "hd 120 window 45 mid-tile"),
        (1, 150, 4, 2, 16, None, torch.float32, 2e-5, "hd 16 ragged s=150"),
        (1, 77, 4, 2, 256, None, torch.float32, 2e-5, "hd 256 ragged s=77"),
        (1, 99, 2, 1, 256, 20, torch.float32, 2e-5, "hd 256 window 20 ragged"),
        (1, 150, 4, 4, 112, None, torch.bfloat16, 3e-2, "hd 112 bf16 ragged"),
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
        if label.endswith(("prefill fp32", "pipeline fp32", "band fp32")):
            slice_err = max(slice_err, err)
    for s, hd, window in ((64, 32, None), (130, 120, None), (130, 120, 50)):
        q, k, v = qkv(1, s, 2, 2, hd, seed=SEED, dtype=torch.float32, ones_v=True)
        out = fa_kernel.flash_attention_cuda(q, k, v, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-5, atol=1e-5)
    report("kernel check flash_attention rows sum to one (v = 1) at hd 32 and 120, window "
           "50: ok")
    return slice_err


def check_wkv6(wkv6_kernel, report) -> tuple[float, float]:
    """The wkv6 kernel against wkv6_reference; returns the errors at the
    rwkv6-7b prefill shape and at its decode step."""
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
    decode_err = max_err((y, state), want)
    report(f"kernel check wkv6 decode step b=1 s=1 H={H} P={P}, state written in place: "
           f"max_abs_err {decode_err:.3e} (tol {WKV6_TOL})")
    return prefill_err, decode_err


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


def time_flash(fa_kernel, hw, label, b, s, H, G, hd, window, report) -> dict:
    """Kernel, plain and SDPA times of causal fp32 attention at one shape,
    and its bounds. SDPA is timed twice: with ``enable_gqa`` on the (b, G)
    k/v, and on k/v expanded to H heads beforehand; the window, where there
    is one, as a boolean mask built beforehand. The faster is ``library_ms``.
    ``bound_ms`` is the kernel's own route (3 TF32 tensor-core products per
    product); ``bound_fp32_cuda_ms`` the fp32 CUDA-core bound, kept beside it
    so that times of the kernel's earlier CUDA-core version stay comparable."""
    from repro_torch.kernels.flash_attention.ref import kept_pairs, mha_reference, repeat_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = qkv(b, s, H, G, hd, seed=SEED, dtype=torch.float32)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ke, ve = (repeat_kv(x, H // G).transpose(1, 2).contiguous() for x in (k, v))
    if window is None:
        mask_kw = {"is_causal": True}
    else:
        i = torch.arange(s, device="cuda")
        mask_kw = {"attn_mask": (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)}

    def kernel():
        return fa_kernel.flash_attention_cuda(q, k, v, causal=True, window=window)

    want = mha_reference(q, k, v, causal=True, window=window)
    for name, out in (("enable_gqa", sdpa(qt, kt, vt, enable_gqa=True, **mask_kw)),
                      ("expanded", sdpa(qt, ke, ve, **mask_kw))):
        err = (out.transpose(1, 2) - want).abs().max().item()
        if err > 1e-4:
            raise AssertionError(f"SDPA ({name}) at the {label} shape is off the plain "
                                 f"version by {err:.3e}")
    del want, out
    iters = 20 if s <= 1024 else 5
    kernel_ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(lambda: mha_reference(q, k, v, causal=True, window=window), 3)
    gqa_ms = cuda_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True, **mask_kw), iters)
    exp_ms = cuda_ms(lambda: sdpa(qt, ke, ve, **mask_kw), iters)
    kernel_ms2 = cuda_ms(kernel, iters)
    library, library_ms = min((("sdpa_enable_gqa", gqa_ms), ("sdpa_expanded", exp_ms)),
                              key=lambda x: x[1])
    pairs = kept_pairs(s, s, causal=True, window=window)  # the (row, col) pairs this run needs
    flops = 4 * hd * b * H * pairs
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v)) + q.numel() * 4
    bound_s, bound_by = hw.bound_seconds(n_bytes, 3 * flops, hw.TF32_TENSOR_FLOPS)
    fp32_s, _ = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    report(f"timing flash_attention {label} fp32 b={b} s={s} H={H} G={G} hd={hd} causal "
           f"window={window}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms "
           f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library SDPA "
           f"enable_gqa {gqa_ms:.4f} ms, SDPA on k/v expanded to {H} heads {exp_ms:.4f} ms; "
           f"bound {bound_s * 1e3:.4f} ms by {bound_by} (3 x {flops / 1e9:.2f} GFLOP at TF32 "
           f"tensor-core peak {hw.TF32_TENSOR_FLOPS / 1e12:.0f} TFLOP/s; {n_bytes / 1e6:.1f} "
           f"MB at {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s), fp32 CUDA-core bound "
           f"{fp32_s * 1e3:.4f} ms ({hw.FP32_FLOPS / 1e12:.0f} TFLOP/s)")
    return {"shape": label, "b": b, "s": s, "H": H, "G": G, "hd": hd, "window": window,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "bound_fp32_cuda_ms": fp32_s * 1e3, "library_ms": library_ms,
            "library": library, "library_enable_gqa_ms": gqa_ms, "library_expanded_ms": exp_ms,
            "timed": "events"}


def time_wkv6(wkv6_kernel, hw, label, b, s, H, P, report) -> dict:
    """Kernel and plain times of wkv6 at one main-path shape, and its bound.
    The prefill (s > 1) is timed with CUDA events around launches from
    Python, against ``wkv6_chunked`` (and the sequential ``wkv6_reference``
    for the record); the decode step (s = 1, the state updated in place, as
    the model's cache update does) as device time from a CUDA graph, since
    from Python a launch's host cost would hide the kernel, against
    ``wkv6_reference`` (the CPU dispatch's plain version at s = 1)."""
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_reference

    args = wkv6_inputs(b, s, H, P, seed=SEED + 5, state_scale=0.5 if s == 1 else 0.0,
                       model_decay=True)
    if s > 1:
        kernel = lambda: wkv6_kernel.wkv6_cuda(*args)  # noqa: E731
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(lambda: wkv6_chunked(*args), 5)
        seq_ms = cuda_ms(lambda: wkv6_reference(*args), 2, warmup=1)
        ms2 = cuda_ms(kernel, 20)
        plain, timed = "wkv6_chunked", "events"
        extra = f", sequential plain (wkv6_reference) {seq_ms:.4f} ms"
    else:
        state = args[5]
        kernel = lambda: wkv6_kernel.wkv6_cuda(*args, state_out=state)  # noqa: E731
        ms = graph_ms(kernel, 20)
        plain_ms = graph_ms(lambda: wkv6_reference(*args), 20)
        ms2 = graph_ms(kernel, 20)
        plain, timed, extra = "wkv6_reference", "graph", ""
    flops = 5 * b * s * H * P * P  # r.S (2 P^2) and w*S + k*v (3 P^2) a step and head
    # r, k, v, w and u read, y written, the state read and written once
    n_bytes = 4 * (5 * b * s * H * P + H * P + 2 * b * H * P * P)
    bound_s, bound_by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    pl = wkv6_kernel.plan(b, s, H, P)
    report(f"timing wkv6 {label} fp32 b={b} s={s} H={H} P={P} ({timed}): kernel {ms:.4f} / "
           f"{ms2:.4f} ms, plain ({plain}) {plain_ms:.4f} ms{extra}, library none (no PyTorch "
           f"call computes this recurrence), bound {bound_s * 1e3:.5f} ms by {bound_by} "
           f"({n_bytes / 1e6:.2f} MB at {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
           f"{flops / 1e9:.4f} GFLOP at fp32 CUDA-core peak {hw.FP32_FLOPS / 1e12:.0f} "
           f"TFLOP/s); plan {json.dumps(pl)}, {b * H * pl['blocks_per_head']} blocks")
    return {"shape": label, "b": b, "s": s, "H": H, "P": P, "ms": ms, "plain_ms": plain_ms,
            "plain": plain, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": None, "timed": timed, "plan": pl}


def time_backward(name, apply, args, what, report) -> dict:
    """The backward of a kernel's autograd Function at the training shape
    (TRAIN_BATCH x TRAIN_LEN, the model's heads): one forward, then its
    backward timed with CUDA events, the graph kept between calls, random
    cotangents on every output; the forward's time beside it."""
    live = [x.clone().requires_grad_() for x in args]
    fwd_ms = cuda_ms(lambda: apply(*live), 3, warmup=1)
    out = apply(*live)
    outs = out if isinstance(out, tuple) else (out,)
    cot = [torch.randn_like(o) for o in outs]
    ms = cuda_ms(lambda: torch.autograd.grad(outs, live, cot, retain_graph=True), 3,
                 warmup=1)
    report(f"timing {name} backward at {tuple(args[0].shape)}: {ms:.2f} ms ({what}); the "
           f"kernel's forward {fwd_ms:.4f} ms")
    return {"backward_ms": ms, "backward_of": what, "backward_shape": list(args[0].shape)}


def by_kernel(by_path: dict, name: str) -> dict:
    """A kernel's launches on each path that launched it."""
    return {label: counts[name] for label, counts in by_path.items() if counts[name]}


def gemm_inputs(m, n, k, seed, residual=False, bias_range=1000):
    """int8 a (m, k) and w (k, n) uniform on [-128, 128), int32 bias on
    [-bias_range, bias_range), int8 residual (m, n), from a seeded generator
    on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dtype)

    return (ints((m, k), -128, 128, torch.int8), ints((k, n), -128, 128, torch.int8),
            ints((n,), -bias_range, bias_range, torch.int32),
            ints((m, n), -128, 128, torch.int8) if residual else None)


def col_major(w):
    """The same (K, N) matrix with K contiguous: the layout of the K-major
    kernel, and of a PU's weights loaded once."""
    return w.t().contiguous().t()


def check_gemm_int8(gemm_kernel, report) -> int:
    """Both INT8 GEMM kernels (w row-major and column-major) against the plain
    version, bit for bit; returns the largest |difference| (0)."""
    from repro_torch.kernels.gemm_int8.ref import gemm_int8_reference

    x = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    try:  # a fact about this PyTorch build, reported; the plain version never tries it
        x @ x
        int_mm = "takes int32"
    except RuntimeError as e:
        int_mm = f"refuses int32 ({str(e).splitlines()[0][:80]})"
    report(f"torch.matmul on CUDA {int_mm}: the plain gemm_int8 takes its product in float64")

    sms = gemm_kernel.sm_count(torch.cuda.current_device())
    # (m, n, k, shift, relu, residual, bias range, label): the TestGemmInt8
    # inputs, tests/test_kernels.py:93-134, the sweep at every draw's shift
    # and ReLU; then few-block long-K shapes on which the column-major kernel
    # splits K (ResNet-50's layer3 and layer4 3x3 convs and fc at batch 1)
    cases = [(64, 64, 64, 7, False, False, 1000, "64x64x64"),
             (128, 128, 256, 7, False, False, 1000, "128x128x256"),
             (100, 72, 300, 7, False, False, 1000, "100x72x300 ragged"),
             (64, 64, 128, 7, True, True, 1, "residual + ReLU")]
    cases += [(m, 32, k, shift, relu, False, 64, f"sweep shift {shift} relu {relu}")
              for m, k in ((16, 64), (48, 96)) for shift in (0, 4, 8) for relu in (False, True)]
    cases += [(256, 256, 2304, 7, True, False, 1000, "layer3.0.conv2 batch 1"),
              (64, 512, 4608, 7, True, True, 1000, "layer4.0.conv2 batch 1 + residual"),
              (1, 1000, 2048, 7, False, False, 1000, "fc batch 1")]
    worst, split = 0, []
    for i, (m, n, k, shift, relu, residual, br, label) in enumerate(cases):
        splits = gemm_kernel.split_k(m, n, k, sms)
        a, w, b, res = gemm_inputs(m, n, k, seed=SEED + 300 + i, residual=residual,
                                   bias_range=br)
        want = gemm_int8_reference(a, w, b, shift=shift, relu=relu, residual=res)
        for layout, ww in (("row-major", w), ("column-major", col_major(w))):
            got = gemm_kernel.gemm_int8_cuda(a, ww, b, res, shift=shift, relu=relu)
            err = int((got.int() - want.int()).abs().max())
            worst = max(worst, err)
            if err:
                raise AssertionError(f"gemm_int8 {label}, w {layout}: kernel differs from the "
                                     f"plain version by up to {err}")
        if splits > 1:
            split.append(f"{label} S={splits}")
    if len(split) < 3:
        raise AssertionError(f"gemm_int8: the long-K cases should split K; split {split}")
    a = torch.full((32, 512), 127, dtype=torch.int8, device="cuda")
    w = torch.full((512, 32), 127, dtype=torch.int8, device="cuda")
    zero = torch.zeros(32, dtype=torch.int32, device="cuda")
    for ww, nw in ((w, -w), (col_major(w), col_major(-w))):
        sat = gemm_kernel.gemm_int8_cuda(a, ww, zero, shift=0, relu=False)
        neg = gemm_kernel.gemm_int8_cuda(a, nw, zero, shift=0, relu=False)
        if not (bool((sat == 127).all()) and bool((neg == -128).all())):
            raise AssertionError("gemm_int8 does not saturate at shift 0")
    # negative accumulators at odd shifts: the shift must be arithmetic
    a = torch.full((16, 32), -3, dtype=torch.int8, device="cuda")
    w = torch.full((32, 16), 5, dtype=torch.int8, device="cuda")
    b = torch.arange(-8, 8, dtype=torch.int32, device="cuda") * 37
    for shift in (1, 3, 5, 7):
        for ww in (w, col_major(w)):
            got = gemm_kernel.gemm_int8_cuda(a, ww, b, shift=shift, relu=False)
            if not torch.equal(got, gemm_int8_reference(a, w, b, shift=shift)):
                raise AssertionError(f"gemm_int8 negative accumulators at shift {shift}")
    # the int32 wrap, as JAX's int32 dot: M = N = 1, K = 2^17, all -128 sums
    # to 2^31, which wraps to -2^31 (output -128 at shift 0; a saturating
    # route gives 2^31 - 1 and +127). Four routes must give -128: the
    # row-major kernel, the column-major one (K split), the plain version on
    # the card (float64 through int64) and the CPU's int32 product. At N = 1
    # the two layouts are the same bytes; the strides tell them apart.
    K = 2**17
    a = torch.full((1, K), -128, dtype=torch.int8, device="cuda")
    w = torch.full((K, 1), -128, dtype=torch.int8, device="cuda")
    w_col = torch.empty_strided((K, 1), (1, K), dtype=torch.int8, device="cuda").copy_(w)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    splits = gemm_kernel.split_k(1, 1, K, sms)
    wrap = {"row-major kernel": gemm_kernel.gemm_int8_cuda(a, w, zero, shift=0, relu=False),
            f"column-major kernel (S={splits})":
                gemm_kernel.gemm_int8_cuda(a, w_col, zero, shift=0, relu=False),
            "plain on the card": gemm_int8_reference(a, w, zero, shift=0),
            "CPU int32": gemm_int8_reference(a.cpu(), w.cpu(), zero.cpu(), shift=0)}
    wrap = {key: int(v) for key, v in wrap.items()}
    if set(wrap.values()) != {-128} or splits < 2:
        raise AssertionError(f"gemm_int8 at K = 2^17, all -128: {wrap}, want -128 from each")
    # float64 on the card is the int32 product: at ResNet-50's largest K, with
    # the largest |acc| (every term 2^14) and random inputs
    for label, (a, w, b, _) in (
            ("extreme", (torch.full((256, 4608), -128, dtype=torch.int8, device="cuda"),
                         torch.full((4608, 256), -128, dtype=torch.int8, device="cuda"),
                         torch.zeros(256, dtype=torch.int32, device="cuda"), None)),
            ("random", gemm_inputs(256, 256, 4608, seed=SEED + 399))):
        for shift in (0, 7, 20):
            card = gemm_int8_reference(a, w, b, shift=shift)
            cpu = gemm_int8_reference(a.cpu(), w.cpu(), b.cpu(), shift=shift)
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"plain gemm_int8 on the card (float64) differs from "
                                     f"the CPU's int32 product ({label}, shift {shift})")
    torch.cuda.synchronize()
    report(f"kernel check gemm_int8 w row-major and column-major, TestGemmInt8 inputs and "
           f"few-block long-K shapes ({len(cases)} cases; K split on {', '.join(split)}), "
           f"saturation, negative accumulators at odd shifts: bit-equal to the plain version "
           f"(max |diff| {worst}); M = N = 1, K = 2^17, all -128: {json.dumps(wrap)}; the "
           f"plain version on the card equals the CPU's int32 product at K 4608")
    return worst


def drive_resnet50(kernel_mods, report, profile=False) -> dict:
    """The INT8 PU GEMM on ResNet-50's 54 GEMM nodes at each batch of
    RESNET50_BATCHES: kernel M = batch x positions, N = output channels, K =
    in_ch * kh * kw, shift 7, each node's ReLU and residual. One checked pass
    (every output bit-equal to the plain version), then timed passes, and
    with ``profile`` a profiler window over one more pass. Each node's w is
    stored column-major once, as the layer is built (the weight load, not
    timed), so every GEMM takes the K-major kernel. Every launch count is set
    to 0 before and read after; gemm_int8 must have launched 54 times a pass
    (its split-K reductions run inside those calls), the other kernels not at
    all. Returns the counts."""
    from repro_torch.kernels.gemm_int8 import ops
    from repro_torch.kernels.gemm_int8.ref import gemm_int8_reference

    nodes = sum(row[-1] for row in RESNET50_GEMMS)
    ops_per_image = sum(2 * m * n * k * c for _, m, n, k, _, _, c in RESNET50_GEMMS)
    for mod in kernel_mods.values():
        mod.launches = 0
    passes = 0
    for batch in RESNET50_BATCHES:
        # each node its own operands, as each layer of the network has its own
        # weights: no node finds another's weights or activations in L2
        layers = []
        for name, m, n, k, relu, residual, count in RESNET50_GEMMS:
            for j in range(count):
                a, w, b, res = gemm_inputs(batch * n, m, k, seed=SEED + 1000 + len(layers),
                                           residual=residual)
                layers.append((f"{name} #{j}", a, col_major(w), b, res, relu))

        def network():
            return [ops.gemm_int8(a, w, b, shift=RESNET50_SHIFT, relu=relu, residual=res)
                    for _, a, w, b, res, relu in layers]

        outs = network()
        passes += 1
        for (name, a, w, b, res, relu), got in zip(layers, outs):
            want = gemm_int8_reference(a, w, b, shift=RESNET50_SHIFT, relu=relu, residual=res)
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"resnet50 batch {batch} {name} {tuple(a.shape)} x "
                                     f"{tuple(w.shape)}: kernel output differs from the "
                                     f"plain version")
        del outs, want
        ms = cuda_ms(network, RESNET50_ITERS, warmup=1)
        dev_ms = graph_ms(network, calls=1, replays=RESNET50_ITERS)
        passes += 1 + RESNET50_ITERS + 2  # graph_ms: a warm pass and the captured one
        gop = ops_per_image * batch / 1e9
        n_bytes = sum(t.numel() * t.element_size() for node in layers for t in node[1:5]
                      if t is not None)
        report(f"resnet50 @256 batch {batch}: {nodes} GEMMs ({len(RESNET50_GEMMS)} shapes, "
               f"each node its own operands, w column-major, {n_bytes / 1e6:.1f} MB of "
               f"inputs) bit-equal "
               f"to the plain version; network {ms:.4f} ms launched from Python "
               f"({gop / ms:.2f} TOPS, {batch / ms * 1e3:.1f} images/s), {dev_ms:.4f} ms "
               f"replayed as a CUDA graph ({gop / dev_ms:.2f} TOPS, "
               f"{batch / dev_ms * 1e3:.1f} images/s); {gop:.3f} int8 GOP")
        if profile:
            summ = profile_window(network, ms)
            passes += 2
            report(f"profile resnet50 batch {batch} network: {json.dumps(summ)}")
        del layers
    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    want = {name: (nodes * passes if name == "gemm_int8" else 0) for name in kernel_mods}
    if launches != want:
        raise AssertionError(f"resnet50 path launched {launches}, want {want} ({nodes} x "
                             f"{passes} network passes)")
    report(f"resnet50 launches on the path: {json.dumps(launches)} = gemm_int8 {nodes} x "
           f"{passes} network passes")
    return launches


def time_gemm(gemm_kernel, hw, report) -> dict:
    """Kernel, plain and library time of the GEMM of GEMM_TIMED, and its bound.
    The row's kernel is the K-major one on column-major w and its library
    call ``_int_mm`` + the same epilogue on that layout; the row-major kernel,
    ``_int_mm`` + epilogue on row-major w and ``_int_mm`` alone in both
    layouts are reported beside them."""
    from repro_torch.kernels.gemm_int8.ref import gemm_int8_reference, requantize

    name, batch = GEMM_TIMED
    _, m, n, k, relu, residual, _ = next(r for r in RESNET50_GEMMS if r[0] == name)
    M, N, K = batch * n, m, k
    a, w, b, res = gemm_inputs(M, N, K, seed=SEED + 500, residual=residual)
    w_col = col_major(w)  # the layout change itself is not timed
    kw = dict(shift=RESNET50_SHIFT, relu=relu, residual=res)
    sms = gemm_kernel.sm_count(torch.cuda.current_device())

    def kernel(ww=w_col):
        return gemm_kernel.gemm_int8_cuda(a, ww, b, **kw)

    def library(ww=w_col):  # one PyTorch call for the product, the same epilogue in torch ops
        return requantize(torch._int_mm(a, ww), b, **kw)

    want = gemm_int8_reference(a, w, b, **kw)
    for label, got in (("the K-major kernel", kernel()), ("the row-major kernel", kernel(w)),
                       ("_int_mm + epilogue", library()),
                       ("_int_mm + epilogue on row-major w", library(w))):
        if not torch.equal(got, want):
            raise AssertionError(f"gemm_int8 at {name}: {label} differs from the plain version")
    # the kernel is as short as a launch from Python: time each candidate as
    # device time from a CUDA graph, and the kernel launched from Python too
    kernel_ms = graph_ms(kernel, 20)
    row_ms = graph_ms(lambda: kernel(w), 20)
    plain_ms = graph_ms(lambda: gemm_int8_reference(a, w, b, **kw), 20)
    library_ms = graph_ms(library, 20)
    library_row_ms = graph_ms(lambda: library(w), 20)
    int_mm_ms = graph_ms(lambda: torch._int_mm(a, w), 20)
    int_mm_col_ms = graph_ms(lambda: torch._int_mm(a, w_col), 20)
    kernel_ms2 = graph_ms(kernel, 20)
    row_ms2 = graph_ms(lambda: kernel(w), 20)
    eager_ms = cuda_ms(kernel, 50)
    n_ops = 2 * M * N * K
    n_bytes = M * K + K * N + 4 * N + M * N + (M * N if residual else 0)
    bound_s, bound_by = hw.bound_seconds(n_bytes, n_ops, hw.INT8_TENSOR_OPS)
    splits, bn = gemm_kernel.split_k(M, N, K, sms), gemm_kernel.block_n(M, N, sms)
    report(f"timing gemm_int8 {name} batch {batch} (M={M} N={N} K={K}, relu {relu}), device "
           f"time from CUDA graphs: K-major kernel on column-major w (128 x {bn} blocks, S="
           f"{splits}) {kernel_ms:.4f} / {kernel_ms2:.4f} ms ({n_ops / kernel_ms / 1e9:.1f} "
           f"TOPS), row-major kernel {row_ms:.4f} / {row_ms2:.4f} ms, plain (float64 product) "
           f"{plain_ms:.4f} ms, library (torch._int_mm + epilogue) column-major w "
           f"{library_ms:.4f} ms, row-major w {library_row_ms:.4f} ms; torch._int_mm alone "
           f"column-major {int_mm_col_ms:.4f} ms, row-major {int_mm_ms:.4f} ms; the K-major "
           f"kernel launched from Python {eager_ms:.4f} ms a call; bound "
           f"{bound_s * 1e3:.4f} ms by {bound_by} ({n_bytes / 1e6:.2f} MB at "
           f"{hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s; {n_ops / 1e9:.2f} G int8 ops at "
           f"{hw.INT8_TENSOR_OPS / 1e12:.0f} TOPS)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": "torch._int_mm + epilogue, w column-major", "timed": "graph",
            "splits": splits, "block_n": bn, "row_major_ms": row_ms,
            "library_row_major_ms": library_row_ms, "int_mm_ms": int_mm_col_ms,
            "int_mm_row_major_ms": int_mm_ms}


def gemm_shape_table(gemm_kernel, report) -> None:
    """For each of ResNet-50's 22 GEMM shapes at each batch of
    RESNET50_BATCHES: the K-major kernel's device time from a CUDA graph (its
    operands L2-warm, unlike the network pass), its split S, and ``_int_mm``
    + the epilogue on the same column-major w (null where ``_int_mm`` refuses
    the shape); one line a batch."""
    from repro_torch.kernels.gemm_int8.ref import requantize

    sms = gemm_kernel.sm_count(torch.cuda.current_device())
    for batch in RESNET50_BATCHES:
        rows = []
        for i, (name, m, n, k, relu, residual, _) in enumerate(RESNET50_GEMMS):
            M, N, K = batch * n, m, k
            a, w, b, res = gemm_inputs(M, N, K, seed=SEED + 600 + i, residual=residual)
            w = col_major(w)
            kw = dict(shift=RESNET50_SHIFT, relu=relu, residual=res)
            ms = graph_ms(lambda: gemm_kernel.gemm_int8_cuda(a, w, b, **kw), 10)
            try:  # a yardstick: _int_mm takes only some shapes (M > 16, K % 8 == 0)
                torch._int_mm(a, w)
                lib_ms = graph_ms(lambda: requantize(torch._int_mm(a, w), b, **kw), 10)
            except RuntimeError:
                lib_ms = None
            rows.append({"name": name, "M": M, "N": N, "K": K,
                         "S": gemm_kernel.split_k(M, N, K, sms),
                         "block_n": gemm_kernel.block_n(M, N, sms), "ms": ms,
                         "library_ms": lib_ms})
        torch.cuda.empty_cache()
        report(f"gemm_int8 per shape, batch {batch} (K-major kernel on column-major w, CUDA "
               f"graph; library = torch._int_mm + epilogue, same w): {json.dumps(rows)}")


def drive_pipeline(kernel_mods, report, profile=False) -> dict:
    """The pipeline executor at full width on one card: PIPE_ARCH, random fp32
    weights from SEED, PIPE_STAGES stages, PIPE_MICROBATCHES microbatches of
    PIPE_MB x PIPE_LEN tokens, against the plain forward on the same tokens.
    Every launch count is set to 0 just before the first pipeline call and
    read after the last forward: flash attention must have launched once a
    layer and microbatch in each pipeline call and once a layer in each
    forward, the other kernels not at all. With ``profile``, a profiler
    window over one more pipeline call. Returns the counts."""
    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import pipeline as pp

    cfg = get_config(PIPE_ARCH)
    S, M, mb, s = PIPE_STAGES, PIPE_MICROBATCHES, PIPE_MB, PIPE_LEN
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, dtype=torch.float32)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{PIPE_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, untied head {not cfg.tie_embeddings}, window {cfg.window}; "
          f"{n_params} params ({n_params / 1e9:.3f} B), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB fp32")
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    for pu in plan.programs:
        pu.validate()
    print(f"pipeline plan: {S} stages, boundaries {plan.boundaries}, {plan.layers_per_stage} "
          f"layers a stage, {M} microbatches of {mb} x {s}; stage 1's LD program:")
    print(plan.programs[1].ld.disassemble())
    sparams = pp.stack_stage_params(cfg, params, plan)
    fn = pp.make_pipeline_forward(cfg, plan)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (M, mb, s)),
                             device="cuda")
    flat = tokens.reshape(M * mb, s)

    def timed(f):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = f()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    for mod in kernel_mods.values():
        mod.launches = 0
    out, pipe_ms = timed(lambda: fn(sparams, tokens))
    counts = fn.counts
    stage_ms = [sum(ms) / len(ms) for ms in fn.stage_ms]
    want, fwd_ms = timed(lambda: tf.forward(cfg, params, {"tokens": flat})[0])
    if out.shape != (M, mb, s, cfg.vocab_size) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"pipeline logits {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    got = out.reshape(M * mb, s, -1)
    diff = (got - want).abs().max().item()
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not torch.allclose(got, want, rtol=PIPE_TOL, atol=PIPE_TOL):
        raise AssertionError(f"pipeline vs forward: max |diff| {diff:.3e} beyond "
                             f"rtol=atol={PIPE_TOL}")
    del out, got
    alone = tf.forward(cfg, params, {"tokens": flat[:1]})[0][0]
    noise = (alone - want[0]).abs().max().item()
    max_logit = want.abs().max().item()
    del want, alone
    out2, pipe_ms2 = timed(lambda: fn(sparams, tokens))
    del out2
    _, fwd_ms2 = timed(lambda: tf.forward(cfg, params, {"tokens": flat})[0])
    forwards, pipes = 3, 2  # batched forward twice, the first prompt alone once
    if profile:
        summ = profile_window(lambda: fn(sparams, tokens), pipe_ms2)
        pipes += 2
        report(f"profile {PIPE_ARCH} pipeline call: {json.dumps(summ)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report(f"{PIPE_ARCH} pipeline {S} stages x {M} microbatches of {mb}x{s}: logits vs the "
           f"plain forward on the same {M * mb}x{s} tokens max |diff| {diff:.3e} (rtol=atol="
           f"{PIPE_TOL}), max |logit| {max_logit:.1f}, argmax equal at {top1:.6f} of positions; "
           f"the first prompt's forward alone vs in the batch of {M * mb}: max |diff| "
           f"{noise:.3e}")

    want_counts = [{"WAIT_REQ": M * (i > 0), "SEND_ACK": (M + 2) * (i > 0),
                    "WAIT_ACK": M * (i < S - 1), "SEND_REQ": M * (i < S - 1)} for i in range(S)]
    if not counts == fn.counts == pp.program_sync_counts(plan) == want_counts:
        raise AssertionError(f"token operations {counts} / {fn.counts}, the programs "
                             f"prescribe {pp.program_sync_counts(plan)}")
    report(f"{PIPE_ARCH} pipeline tokens by stage (CUDA events): {json.dumps(counts)} = the "
           f"programs' (non-first stages {M} x (WAIT_REQ + SEND_ACK) + 2 prologue SEND_ACKs, "
           f"non-last {M} x (WAIT_ACK + SEND_REQ))")
    report(f"{PIPE_ARCH} wall: pipeline {pipe_ms:.3f} / {pipe_ms2:.3f} ms, plain forward "
           f"{fwd_ms:.3f} / {fwd_ms2:.3f} ms ({M * mb * s} tokens), peak memory {peak_gb:.2f} "
           f"GB; per stage and microbatch (events around the stage's Compute, first call) "
           + ", ".join(f"stage {i} {ms:.3f} ms" for i, ms in enumerate(stage_ms))
           + f"; analytic plan.stage_time_s {plan.stage_time_s * 1e3:.3f} ms (fp32 "
           f"{hw.FP32_FLOPS / 1e12:.0f} TFLOP/s, {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s)")

    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    L = cfg.num_layers
    want_l = {name: (L * (M * pipes + forwards) if name == "flash_attention" else 0)
              for name in kernel_mods}
    how = f"flash_attention {L} x ({M} microbatches x {pipes} pipeline calls + {forwards} forwards)"
    if launches != want_l:
        raise AssertionError(f"pipeline path launched {launches}, want {want_l} ({how})")
    report(f"{PIPE_ARCH} launches on the pipeline path: {json.dumps(launches)} = {how}")
    del params, sparams, fn
    return launches


def pipeline_rank(rank, device, cfg, plan, local, tokens, want, one, calls) -> dict:
    """The rank body of ``drive_pipeline_ranks``, run by ``spawn_stages`` in a
    process of its own: ``calls`` calls of this rank's ``RankPipelineForward``
    on its params slice (shared by CUDA IPC), each started after a barrier.
    The last rank holds its logits to the plain forward's (``want``) and the
    one-card executor's (``one``) in place, both shared by CUDA IPC. Returns
    what the rank measured and counted: the wall of each call (host clock,
    the barrier to its return), token operations, flash launches, Compute
    times, messages, and the card's memory in use."""
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.runtime import pipeline_ranks as pr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = pr.RankPipelineForward(cfg, plan, rank, device)
    tokens = tokens.to(device)
    fa_kernel.launches = 0
    out = {"wall_ms": [], "counts": [], "stage_ms": [], "messages": []}
    for _ in range(calls):
        dist.barrier()
        t0 = time.perf_counter()
        logits = fn(local, tokens)  # ends in a synchronize
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"].append(fn.counts)
        out["stage_ms"].append(fn.stage_ms)
        out["messages"].append(fn.messages)
    out["launches"] = fa_kernel.launches
    free, total = torch.cuda.mem_get_info(device)
    out["card_used_gb"] = (total - free) / 1e9
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["reserved_gb"] = torch.cuda.memory_reserved(device) / 1e9
    if logits is not None:
        out["finite"] = bool(torch.isfinite(logits).all())
        out["max_diff"] = (logits - want).abs().max().item()
        out["allclose"] = bool(torch.allclose(logits, want, rtol=PIPE_TOL, atol=PIPE_TOL))
        out["one_card_equal"] = bool(torch.equal(logits, one))
        out["one_card_diff"] = (logits - one).abs().max().item()
    return out


def drive_pipeline_ranks(kernel_mods, report) -> dict:
    """The executor across processes at full width: PIPE_ARCH with random fp32
    weights from SEED, PIPE_STAGES ranks on this one card over gloo (the host
    transport: NCCL takes one card a rank), PIPE_MICROBATCHES microbatches of
    PIPE_MB x PIPE_LEN tokens, PIPE_RANK_CALLS calls. This process builds the
    params once and hands each rank its ``stage_slice`` by CUDA IPC, computes
    the plain forward's logits and the one-card executor's (timed as the same
    call) and shares them with the last rank, which compares in place. The
    flash kernel was built at setup, so the ranks only load it. Every count
    is set to 0 before the first call here and in each rank; flash must have
    launched lps x M times a call in each rank, L x M in all, and here L for
    the forward and L x M a one-card call. Returns the counts, the ranks'
    included."""
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import pipeline as pp
    from repro_torch.runtime import pipeline_ranks as pr

    cfg = get_config(PIPE_ARCH)
    S, M, mb, s = PIPE_STAGES, PIPE_MICROBATCHES, PIPE_MB, PIPE_LEN
    L, V, calls = cfg.num_layers, cfg.vocab_size, PIPE_RANK_CALLS
    if not _build._target(fa_kernel.SOURCE).exists():
        raise AssertionError("the flash kernel is not built: the ranks would each run nvcc")
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, dtype=torch.float32)
    param_gb = sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9
    plan = pp.plan_pipeline(cfg, n_stages=S, microbatches=M, seq_len=s, microbatch_size=mb)
    sparams = pp.stack_stage_params(cfg, params, plan)
    lps = plan.layers_per_stage
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, V, (M, mb, s)),
                             device="cuda")
    logits_gb = M * mb * s * V * 4 / 1e9
    act_mb = mb * s * cfg.d_model * 4 / 1e6
    print(f"{PIPE_ARCH} ranks: reckoned card memory {param_gb:.2f} GB of params (this "
          f"process, shared by CUDA IPC) + 2 x {logits_gb:.2f} GB of logits here (plain, "
          f"one-card) + {logits_gb:.2f} GB on the last rank + a {act_mb:.1f} MB stage input "
          f"a rank (SB/RB are pinned host buffers, 4 x {act_mb:.1f} MB a rank) + "
          f"{S + 1} CUDA contexts + each rank's layer activations")

    def timed(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for mod in kernel_mods.values():
        mod.launches = 0
    want = tf.forward(cfg, params, {"tokens": tokens.reshape(M * mb, s)})[0]
    one_fn = pp.make_pipeline_forward(cfg, plan)
    one, one_ms = timed(lambda: one_fn(sparams, tokens))
    del one
    one, one_ms2 = timed(lambda: one_fn(sparams, tokens))
    one_stage_ms = [sum(ms) / len(ms) for ms in one_fn.stage_ms]
    pus = [core.PUSpec(pid=i, kind="PU2x", sa_rows=64, sa_cols=8, slr=i // 2) for i in range(S)]
    sim = core.MultiPUSimulator(pus).run(plan.programs, first_pid=0, last_pid=S - 1)
    if sim.deadlocked or sim.rounds != M:
        raise AssertionError(f"the simulator copy: deadlocked {sim.deadlocked}, {sim.rounds} "
                             f"rounds of {M}")
    slices = pr.PerRank([pr.stage_slice(cfg, sparams, plan, r) for r in range(S)])
    t0 = time.perf_counter()
    ranks = pr.spawn_stages(S, pipeline_rank, cfg, plan, slices, tokens.cpu(),
                            pr.PerRank([None] * (S - 1) + [want.view(M, mb, s, V)]),
                            pr.PerRank([None] * (S - 1) + [one]), calls,
                            backend="gloo", timeout_s=PIPE_RANK_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    parent_launches = {name: mod.launches for name, mod in kernel_mods.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    del want, one, slices, sparams, params, one_fn
    gc.collect()

    last = ranks[-1]
    if not (last["finite"] and last["allclose"]):
        raise AssertionError(f"ranks vs the plain forward: finite {last['finite']}, max |diff| "
                             f"{last['max_diff']:.3e} beyond rtol=atol={PIPE_TOL}")
    if not (last["one_card_equal"] or last["one_card_diff"] <= PIPE_RANK_ONE_CARD_TOL):
        raise AssertionError(f"ranks vs the one-card executor: max |diff| "
                             f"{last['one_card_diff']:.3e} > {PIPE_RANK_ONE_CARD_TOL}")
    want_counts = pp.program_sync_counts(plan)
    sends = sum(c["SEND_REQ"] + c["SEND_ACK"] for c in want_counts)
    for i, r in enumerate(ranks):
        if r["counts"] != [want_counts[i]] * calls:
            raise AssertionError(f"rank {i} performed {r['counts']}, the programs prescribe "
                                 f"{want_counts[i]} a call")
        if r["launches"] != lps * M * calls:
            raise AssertionError(f"rank {i} launched flash {r['launches']} times, want "
                                 f"{lps} x {M} x {calls}")
    if sends != sim.tokens_sent:
        raise AssertionError(f"the ranks send {sends} messages a call, the simulator copy "
                             f"{sim.tokens_sent} tokens")
    rank_launches = sum(r["launches"] for r in ranks)
    if rank_launches != L * M * calls:
        raise AssertionError(f"the ranks launched flash {rank_launches} times, want "
                             f"{L} x {M} x {calls}")
    want_parent = {name: (L * (1 + 2 * M) if name == "flash_attention" else 0)
                   for name in kernel_mods}
    if parent_launches != want_parent:
        raise AssertionError(f"this process launched {parent_launches}, want {want_parent} "
                             f"(flash {L} x (1 forward + 2 one-card calls x {M}))")

    report(f"{PIPE_ARCH} ranks: {S} processes on one card over gloo, {M} microbatches of "
           f"{mb}x{s}: logits vs the plain forward max |diff| {last['max_diff']:.3e} (rtol=atol="
           f"{PIPE_TOL}); vs the one-card executor bit-equal {last['one_card_equal']}, max "
           f"|diff| {last['one_card_diff']:.3e}")
    report(f"{PIPE_ARCH} ranks: tokens a call by rank {json.dumps(want_counts)} = the "
           f"programs', {sends} messages = the simulator copy's tokens_sent {sim.tokens_sent}; "
           f"flash launches by rank {[r['launches'] for r in ranks]} = {lps} x {M} x {calls} "
           f"calls each")
    report(f"{PIPE_ARCH} ranks wall (host clock, a barrier to the last rank's return): "
           + " / ".join(f"{ms:.1f}" for ms in last["wall_ms"]) + " ms; the one-card executor "
           f"(host clock, synchronized) {one_ms:.1f} / {one_ms2:.1f} ms; spawn_stages "
           f"{spawn_s:.1f} s in all")
    for c in range(calls):
        report(f"{PIPE_ARCH} ranks call {c + 1} Compute ms by stage and microbatch (CUDA "
               "events): " + "; ".join(
                   f"stage {i} " + " ".join(f"{ms:.1f}" for ms in r["stage_ms"][c])
                   for i, r in enumerate(ranks))
               + "; one-card executor, mean by stage: "
               + " ".join(f"{ms:.1f}" for ms in one_stage_ms))
        per = []
        for i in range(S - 1):
            d2h = {rd: ms for what, rd, ms in ranks[i]["messages"][c] if what == "d2h"}
            got = ranks[i + 1]["messages"][c]
            sr = {rd: ms for what, rd, ms in got if what == "send_recv"}
            h2d = {rd: ms for what, rd, ms in got if what == "h2d"}
            per += [f"{i}->{i + 1} r{rd} {d2h[rd]:.2f}/{sr[rd]:.2f}/{h2d[rd]:.2f}"
                    for rd in range(M)]
        report(f"{PIPE_ARCH} ranks call {c + 1} messages of {act_mb:.1f} MB, D2H / send-recv / "
               "H2D ms (the copies by CUDA events, send-recv by the host clock): "
               + ", ".join(per))
    report(f"{PIPE_ARCH} ranks memory: this process peak {peak_gb:.2f} GB allocated, "
           f"{reserved_gb:.2f} GB reserved; the ranks' peaks allocated "
           + " ".join(f"{r['peak_gb']:.2f}" for r in ranks) + " GB, reserved "
           + " ".join(f"{r['reserved_gb']:.2f}" for r in ranks)
           + f" GB; the card in use (all processes) {max(r['card_used_gb'] for r in ranks):.2f}"
           " GB at the ranks' end")

    launches = {name: parent_launches[name] + (rank_launches if name == "flash_attention"
                                               else 0) for name in kernel_mods}
    how = (f"flash_attention {L} x (1 forward + 2 one-card calls x {M}) here + {S} ranks x "
           f"{lps} x {M} x {calls} calls")
    report(f"{PIPE_ARCH} launches on the rank pipeline path: {json.dumps(launches)} = {how}")
    return launches


def launches_a_forward(cfg) -> dict:
    """Each kernel's launches in one forward of ``cfg``: flash attention a
    dense, MoE or shared-attention layer, wkv6 an rwkv layer, the SSD scan a
    mamba layer (``layer_plan``)."""
    from repro_torch.models.transformer import layer_plan

    kinds = {"rwkv": "wkv6", "mamba": "ssd_scan"}
    out = defaultdict(int)
    for blk in layer_plan(cfg):
        out[kinds.get(blk.kind, "flash_attention")] += blk.n
    return dict(out)


def plain_forward(cfg):
    """The check (b) of a training path: where the path's recurrence
    (attention where there is none) is forced to a plain version, that
    version, its twin in float64 (None for attention), the kernel it
    replaces and the plain version's name. rwkv and mamba replace the
    kernel inside their autograd Functions, so the backward (the same plain
    recompute) and its memory stay a layer's: rwkv by the sequential
    ``wkv6_reference``, the recurrence the kernel runs (the chunked form is
    not that recurrence at the full-width init), mamba by ``ssd_chunked``;
    attention takes ``plain_attention`` in place of the whole dispatch."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_reference
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    def f64(fn):
        return lambda *a: fn(*(x.double() for x in a))

    if cfg.family == "ssm":
        return (wkv6_kernel, "wkv6_cuda",
                lambda r, k, v, w, u, state, **_: wkv6_reference(r, k, v, w, u, state),
                lambda r, k, v, w, u, state, **_: tuple(
                    x.float() for x in f64(wkv6_reference)(r, k, v, w, u, state)),
                "wkv6", "wkv6_reference")
    if cfg.family == "hybrid":
        return (ssd_kernel, "ssd_scan_cuda", lambda *a, **_: (ssd_chunked(*a), None),
                lambda *a, **_: (f64(ssd_chunked)(*a).float(), None), "ssd_scan",
                "ssd_chunked")
    return (flash_ops, "flash_attention", flash_ops.plain_attention, None, "flash_attention",
            "plain_attention")


@contextmanager
def swapped(obj, attr, value):
    kept = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, kept)


def drive_train(arch, depth, kernel_mods, report, profile=False) -> dict:
    """A training path at full width (depth cut to ``depth`` layers where it
    is given): ``arch`` in fp32 with AdamW, TRAIN_BATCH x TRAIN_LEN tokens of
    the token stream a step.
    a. one step from the same state without remat and two with (the second
       timed warm): the same loss and grad norm (TRAIN_TOL relative);
    b. a check, not the main path: the same step with the path's recurrence
       (attention where there is none) forced to its plain version
       (``plain_forward``), loss at TRAIN_TOL and grad norm at
       TRAIN_PLAIN_GRAD_TOL relative to (a). rwkv and mamba also measure
       the plain step's own noise: against the same step with the
       recurrence in float64 (its fp32 rounding) and against itself
       re-batched (the loss of the batch against the mean of its halves'
       losses, the grad norm against a step of two microbatches); each is
       held to the larger of its gate, the re-batched noise and twice the
       rounding (kernel and plain are two fp32 roundings of one recurrence);
    c. TRAIN_STEPS steps on one repeated batch: the nll falls;
    d. TRAIN_ARCH only: a checkpoint written after step TRAIN_RESUME_AT,
       restored, and the steps after it run again: params bit-equal to (c)'s.
    With ``profile``, a profiler window over one more step without remat,
    and one more step with each kernel's backward recompute timed, from
    the state (c) or (d) ends with. Only TRAIN_ARCH keeps the first state
    through (c): fp32 AdamW state is 12 B a param, and rwkv6's 22.6 GB held
    twice beside a step's new state and gradients passes the card.
    Every launch count is set to 0 just before (a) and read at the end:
    each kernel its ``launches_a_forward`` a step, twice with remat, the
    kernel that (b) replaces none there; the other kernels never. Returns
    the counts."""
    import tempfile

    from repro_torch._device import batch_on_device
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import kept_pairs
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime import train
    from repro_torch.runtime.data import DataConfig, TokenStream
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = full if depth is None else replace(full, num_layers=depth)
    L, b, s = cfg.num_layers, TRAIN_BATCH, TRAIN_LEN
    per = launches_a_forward(cfg)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=0)
    torch.cuda.reset_peak_memory_stats()
    params, state0 = train.init_train_state(cfg, opt_cfg, seed=SEED, dtype=torch.float32)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = batch_on_device(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=SEED)).next(),
        torch.device("cuda"))
    step_fns = {remat: train.make_train_step(cfg, opt_cfg, remat=remat)
                for remat in (False, True)}
    held = torch.cuda.memory_allocated() / 1e9
    layers = f"{L} of {full.num_layers} layers (depth cut)" if depth else f"{L} layers"
    print(f"{arch} training: {layers}, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f}M params fp32, AdamW (lr {TRAIN_LR}, no warmup) fp32 moments, "
          f"{b} x {s} tokens a step from the token stream; {held:.2f} GB held by params and "
          f"optimizer state ({16 * n_params / 1e9:.2f} GB with a step's gradients at 16 B a "
          f"param); kernel launches a forward {json.dumps(per)}")

    def step(fn, p, st):
        """One step: its outputs, wall (CUDA events), the allocator's peak
        and that peak above what was allocated before the step (GB), and
        each kernel's launches."""
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = {name: mod.launches for name, mod in kernel_mods.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(p, st, batch)
        end.record()
        end.synchronize()
        peak = torch.cuda.max_memory_allocated()
        n = {name: mod.launches - before[name] for name, mod in kernel_mods.items()}
        return out, dict(ms=start.elapsed_time(end), peak=peak / 1e9, own=(peak - base) / 1e9,
                         n={name: k for name, k in n.items() if k})

    def rel(x, y):
        return abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)

    for mod in kernel_mods.values():
        mod.launches = 0
    # ------------------------------------------------- a. remat or not --
    runs = []
    for remat in (False, True, True):
        (p, st, m), r = step(step_fns[remat], params, state0)
        runs.append(dict(r, remat=remat, m={k: float(v) for k, v in m.items()}))
        del p, st
    for r in runs:
        want = {name: n * (2 if r["remat"] else 1) for name, n in per.items()}
        if r["n"] != want:
            raise AssertionError(f"{arch} train step (remat={r['remat']}) launched {r['n']}, "
                                 f"want {want}")
        if not all(np.isfinite(v) for v in r["m"].values()):
            raise AssertionError(f"{arch} train step (remat={r['remat']}) metrics {r['m']}")
    a = runs[0]["m"]
    diffs = {k: max(rel(r["m"][k], a[k]) for r in runs[1:]) for k in ("nll", "z_loss",
                                                                       "grad_norm")}
    if max(diffs.values()) > TRAIN_TOL:
        raise AssertionError(f"{arch} remat vs not: relative differences {diffs} beyond "
                             f"{TRAIN_TOL}")
    report(f"{arch} train step remat vs not, from the same state: nll {a['nll']:.6f} / "
           f"{runs[1]['m']['nll']:.6f}, z_loss {a['z_loss']:.6f}, grad norm "
           f"{a['grad_norm']:.6f} / {runs[1]['m']['grad_norm']:.6f}; largest relative "
           f"differences {json.dumps(diffs)} (tol {TRAIN_TOL}); launches a step "
           f"{json.dumps(runs[0]['n'])} / with remat {json.dumps(runs[1]['n'])}")

    # ---------------------------------- b. check: the plain forward --
    mod, attr, plain_fn, plain64_fn, forced, plain_name = plain_forward(cfg)
    loss_tol, grad_tol, noise = TRAIN_TOL, TRAIN_PLAIN_GRAD_TOL, ""
    with swapped(mod, attr, plain_fn):
        (p, st, m), plain = step(step_fns[False], params, state0)
        del p, st
    d_loss = max(rel(m[k], a[k]) for k in ("nll", "z_loss"))
    d_grad = rel(m["grad_norm"], a["grad_norm"])
    if plain64_fn is not None:
        # the plain step's own noise: the recurrence's fp32 rounding (the
        # same step with the recurrence in float64, near the exact one), and
        # the step re-batched (the loss of the batch against the mean of its
        # halves' losses; the grad norm against two microbatches)
        with swapped(mod, attr, plain64_fn):
            (p, st, m64), _ = step(step_fns[False], params, state0)
            del p, st
        with swapped(mod, attr, plain_fn):
            (p, st, m2), _ = step(train.make_train_step(cfg, opt_cfg, remat=False,
                                                        microbatch=2), params, state0)
            del p, st
            with torch.no_grad():
                whole = train.loss_fn(cfg, params, batch, remat=False)[1]
                halves = [train.loss_fn(cfg, params, {k: v[i:i + b // 2] for k, v in
                                                      batch.items()}, remat=False)[1]
                          for i in (0, b // 2)]
        round_loss = max(rel(m[k], m64[k]) for k in ("nll", "z_loss"))
        round_grad = rel(m["grad_norm"], m64["grad_norm"])
        batch_loss = max(rel((halves[0][k] + halves[1][k]) / 2, whole[k])
                         for k in ("nll", "z_loss"))
        batch_grad = rel(m2["grad_norm"], m["grad_norm"])
        # kernel and plain are two fp32 evaluations of one recurrence, each
        # off the exact one by about the plain's rounding: up to twice it apart
        loss_tol = max(TRAIN_TOL, batch_loss, 2 * round_loss)
        grad_tol = max(TRAIN_PLAIN_GRAD_TOL, batch_grad, 2 * round_grad)
        exact_loss = max(rel(a[k], m64[k]) for k in ("nll", "z_loss"))
        exact_grad = rel(a["grad_norm"], m64["grad_norm"])
        noise = (f"; the plain step's noise: its recurrence in float64 moves the loss "
                 f"{round_loss:.3e} and the grad norm {round_grad:.3e}, re-batched {batch_loss:.3e}"
                 f" / {batch_grad:.3e}, so held to max(gate, re-batched, 2 x float64) = "
                 f"{loss_tol:.3e} / {grad_tol:.3e} (gates {TRAIN_TOL} / {TRAIN_PLAIN_GRAD_TOL}); "
                 f"the kernel's step vs the float64 one: loss {exact_loss:.3e}, grad norm "
                 f"{exact_grad:.3e}")
        del whole, halves
    want = {name: n for name, n in per.items() if name != forced}
    if plain["n"] != want:
        raise AssertionError(f"{arch} plain-forward step launched {plain['n']}, want {want}")
    if d_loss > loss_tol or d_grad > grad_tol:
        raise AssertionError(f"{arch} kernel vs plain forward: loss {d_loss:.3e} (tol "
                             f"{loss_tol:.3e}), grad norm {d_grad:.3e} (tol {grad_tol:.3e}) "
                             f"relative{noise}")
    report(f"{arch} train step, {forced} kernel vs {plain_name} forward (check): nll "
           f"{float(m['nll']):.6f}, loss {d_loss:.3e} (tol {loss_tol:.3e}) and grad norm "
           f"{d_grad:.3e} (tol {grad_tol:.3e}) relative; wall {plain['ms']:.1f} ms{noise}")

    # ------------------------- c. steps on one batch; d. checkpoint and resume --
    walls, nll = [], []
    resumed = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        p, st = params, state0
        if arch != TRAIN_ARCH:  # only (d) starts from it again: free it as (c) steps on
            params = state0 = None
        for i in range(TRAIN_STEPS):
            (p, st, m), r = step(step_fns[False], p, st)
            walls.append(r)
            nll.append(float(m["nll"]))
            if arch == TRAIN_ARCH and i + 1 == TRAIN_RESUME_AT:
                t0 = time.perf_counter()
                ckpt.save_checkpoint(d, i + 1, {"params": p, "opt": st})
                save_s = time.perf_counter() - t0
        if not nll[-1] < nll[0]:
            raise AssertionError(f"{arch} nll did not fall over {TRAIN_STEPS} steps on one "
                                 f"batch: {nll}")
        steps_msg = f"{arch} train {TRAIN_STEPS} steps on one batch: nll " + " ".join(
            f"{x:.4f}" for x in nll)
        if arch == TRAIN_ARCH:
            straight = p
            del st
            t0 = time.perf_counter()
            restored, at, _ = ckpt.restore_checkpoint(d, {"params": params, "opt": state0})
            load_s = time.perf_counter() - t0
            p, st = restored["params"], restored["opt"]
            del restored
            for _ in range(at, TRAIN_STEPS):
                (p, st, m), _ = step(step_fns[False], p, st)
            resumed = TRAIN_STEPS - at
            same = all(torch.equal(x, y) for x, y in zip(tree_leaves(p), tree_leaves(straight)))
            if not same or float(m["nll"]) != nll[-1]:
                raise AssertionError(f"resumed from the step-{at} checkpoint, the params or "
                                     f"the last nll ({float(m['nll'])} vs {nll[-1]}) differ "
                                     f"from the straight run")
            ckpt_gb = sum(x.numel() * x.element_size() for x in tree_leaves((p, st))) / 1e9
            steps_msg += (f"; checkpoint after step {at} ({ckpt_gb:.2f} GB, saved in "
                          f"{save_s:.1f} s, restored in {load_s:.1f} s), steps {at + 1}-"
                          f"{TRAIN_STEPS} again: params bit-equal to the straight run")
            del straight
    report(steps_msg)

    # a step's work, by count: 6 x (matmul params) x tokens of GEMMs (a tied
    # head's 2 x d x vocab a token forward, its 4 backward, included; an
    # untied embedding lookup is no GEMM), the flash forward on the causal
    # pairs and the plain dense recompute in the backward (every s x s pair,
    # forward 2 products and backward 4) on each attention layer; the
    # recurrences' own work (under 1 % of a step by count) is left out
    n_attn = per.get("flash_attention", 0)
    H, hd, tokens = cfg.num_heads, cfg.resolved_head_dim, b * s
    embed = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    gemm = 6 * (n_params - embed) * tokens
    flash = n_attn * 4 * hd * b * H * kept_pairs(s, s)
    recompute = n_attn * 3 * 4 * hd * b * H * s * s
    work = gemm + flash + recompute
    rerun = gemm / 3 + flash  # what remat adds: the forward once more
    ms_step = sum(r["ms"] for r in walls) / len(walls)
    warm = runs[2]
    report(f"{arch} train step {b}x{s} tokens (CUDA events): without remat "
           + " / ".join(f"{r['ms']:.1f}" for r in walls) + f" ms (the steps of c, mean "
           f"{ms_step:.1f} ms, {tokens / ms_step * 1e3:.0f} tokens/s); the path's first step "
           f"{runs[0]['ms']:.1f} ms and first with remat {runs[1]['ms']:.1f} ms (warm-up); "
           f"with remat, warm, {warm['ms']:.1f} ms ({warm['ms'] / ms_step:.2f}x). Peak "
           f"memory a step without remat {max(r['peak'] for r in walls):.2f} GB allocated, "
           f"{max(r['own'] for r in walls):.2f} GB above what it started with; with remat "
           f"{warm['peak']:.2f} / {warm['own']:.2f} GB (card "
           f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB). By count "
           f"{gemm / 1e12:.2f} TFLOP of GEMMs (6 x matmul params x tokens) + "
           f"{flash / 1e12:.3f} flash forward + {recompute / 1e12:.2f} plain attention "
           f"recompute (dense: forward 2, backward 4 products) = {work / 1e12:.2f} TFLOP a "
           f"step, {work / ms_step / 1e9:.1f} TFLOP/s; remat adds {rerun / 1e12:.2f} (the "
           f"forward again): {(work + rerun) / warm['ms'] / 1e9:.1f} TFLOP/s")
    profiled = 0
    if profile:
        summ = profile_window(lambda: step_fns[False](p, st, batch), ms_step)
        report(f"profile {arch} train step {b}x{s}: {json.dumps(summ)}")
        # each kernel's backward (the plain recompute) timed inside one step
        from repro_torch.kernels.flash_attention.ops import FlashAttention
        from repro_torch.kernels.rwkv6.ops import WKV6
        from repro_torch.kernels.ssd_scan.ops import SSDScan

        spent = defaultdict(list)
        fns = {name: f for name, f in (("flash_attention", FlashAttention), ("wkv6", WKV6),
                                       ("ssd_scan", SSDScan)) if per.get(name)}

        def timed(name, bwd):
            def run(ctx, *grads):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = bwd(ctx, *grads)
                end.record()
                spent[name].append((start, end))
                return out
            return staticmethod(run)

        with ExitStack() as stack:
            for name, f in fns.items():
                stack.enter_context(swapped(f, "backward", timed(name, f.backward)))
            _, r = step(step_fns[False], p, st)
        share = {name: sum(s_.elapsed_time(e_) for s_, e_ in ev) for name, ev in spent.items()}
        profiled = 3
        report(f"profile {arch} train step {b}x{s}, each kernel's backward (the plain "
               f"recompute) timed by CUDA events inside a {r['ms']:.1f} ms step: "
               + ", ".join(f"{fns[name].__name__} {len(spent[name])} calls {ms:.1f} ms "
                           f"({ms / r['ms']:.1%})" for name, ms in share.items()))
    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    plain_steps = 1 + TRAIN_STEPS + resumed + profiled  # a, c, d, the profile
    # the forwards of check (b) that keep the other kernels: its step, and for
    # a recurrence the float64 step, the two microbatches and three losses
    checks = 1 + (6 if plain64_fn is not None else 0)
    want = {name: per.get(name, 0) * (plain_steps + 4 + checks * (name != forced))
            for name in kernel_mods}
    how = "; ".join(f"{name} {n} x {plain_steps} steps + {2 * n} x 2 steps with remat"
                    + (" + none in check (b)" if name == forced else
                       f" + {n} x {checks} forwards of check (b)") for name, n in per.items())
    if launches != want:
        raise AssertionError(f"{arch} training path launched {launches}, want {want} ({how})")
    report(f"{arch} launches on the training path: {json.dumps(launches)} = {how}")
    del params, state0, p, st
    return launches


def dse_pool(n1: int, n2: int) -> list:
    """``n1`` PU1x on SLR 0 and ``n2`` PU2x on SLR 1, built as
    ``make_u50_system`` builds the U50's 5 + 5."""
    from repro_torch.core.pu import PUSpec

    return ([PUSpec(pid=i, kind="PU1x", sa_rows=64, sa_cols=4, slr=0) for i in range(n1)]
            + [PUSpec(pid=n1 + i, kind="PU2x", sa_rows=64, sa_cols=8, slr=1)
               for i in range(n2)])


def drive_dse(kernel_mods, report) -> None:
    """The paper's three-step DSE in the port. ResNet-50 at 256x256 on the
    U50's 5 + 5 PUs through ``explore(tolerance=0.01)``: the Step 1/2/3
    counts and DP-A/B/C, as examples/resnet50_dse.py prints them. Then the
    torch scorer on the card against the numpy scorer at each of DSE_POOLS,
    every field at DSE_RTOL / DSE_ATOL (a mismatch raises), both timed warm
    over the whole ``score_details`` call with their ``PROFILE`` phases and
    the torch scoring's device time from CUDA events. Then the H100-pool
    deployment DSE at 8 cards for four architectures, and its prediction
    for the h2o pipeline beside what four cards measured. The DSE runs no
    hand-written kernel: every launch count is set to 0 before and must
    read 0 after."""
    from repro_torch import hw
    from repro_torch.benchmarks import gpu_dse
    from repro_torch.compiler import analyze
    from repro_torch.configs import get_config
    from repro_torch.dse import batched, explore
    from repro_torch.dse.gpu_deploy import enumerate_deployments
    from repro_torch.runtime.pipeline import layer_cost_seconds

    for mod in kernel_mods.values():
        mod.launches = 0
    t_phase = time.time()
    g = zoo.resnet50(256)
    gopf = 2 * g.total_macs() / 1e9
    t0 = time.perf_counter()
    res = explore(g, tolerance=0.01)
    print(f"dse resnet50 @256 on the U50's 5 + 5 PUs, tolerance 0.01 "
          f"({time.perf_counter() - t0:.3f} s on the host): step 1 {len(res.single)} "
          f"single-batch configurations, step 2 {len(res.multi)} multi-batch schedules, "
          f"step 3 Pareto frontier keeps {len(res.multi_frontier)}")
    for name, dp in (("DP-A", res.dp_a), ("DP-B", res.dp_b), ("DP-C", res.dp_c)):
        gops = dp.throughput * gopf
        print(f"dse {name}: batch={dp.batch:2d}  fps(224eq)={gops / GOPS_224EQ:6.1f}  "
              f"latency={dp.latency * 1e3:5.2f} ms  CE={gops / (U50_PEAK_TOPS * 1e3):.3f}  "
              f"configs={'+'.join(f'({a},{b})' for a, b in dp.configs)}")
    if (len(res.single), res.dp_c.batch) != (35, 10):
        raise AssertionError(f"dse: {len(res.single)} single-batch configurations and "
                             f"DP-C at batch {res.dp_c.batch}, want 35 and 10")

    fields = ("fps", "latency", "tops", "pbe", "round_seconds", "uncoupled_seconds",
              "binding_bound")
    for n1, n2 in DSE_POOLS:
        pus = dse_pool(n1, n2)
        ana = analyze(g, pus)
        configs = [(a, b) for a in range(n1 + 1) for b in range(n2 + 1) if a + b]
        wall = {"numpy": [], "torch": []}
        for rep in range(DSE_REPEATS + 1):  # the first round warms both
            for backend in (("numpy", "torch") if rep % 2 else ("torch", "numpy")):
                batched.reset_profile()
                t0 = time.perf_counter()
                sc = batched.score_details(ana, configs, pus=pus, backend=backend,
                                           device="cuda")
                dt = time.perf_counter() - t0
                if rep:
                    wall[backend].append(dt)
                if backend == "numpy":
                    ref, ref_prof = sc, dict(batched.PROFILE)
                else:
                    got, got_prof = sc, dict(batched.PROFILE)
        errs = {}
        for f in fields:
            a, b = getattr(got, f), getattr(ref, f)
            if not (isinstance(a, np.ndarray) and a.dtype == np.float64 and a.shape == b.shape):
                raise AssertionError(f"dse torch scorer {f}: {type(a).__name__} "
                                     f"{getattr(a, 'dtype', None)}, want float64 {b.shape}")
            np.testing.assert_allclose(a, b, rtol=DSE_RTOL, atol=DSE_ATOL,
                                       err_msg=f"dse torch scorer on cuda, {f}, {n1} + {n2}")
            errs[f] = float(np.abs(a - b).max())
        med = {k: float(np.median(v)) for k, v in wall.items()}
        report(f"dse scorer resnet50 {n1} + {n2} PUs, {len(configs)} configs: torch on cuda "
               f"within rtol {DSE_RTOL:g} / atol {DSE_ATOL:g} of numpy on every field (max |diff| "
               f"{json.dumps(errs)}); score_details warm, median of {DSE_REPEATS}: numpy "
               f"{med['numpy'] * 1e3:.3f} ms, torch {med['torch'] * 1e3:.3f} ms; phases s "
               f"numpy {json.dumps({k: round(v, 6) for k, v in ref_prof.items()})}, torch "
               f"{json.dumps({k: round(v, 6) for k, v in got_prof.items()})} (score_device: "
               f"CUDA events around the torch scoring)")

    for row in gpu_dse.run():
        print(row)
    cfg = get_config(PIPE_ARCH)
    S, M = PIPE_STAGES, PIPE_MICROBATCHES
    dep = next(d for d in enumerate_deployments(
        cfg, cards=S, seq_len=PIPE_LEN, microbatch=PIPE_MB, microbatches=M,
        peak_flops=hw.FP32_FLOPS) if (d.stages, d.replicas, d.tensor) == (S, 1, 1))
    layer_s = layer_cost_seconds(cfg, PIPE_LEN, PIPE_MB, peak_flops=hw.FP32_FLOPS)
    stage_s = dep.latency / (S + M - 1)
    lo, hi = PIPE_NCCL_STAGE_MS
    print(f"dse gpu_deploy {PIPE_ARCH} {dep.label} at {S} cards, {M} microbatches of "
          f"{PIPE_MB} x {PIPE_LEN}, fp32 CUDA-core rate: predicted {layer_s * 1e3:.2f} ms a "
          f"layer, {stage_s * 1e3:.1f} ms a stage of {cfg.num_layers // S} layers, "
          f"{dep.latency * 1e3:.0f} ms a call of {S + M - 1} stage-times; measured on four "
          f"H100s over NCCL (PERF.md section 6): {PIPE_NCCL_CALL_MS} ms a call "
          f"({dep.latency * 1e3 / PIPE_NCCL_CALL_MS:.3f} of it predicted), {lo}-{hi} ms a "
          f"stage's Compute ({stage_s * 1e3 / hi:.3f}-{stage_s * 1e3 / lo:.3f})")

    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    if any(launches.values()):
        raise AssertionError(f"dse phase launched {launches}, want none")
    report(f"dse phase: {time.time() - t_phase:.1f} s, launches {json.dumps(launches)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break prefill and decode time down by kernel (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only", file=sys.stderr)
        return 1
    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.kernels import SOURCES, _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import mha_reference
    from repro_torch.kernels.gemm_int8 import kernel as gemm_kernel
    from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
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
        print(f"built {b.name} -> {b.path.name}" + ("" if b.log else " (cached)"))
        mma = sass_mma_counts(b.path)
        for fn, (regs, spill) in ptxas_summary(b.log).items():
            print(f"  {fn}: {regs}; {spill}; SASS {mma.pop(fn, 'no tensor-core MMA')}")
        for fn, counts in mma.items():
            print(f"  {fn}: SASS {counts}")
    print(f"build: {time.time() - t0:.1f} s")

    # --------------------------------------------------------- kernel check --
    fa_err = check_flash_attention(fa_kernel, mha_reference, report)
    wkv6_err, wkv6_decode_err = check_wkv6(wkv6_kernel, report)
    ssd_err = check_ssd_scan(ssd_kernel, report)
    gemm_err = check_gemm_int8(gemm_kernel, report)

    # ---------------------------------------------------------- main paths --
    kernel_mods = {"flash_attention": fa_kernel, "wkv6": wkv6_kernel, "ssd_scan": ssd_kernel,
                   "gemm_int8": gemm_kernel}
    launches = {name: 0 for name in kernel_mods}
    split, by_path = {}, {}
    for arch, per_prefill, per_decode in PATHS:
        by_path[arch], split[arch] = drive_path(arch, kernel_mods, per_prefill, per_decode,
                                                report, args.profile)
        launches = {name: launches[name] + by_path[arch][name] for name in kernel_mods}
        gc.collect()  # the path's weights are gone; hand their memory back
        torch.cuda.empty_cache()
    for label, drive in (("resnet50", drive_resnet50), (f"{PIPE_ARCH} pipeline", drive_pipeline)):
        by_path[label] = drive(kernel_mods, report, args.profile)
        launches = {name: launches[name] + by_path[label][name] for name in kernel_mods}
        torch.cuda.empty_cache()
    label = f"{PIPE_ARCH} pipeline ranks"
    by_path[label] = drive_pipeline_ranks(kernel_mods, report)
    launches = {name: launches[name] + by_path[label][name] for name in kernel_mods}
    torch.cuda.empty_cache()
    for arch, depth in TRAIN_PATHS:
        label = f"{arch} train"
        by_path[label] = drive_train(arch, depth, kernel_mods, report, args.profile)
        launches = {name: launches[name] + by_path[label][name] for name in kernel_mods}
        gc.collect()
        torch.cuda.empty_cache()

    # ----------------------------------------------------------- timing --
    b, s = PREFILL_BATCH, PREFILL_LEN
    zcfg = get_config(ZAMBA_ARCH)
    fa_shapes = []
    for label, arch, bb, ss in ((ARCH, ARCH, b, s), (ZAMBA_ARCH, ZAMBA_ARCH, b, s),
                                (f"{PIPE_ARCH} pipeline", PIPE_ARCH, PIPE_MB, PIPE_LEN),
                                (AUDIO_ARCH, AUDIO_ARCH, b, s), (GEMMA_ARCH, GEMMA_ARCH, b, s)):
        c = get_config(arch)
        # as the model's plan sets it; gemma3's window 1024 keeps every causal
        # pair at s 1024, so its local layers compute what its global ones do
        window = c.window if c.attn == "swa" else None
        fa_shapes.append(time_flash(fa_kernel, hw, label, bb, ss, c.num_heads, c.num_kv_heads,
                                    c.resolved_head_dim, window, report))
        torch.cuda.empty_cache()
    # the row's own numbers are the qwen3-0.6b shape's (as in earlier rows);
    # "shapes" holds every main-path shape
    fa_row = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
              "launches": launches["flash_attention"], "max_abs_err": fa_err,
              **{key: fa_shapes[0][key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "bound_fp32_cuda_ms",
                  "library_ms", "library", "timed")},
              "launches_by_path": by_kernel(by_path, "flash_attention"),
              "shapes": fa_shapes}

    rcfg = get_config(RWKV_ARCH)
    P = rcfg.ssm_head_dim
    H = rcfg.d_model // P
    wkv_split = split[RWKV_ARCH]["wkv6"]
    wkv_shapes = [time_wkv6(wkv6_kernel, hw, "prefill", b, s, H, P, report),
                  time_wkv6(wkv6_kernel, hw, "decode", 1, 1, H, P, report)]
    wkv_shapes[0]["launches"] = wkv_split["prefill"]
    wkv_shapes[0]["launches_at_this_shape"] = wkv_split["prefill_full_shape"]
    wkv_shapes[1]["launches"] = wkv_split["decode"]
    wkv_shapes[0]["max_abs_err"], wkv_shapes[1]["max_abs_err"] = wkv6_err, wkv6_decode_err
    wkv_back = time_backward(
        "wkv6", wkv6_ops.WKV6.apply,
        wkv6_inputs(TRAIN_BATCH, TRAIN_LEN, H, P, seed=SEED + 7, model_decay=True),
        "the autograd of wkv6_reference (the sequential recurrence), recomputed from the "
        "saved inputs, cotangents on y and the final state", report)
    # the row's own numbers are the prefill shape's (as in earlier rows);
    # "shapes" holds both main-path shapes, each with its launches
    wkv_row = {"name": "wkv6", "route": "cuda",
               "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
               "replaces": "src/repro/kernels/rwkv6/kernel.py:57",
               "launches": launches["wkv6"], "max_abs_err": wkv6_err,
               **{key: wkv_shapes[0][key] for key in (
                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "timed", "plan")},
               "shapes": wkv_shapes, "launches_by_path": by_kernel(by_path, "wkv6"),
               **wkv_back}

    H, P, N = zcfg.ssm_heads, zcfg.ssm_head_dim, zcfg.ssm_state
    sargs = ssd_inputs(b, s, H, P, N, seed=SEED + 211)
    ssd_ms = cuda_ms(lambda: ssd_kernel.ssd_scan_cuda(*sargs), 20)
    ssd_plain_ms = cuda_ms(lambda: ssd_chunked(*sargs), 5)
    ssd_seq_ms = cuda_ms(lambda: ssd_reference(*sargs), 2, warmup=1)
    ssd_ms2 = cuda_ms(lambda: ssd_kernel.ssd_scan_cuda(*sargs), 20)
    flops = 4 * b * s * H * P * N  # decay*h + (dt x) B and C.h: 4 N P a step and head
    n_bytes = 4 * (sum(x.numel() for x in sargs) + sargs[0].numel() + b * H * N * P)
    sbound_s, sbound_by = hw.bound_seconds(n_bytes, flops, hw.FP32_FLOPS)
    ssd_plan = ssd_kernel.plan(P, N, s)
    report(f"timing ssd_scan fp32 b={b} s={s} H={H} P={P} N={N}: kernel {ssd_ms:.4f} / "
           f"{ssd_ms2:.4f} ms, plain (ssd_chunked) {ssd_plain_ms:.4f} ms, sequential plain "
           f"(ssd_reference) {ssd_seq_ms:.4f} ms, library none (no PyTorch call computes the "
           f"SSD scan), bound {sbound_s * 1e3:.4f} ms by {sbound_by} ({flops / 1e9:.2f} GFLOP "
           f"at fp32 CUDA-core peak {hw.FP32_FLOPS / 1e12:.0f} TFLOP/s; {n_bytes / 1e6:.1f} MB "
           f"at {hw.HBM_BYTES_PER_S / 1e12:.2f} TB/s); plan {json.dumps(ssd_plan)}, "
           f"{b * H * ssd_plan['blocks_per_head']} blocks")
    ssd_back = time_backward(
        "ssd_scan", ssd_ops.SSDScan.apply, ssd_inputs(TRAIN_BATCH, TRAIN_LEN, H, P, N,
                                                      seed=SEED + 212),
        "the autograd of ssd_chunked (chunk 128), recomputed from the saved inputs", report)
    ssd_row = {"name": "ssd_scan", "route": "cuda",
               "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
               "replaces": "src/repro/kernels/ssd_scan/kernel.py:78",
               "launches": launches["ssd_scan"], "max_abs_err": ssd_err, "ms": ssd_ms,
               "plain_ms": ssd_plain_ms, "bound_ms": sbound_s * 1e3, "bound_by": sbound_by,
               "library_ms": None, "timed": "events", "plan": ssd_plan,
               "launches_by_path": by_kernel(by_path, "ssd_scan"), **ssd_back}
    gemm_row = {"name": "gemm_int8", "route": "cuda",
                "source": "src/repro_torch/kernels/gemm_int8/csrc/gemm_int8.cu",
                "replaces": "src/repro/kernels/gemm_int8/kernel.py:62",
                "launches": launches["gemm_int8"], "max_abs_err": gemm_err,
                **time_gemm(gemm_kernel, hw, report)}
    gemm_shape_table(gemm_kernel, report)

    # ------------------------------------------------------------------ dse --
    drive_dse(kernel_mods, report)
    print(f"total: {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [fa_row, wkv_row, ssd_row, gemm_row]}))
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
