#!/usr/bin/env python3
"""Time the flash-attention kernel against variants of its own source, on one
NVIDIA card, and measure the card's mma.sync tensor-core rates.

    python3 tools/flash_variants.py

Each variant is ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
with one textual change (``VARIANTS``), built with the port's nvcc flags
into ``build/kernels/``. Every variant but the one-product one is checked
against ``mha_reference`` (2e-5 at a small windowed shape, 1e-4 at the
timed shapes); each is timed with CUDA events at the three shapes the main
paths launch the kernel at, all variants in turn and then again in reverse
order. A microbenchmark then times independent mma.sync m16n8k8 tf32,
m16n8k16 bf16 and m16n8k32 s8 products (8 accumulators a warp, 8 warps a
block, 4 blocks an SM), the ceiling of the INT8 PU GEMM's instruction. The
last line is a JSON object with every number.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import kept_pairs, mha_reference  # noqa: E402

SPLIT = ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  small = __float_as_uint(x - __uint_as_float(big));\n")
# name -> (old text, new text, checked against the plain version)
VARIANTS = {
    "committed": ("", "", True),
    # the split through cvt.rna.tf32.f32 for big and for small
    "cvt.rna split": (SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));\n'
                             '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : '
                             '"f"(x - __uint_as_float(big)));\n', True),
    # exp2f (with its denormal handling) for ex2.approx.ftz
    "exp2f": ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n',
              "  y = exp2f(x);\n", True),
    # one 16-row q tile a warp (128 q rows a block)
    "16 q rows a warp": ("  static constexpr int MT = 2;", "  static constexpr int MT = 1;", True),
    # one TF32 product a product: wrong beyond 2e-5, timed to price the split
    "one TF32 product": ("  if constexpr (!EXACT_A) mma(d, a.small, b.big);\n"
                         "  if constexpr (!EXACT_B) mma(d, a.big, b.small);\n", "", False),
}
# (label, b, s, H, G, hd, window): qwen3-0.6b and zamba2-7b prefill, the
# h2o-danube-3-4b pipeline's microbatch
SHAPES = [("qwen3-0.6b", 4, 1024, 16, 8, 128, None), ("zamba2-7b", 4, 1024, 32, 32, 112, None),
          ("h2o-danube-3-4b pipeline", 1, 4608, 32, 8, 120, 4096)]

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int TF32>
__global__ void mma_bench(int iters, float* out) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float acc = 0.f;
  for (int c = 0; c < 8; ++c) acc += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (acc == 1.2345f) out[0] = acc;
}
__global__ void mma_bench_s8(int iters, float* out) {
  int d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int acc = 0;
  for (int c = 0; c < 8; ++c) acc += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (acc == 12345) out[0] = (float)acc;
}
// kind 0 = bf16, 1 = tf32, 2 = s8
extern "C" int mma_bench_launch(int kind, int iters, int blocks, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 2) mma_bench_s8<<<blocks, 256, 0, st>>>(iters, out);
  else if (kind == 1) mma_bench<1><<<blocks, 256, 0, st>>>(iters, out);
  else mma_bench<0><<<blocks, 256, 0, st>>>(iters, out);
  return cudaGetLastError();
}
"""


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_variants() -> dict:
    src = fa.SOURCE.read_text()
    out_dir = _build.BUILD_DIR.parent / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (old, new, _)) in enumerate(VARIANTS.items()):
        if old and old not in src:
            raise RuntimeError(f"variant {name!r}: its text is not in {fa.SOURCE.name}")
        path = out_dir / f"flash_variant{i}.cu"
        path.write_text(src.replace(old, new) if old else src)
        paths[name] = path
    bench = out_dir / "mma_bench.cu"
    bench.write_text(MMA_BENCH)
    built = _build.build({**paths, "mma_bench": bench})
    fns = {}
    p, n = ctypes.c_void_p, ctypes.c_int
    for name in VARIANTS:
        fn = ctypes.CDLL(str(built[name].path)).flash_attention_fwd
        fn.argtypes = [p, p, p, p, n, n, n, n, n, n, n, n, ctypes.c_float, n, p]
        fn.restype = n
        fns[name] = fn
    bench_fn = ctypes.CDLL(str(built["mma_bench"].path)).mma_bench_launch
    bench_fn.argtypes = [n, n, n, p, p]
    bench_fn.restype = n
    return fns, bench_fn


def attention(fn, q, k, v, window):
    b, s, H, hd = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, k.shape[1], H,
             k.shape[2], hd, 1, window or 0, 1.0 / math.sqrt(hd), 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")
    return o


def qkv(b, s, H, G, hd, seed=0):
    gen = torch.Generator("cuda").manual_seed(seed)
    return (0.5 * torch.randn(b, s, H, hd, device="cuda", generator=gen),
            0.5 * torch.randn(b, s, G, hd, device="cuda", generator=gen),
            torch.randn(b, s, G, hd, device="cuda", generator=gen))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    fns, bench_fn = build_variants()
    result = {"card": card, "shapes": {}, "max_abs_err": {}, "mma_tflops": {}}

    q, k, v = qkv(1, 333, 8, 2, 120)
    want = mha_reference(q, k, v, window=45)
    for name, fn in fns.items():
        err = (attention(fn, q, k, v, 45) - want).abs().max().item()
        if VARIANTS[name][2] and err > 2e-5:
            raise AssertionError(f"variant {name!r}: max error {err:.3e} beyond 2e-5")
        print(f"check {name}: max_abs_err {err:.3e} (b=1 s=333 H=8 G=2 hd=120 window=45)")

    for label, b, s, H, G, hd, window in SHAPES:
        q, k, v = qkv(b, s, H, G, hd)
        want = mha_reference(q, k, v, window=window)
        errs, times = {}, {name: [] for name in fns}
        for name, fn in fns.items():
            errs[name] = (attention(fn, q, k, v, window) - want).abs().max().item()
            if VARIANTS[name][2] and errs[name] > 1e-4:
                raise AssertionError(f"variant {name!r} at {label}: error {errs[name]:.3e}")
        del want
        iters = 20 if s <= 1024 else 5
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(cuda_ms(lambda: attention(fns[name], q, k, v, window), iters))
        flops = 4 * hd * b * H * kept_pairs(s, s, causal=True, window=window)
        result["shapes"][label] = {name: ms for name, ms in times.items()}
        result["max_abs_err"][label] = errs
        print(f"{label} (b={b} s={s} H={H} G={G} hd={hd} window={window}, "
              f"{flops / 1e9:.2f} GFLOP): " + ", ".join(
                  f"{name} {ms[0]:.4f} / {ms[1]:.4f} ms (err {errs[name]:.2e})"
                  for name, ms in times.items()) + f"  [{card}]")

    out = torch.zeros(4, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    for name, kind, flop in (("tf32 m16n8k8", 1, 2 * 16 * 8 * 8),
                             ("bf16 m16n8k16", 0, 2 * 16 * 8 * 16),
                             ("s8 m16n8k32", 2, 2 * 16 * 8 * 32)):
        def run():
            stream = torch.cuda.current_stream().cuda_stream
            if bench_fn(kind, iters, blocks, out.data_ptr(), stream):
                raise RuntimeError("mma_bench launch failed")

        ms = cuda_ms(run, 3)
        tflops = blocks * 8 * iters * 8 * flop / (ms * 1e-3) / 1e12
        result["mma_tflops"][name] = tflops
        unit = "TOPS" if kind == 2 else "TFLOP/s"
        print(f"mma.sync {name}: {tflops:.1f} {unit} ({blocks} blocks of 8 warps, 8 "
              f"accumulators a warp)  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
