#!/usr/bin/env python3
"""Time the two flash-attention kernels against each other, and the mma.sync
one against variants of its own source, on one NVIDIA card; measure the
card's mma.sync and wgmma tensor-core rates.

    python3 tools/flash_variants.py [--variants]

The two kernels are ``csrc/flash_attention.cu`` (mma.sync) and
``csrc/flash_attention_wgmma.cu`` (wgmma) under
``src/repro_torch/kernels/flash_attention/``, both fp32, each called through
its own C entry point whatever ``kernel.route`` picks, at the five shapes the
main paths launch them at and at the two prefill cells' shapes (the wgmma
kernel at the head sizes it builds). With ``--variants`` each variant of the
mma.sync source (``VARIANTS``: one textual change each, built with the port's
nvcc flags into ``build/flash_variants/``) is timed beside them. Every
kernel but the one-product variant is checked against ``mha_reference``
(2e-5 at a small windowed shape, 1e-4 at the timed shapes; ``plain_attention``
beyond 4096 rows); each is timed with CUDA events, all in turn and then again
in reverse order. Microbenchmarks then time independent mma.sync m16n8k8
tf32, m16n8k16 bf16 and m16n8k32 s8 products (8 accumulators a warp, 8 warps
a block, 4 blocks an SM) and wgmma m64nNk8 tf32 with A in registers (two
warpgroups an SM, 16 products a group, two groups in flight) at the widths
the wgmma kernel uses. The last line is a JSON object with every number.
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
from repro_torch.kernels.flash_attention.ops import plain_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import kept_pairs, mha_reference  # noqa: E402

SPLIT = ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  small = __float_as_uint(x - __uint_as_float(big));\n")
# name -> (old text, new text, checked against the plain version)
VARIANTS = {
    "mma.sync": ("", "", True),  # the committed source
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
# (label, b, s, H, G, hd, window, scale): the main paths' prefills (qwen3-0.6b,
# the zamba2-7b preset, h2o-danube-3-4b's pipeline microbatch, musicgen-large,
# gemma3-4b), then the h2o.prefill and zamba2.prefill cells' calls
SHAPES = [("qwen3-0.6b", 4, 1024, 16, 8, 128, None, None),
          ("zamba2-7b", 4, 1024, 32, 32, 112, None, None),
          ("h2o-danube-3-4b pipeline", 1, 4608, 32, 8, 120, 4096, None),
          ("musicgen-large", 4, 1024, 32, 32, 64, None, None),
          ("gemma3-4b", 4, 1024, 8, 4, 256, 1024, None),
          ("h2o.prefill", 2, 4608, 32, 8, 120, 4096, None),
          ("zamba2.prefill", 4, 4096, 32, 32, 224, None, (224 / 2) ** -0.5)]
WGMMA_NS = (32, 64, 112, 120, 128, 256)  # wgmma widths: S's kv tile, P V's head sizes, the widest

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

// wgmma m64nNk8 tf32, A in registers, B by descriptor from a 128-byte
// swizzled tile in shared memory: 16 products a group into one accumulator,
// two groups in flight, two warpgroups a block, one block an SM
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
WGMMA_FNS
template <int N>
__global__ void __launch_bounds__(256, 1) wgmma_bench(int iters, float* out) {
  extern __shared__ __align__(1024) uint8_t raw[];
  uint8_t* b = raw + ((1024 - ((uint32_t)__cvta_generic_to_shared(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < N * 32; i += 256) reinterpret_cast<float*>(b)[i] = 1e-3f * (i % 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint64_t desc = desc_sw128((uint32_t)__cvta_generic_to_shared(b));
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j) wgmma_n<N>(d, a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  float acc = 0.f;
  for (int i = 0; i < N / 2; ++i) acc += d[i];
  if (acc == 1.2345f) out[0] = acc;
}
extern "C" int wgmma_bench_launch(int n, int iters, int blocks, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = n * 128 + 1024;
#define WGMMA_BENCH(N)                                                                  \
  if (n == N) {                                                                        \
    cudaFuncSetAttribute(wgmma_bench<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    wgmma_bench<N><<<blocks, 256, smem, st>>>(iters, out);                              \
    return cudaGetLastError();                                                          \
  }
  WGMMA_BENCH(32) WGMMA_BENCH(64) WGMMA_BENCH(112) WGMMA_BENCH(120) WGMMA_BENCH(128)
  WGMMA_BENCH(256)
  return -1;
}
"""


def wgmma_fns(ns) -> str:
    """``wgmma_n<N>``: one wgmma m64nNk8 tf32 (A in registers) for each N."""
    out = ["template <int N> __device__ void wgmma_n(float (&d)[N / 2], const uint32_t (&a)[4], "
           "uint64_t b);"]
    for n in ns:
        r = n // 2
        regs = ", ".join(f"%{i}" for i in range(r))
        outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
        out.append(
            f"template <> __device__ __forceinline__ void wgmma_n<{n}>(float (&d)[{r}], "
            f"const uint32_t (&a)[4], uint64_t b) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'               "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{regs}}}, '
            f'{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}\\n"\n'
            f'               : {outs}\n'
            f'               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));\n}}')
    return "\n".join(out)


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


def _entry(lib, name):
    fn = getattr(ctypes.CDLL(str(lib.path)), name)
    p, n = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p, p, p, p, n, n, n, n, n, n, n, n, ctypes.c_float, n, p]
                   if name == "flash_attention_fwd" else
                   [p, p, p, p, n, n, n, n, n, n, n, n, ctypes.c_float, p])
    fn.restype = n
    return fn


def build_kernels(variants: bool):
    """{name: (C entry point, takes a dtype argument)} of the wgmma kernel,
    the mma.sync one and, with ``variants``, each variant of the mma.sync
    source; and the microbenchmarks' launchers."""
    src = fa.SOURCE.read_text()
    out_dir = _build.BUILD_DIR.parent / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {"wgmma": fa.SOURCE_WGMMA}
    for i, (name, (old, new, _)) in enumerate(VARIANTS.items()):
        if name != "mma.sync" and not variants:
            continue
        if old and old not in src:
            raise RuntimeError(f"variant {name!r}: its text is not in {fa.SOURCE.name}")
        path = out_dir / f"flash_variant{i}.cu"
        path.write_text(src.replace(old, new) if old else src)
        paths[name] = path
    bench = out_dir / "mma_bench.cu"
    bench.write_text(MMA_BENCH.replace("WGMMA_FNS", wgmma_fns(WGMMA_NS)))
    built = _build.build({**paths, "mma_bench": bench})
    fns = {name: (_entry(built[name], "flash_attention_wgmma_fwd" if name == "wgmma"
                         else "flash_attention_fwd"), name != "wgmma") for name in paths}
    lib = ctypes.CDLL(str(built["mma_bench"].path))
    p, n = ctypes.c_void_p, ctypes.c_int
    benches = []
    for name in ("mma_bench_launch", "wgmma_bench_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [n, n, n, p, p]
        fn.restype = n
        benches.append(fn)
    return fns, benches


def attention(entry, q, k, v, window, scale=None):
    fn, with_dtype = entry
    b, s, H, hd = q.shape
    o = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, k.shape[1], H,
            k.shape[2], hd, 1, window or 0, scale or 1.0 / math.sqrt(hd)]
    err = fn(*args, *([0] if with_dtype else []), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")
    return o


def qkv(b, s, H, G, hd, seed=0):
    gen = torch.Generator("cuda").manual_seed(seed)
    return (0.5 * torch.randn(b, s, H, hd, device="cuda", generator=gen),
            0.5 * torch.randn(b, s, G, hd, device="cuda", generator=gen),
            torch.randn(b, s, G, hd, device="cuda", generator=gen))


def checked(name) -> bool:
    return name == "wgmma" or VARIANTS[name][2]


def main() -> int:
    variants = "--variants" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    fns, (bench_fn, wgmma_bench_fn) = build_kernels(variants)
    result = {"card": card, "shapes": {}, "max_abs_err": {}, "mma_tflops": {},
              "wgmma_tflops": {}}
    wgmma_hds = [hd for hd in fa.HEAD_DIMS if hd in (64, 112, 120, 128)]

    q, k, v = qkv(1, 333, 8, 2, 120)
    want = mha_reference(q, k, v, window=45)
    for name, fn in fns.items():
        err = (attention(fn, q, k, v, 45) - want).abs().max().item()
        if checked(name) and err > 2e-5:
            raise AssertionError(f"kernel {name!r}: max error {err:.3e} beyond 2e-5")
        print(f"check {name}: max_abs_err {err:.3e} (b=1 s=333 H=8 G=2 hd=120 window=45)")

    for label, b, s, H, G, hd, window, scale in SHAPES:
        q, k, v = qkv(b, s, H, G, hd)
        run = {name: fn for name, fn in fns.items() if name != "wgmma" or hd in wgmma_hds}
        want = (mha_reference if s <= 4096 and b * H <= 128 else plain_attention)(
            q, k, v, window=window, scale=scale)
        errs, times = {}, {name: [] for name in run}
        for name, fn in run.items():
            errs[name] = (attention(fn, q, k, v, window, scale) - want).abs().max().item()
            if checked(name) and errs[name] > 1e-4:
                raise AssertionError(f"kernel {name!r} at {label}: error {errs[name]:.3e}")
        del want
        torch.cuda.empty_cache()
        iters = 20 if s <= 1024 else 5
        for order in (list(run), list(run)[::-1]):
            for name in order:
                times[name].append(cuda_ms(lambda: attention(run[name], q, k, v, window, scale),
                                           iters))
        flops = 4 * hd * b * H * kept_pairs(s, s, causal=True, window=window)
        result["shapes"][label] = {name: ms for name, ms in times.items()}
        result["max_abs_err"][label] = errs
        print(f"{label} (b={b} s={s} H={H} G={G} hd={hd} window={window}, "
              f"{flops / 1e9:.2f} GFLOP): " + ", ".join(
                  f"{name} {ms[0]:.4f} / {ms[1]:.4f} ms, {flops / min(ms) / 1e9:.1f} TFLOP/s "
                  f"(err {errs[name]:.2e})" for name, ms in times.items()) + f"  [{card}]")
        del q, k, v
        torch.cuda.empty_cache()
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
    for n in WGMMA_NS:
        def run():
            stream = torch.cuda.current_stream().cuda_stream
            if wgmma_bench_fn(n, iters, sms, out.data_ptr(), stream):
                raise RuntimeError("wgmma_bench launch failed")

        ms = cuda_ms(run, 3)
        tflops = sms * 2 * iters * 16 * 2 * 64 * n * 8 / (ms * 1e-3) / 1e12
        result["wgmma_tflops"][f"tf32 m64n{n}k8"] = tflops
        print(f"wgmma tf32 m64n{n}k8: {tflops:.1f} TFLOP/s ({sms} blocks of 2 warpgroups, A in "
              f"registers, 16 products a group, 2 groups in flight)  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
