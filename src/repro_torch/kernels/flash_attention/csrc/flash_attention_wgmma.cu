// Flash-attention forward for NVIDIA Hopper (sm_90a) on wgmma: fp32 inputs,
// fp32-accurate products on the TF32 tensor cores (3xTF32), K and V fed by a
// TMA ring, warp-specialised.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_tpu
// (body _attn_kernel) for fp32 inputs at the head sizes ``kernel.py`` routes
// here (WGMMA_HEAD_DIMS); flash_attention.cu keeps bf16 and the other head
// sizes. Same function: blockwise online-softmax GQA attention, kv head =
// h / (H/G), scores scaled by `scale`; a row's valid columns are col < t,
// col <= row when causal, col > row - window when a window is given (q and
// kv positions both count from 0); masked probabilities are exactly 0, m, l
// and the output are fp32, and the output is acc / max(l, 1e-30).
//
// Bound on the card. At h2o-danube-3-4b's prefill (1 x 4608, 32 q / 8 kv
// heads of 120, window 4096) the work is 4 hd H x (kept pairs) = 161.09
// GFLOP against 0.11 GB of q/k/v/o: bound by operations. Three TF32 products
// a product on the tensor cores (3 x 161.09 GFLOP at 495 TFLOP/s) is 0.976
// ms, a ceiling of 165 TFLOP/s of fp32 work. flash_attention.cu reaches it
// through mma.sync, whose tf32 rate on the H100 is ~323 TFLOP/s, so its
// ceiling is ~108; wgmma is the instruction that reaches the 495.
//
// What the design does about it:
// - wgmma reads a TF32 operand K-major only, B from shared memory. S = Q K^T
//   takes K as TMA lands it (rows of hd, 128-byte swizzled chunks of 32).
//   O += P V needs V^T (hd rows of kv): the producer's split warps write it,
//   transposed, from the V tile TMA landed. Its kv index is permuted within
//   each 8 so that S's accumulator is P's A fragment with no shuffle: k slot
//   t is kv row 2t, slot t + 4 is row 2t + 1 (flash_attention.cu does the
//   same with mma.sync).
// - 3xTF32: a.b = a_small.b_big + a_big.b_small + a_big.b_big, each operand
//   split as big = the value rounded to TF32 on the integer pipe (cvt.rna for
//   finite values) and small = the remainder, read truncated by the tensor
//   cores. K's and V^T's splits are made once a tile, in shared memory, by
//   the producer warpgroup, and serve both consumer warpgroups. Q (raw, in
//   shared memory, loaded once by TMA) and P (in registers) are A operands,
//   split in registers as each k step's fragment is read.
// - The tensor cores add to their accumulators with truncation (gemm_f32.cu,
//   ref.py). S sums hd / 8 k steps of three products in one accumulator
//   (45 adds at hd 120), which ref.py's model holds within fp32 attention's
//   error. Each kv tile's P V goes to a fresh partial (4 k steps, 12 adds)
//   that is added, rounded to nearest, to the rescaled output on the CUDA
//   cores (one FFMA: O = O alpha + partial, the online softmax's rescale).
//   One accumulator over a 4096-wide window would drift (ref.py's twin).
// - Warp roles: one producer warpgroup (lane 0 of its first warp issues the
//   TMA loads; its other three warps split K in place into big plus a small
//   plane, and V into V^T big and small) keeps a ring of two stages behind
//   mbarriers (full: landed; ready: split; empty: both consumers done). Two
//   consumer warpgroups of 64 q rows run S as 3 wgmma m64n32k8 a k step and
//   P V as 3 wgmma m64n<hd>k8 a k step; setmaxnreg moves registers from the
//   producers (40 a thread) to the consumers (232), which hold O (hd / 2),
//   the partial (hd / 2), S and P's split.
// - Masking as flash_attention.cu: the per-element mask only on tiles that
//   cross the causal diagonal, the window's left edge or t, per warpgroup;
//   tiles wholly masked for the block are not loaded, and a warpgroup skips
//   those wholly masked for its rows. TMA fills q rows past s and kv rows
//   past t with zeros. The heaviest causal q tiles are launched first.
//
// Tiles: 128 q rows a block (two warpgroups of 64), 32-row kv tiles, two
// stages. Shared memory at hd 120: q 64 KB (4 chunks of 32, the last one a
// quarter padding), a stage 77 KB (K big and small 32 KB, V as landed 15 KB,
// V^T big and small 30 KB): 224,312 B with the alignment slack and the
// barriers (230,456 B at hd 128). Registers (nvcc -Xptxas -v, sm_90a): 168
// a thread at launch at hd 64, 112, 120 and 128, 40 / 232 after setmaxnreg,
// no spills. Big is rounded (as flash_attention.cu), small goes in raw.
// On the H100 (700 W) it runs 83.8 TFLOP/s of fp32 work at 1 x 4608 (1.92
// ms against mma.sync's 2.59), 51 % of its bound: each warpgroup runs S, the
// softmax, P V and the output update in order, and Q is split again on
// every kv tile (its split planes and two stages do not fit 227 KB).
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success), -1 for a head size not built here, -2 for a pointer TMA cannot
// take (16-byte aligned), -3 if the driver has no cuTensorMapEncodeTiled,
// and -100 - r for a CUresult r of the encoder.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 32;                          // kv rows a tile: one 128-byte row of V^T
constexpr int CONSUMERS = 2;                    // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;              // q rows a block
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
constexpr int SPLITTERS = 96;                   // the producer warpgroup less its load warp
constexpr int STAGES = 2;
constexpr int MAX_DEVICES = 64;

template <int HD>
struct Geometry {
  static constexpr int CH = (HD + 31) / 32;        // 32-wide chunks of a q or k row
  static constexpr int KSTEPS = HD / 8;            // wgmma k steps of S over hd
  static constexpr int Q_BYTES = CH * BQ * 128;    // q as landed: [chunk][row][128 B]
  static constexpr int K_PLANE = CH * BK * 128;    // k big (in place) or small
  static constexpr int VT_PLANE = HD * BK * 4;     // v^T big or small: [hd row][128 B]
  static constexpr int V_RAW = BK * HD * 4;        // v as landed: [kv row][hd]
  static constexpr int KS = K_PLANE, VB = 2 * K_PLANE, VS = VB + VT_PLANE, VR = VS + VT_PLANE;
  static constexpr int STAGE = VR + V_RAW;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + (3 * STAGES + 1) * 8;
  static_assert(HD % 8 == 0 && HD <= 128, "whole k steps; O and its partial in registers");
  static_assert(STAGE % 1024 == 0, "every plane starts on a 1024-byte swizzle atom");
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = big + small to fp32 accuracy: big is x rounded to TF32, to nearest
// with ties away from zero (cvt.rna.tf32.f32 for finite x) on the integer
// pipe; small = x - big, exact in fp32, read by the tensor cores truncated.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x to ~2 ulp; 0 below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the 4 lanes that share a row of an accumulator fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a 4-D box of the tensor map at (c0 innermost, ..., c3) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma's descriptor of a K-major operand under the 128-byte swizzle: rows of
// 128 B, 8-row groups 1024 B apart (SBO), the start inside a 1024-aligned atom
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps registers the async wgmma reads or writes where they are until here
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 32, fp32, 16 a thread) += a (64 x 8, tf32 in registers) b (8 x 32, tf32 by descriptor)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32, 32 a thread) += a (64 x 8, tf32 in registers) b (8 x 64, tf32 by descriptor)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 112, fp32, 56 a thread) += a (64 x 8, tf32 in registers) b (8 x 112, tf32 by descriptor)
__device__ __forceinline__ void wgmma_n112(float (&d)[56], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 120, fp32, 60 a thread) += a (64 x 8, tf32 in registers) b (8 x 120, tf32 by descriptor)
__device__ __forceinline__ void wgmma_n120(float (&d)[60], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 128, fp32, 64 a thread) += a (64 x 8, tf32 in registers) b (8 x 128, tf32 by descriptor)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x N) += a b: S's tile (N = BK) or P V's (N = hd)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (N == 32) wgmma_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, a, b, scale_d);
  else if constexpr (N == 112) wgmma_n112(d, a, b, scale_d);
  else if constexpr (N == 120) wgmma_n120(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_n128(d, a, b, scale_d);
  else static_assert(N == 32, "no wgmma of this width here");
}

// the maps: q (b, s, H, hd) in boxes of 32 d x 1 head x BQ rows, k (b, t, G,
// hd) in boxes of 32 d x 1 x BK rows, both 128-byte swizzled; v in boxes of
// hd x 1 x BK rows as they lie. o (b, s, H, hd) contiguous.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv, float* __restrict__ o,
                           int s, int t, int H, int G, int causal, int window,
                           float scale_log2) {
  using L = Geometry<HD>;
  constexpr int NT = BK / 8;  // 8-wide column blocks of S; k steps of P V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle's atoms start 1024-aligned in the shared window
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::Q_BYTES;  // [stage][k big, k small, v^T big, v^T small, v]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;  // heaviest causal tiles first
  const int g = h / (H / G);
  // kv tiles that can hold a valid column for some row of this q tile
  const int kv_end = causal ? min(t, q0 + BQ) : t;
  const int kt_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
  const int tiles = max(0, (kv_end + BK - 1) / BK - kt_begin);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], SPLITTERS);      // every split thread
      mbar_init(&empty[i], CONSUMERS * 4);  // each consumer warp's lane 0
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == CONSUMERS * 4) {
      // the load warp: its lane 0 loads q once and keeps the ring full
      if (lane == 0) {
        mbar_expect_tx(qbar, L::Q_BYTES);
        for (int c = 0; c < L::CH; ++c)
          tma_load(smem_u32(smem + c * BQ * 128), &tmq, 32 * c, h, q0, bi, qbar);
        for (int i = 0; i < tiles; ++i) {
          const int st = i % STAGES, k0 = (kt_begin + i) * BK;
          mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);  // the first round passes
          const uint32_t dst = smem_u32(ring + st * L::STAGE);
          mbar_expect_tx(&full[st], L::K_PLANE + L::V_RAW);
          for (int c = 0; c < L::CH; ++c)
            tma_load(dst + c * BK * 128, &tmk, 32 * c, g, k0, bi, &full[st]);
          tma_load(dst + L::VR, &tmv, 0, g, k0, bi, &full[st]);
        }
      }
    } else {
      // the split warps: k into big (in place) and small, v into v^T big and
      // small with its kv index permuted, as each tile lands
      const int p = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
      for (int i = 0; i < tiles; ++i) {
        const int st = i % STAGES;
        mbar_wait(&full[st], (i / STAGES) & 1);
        uint8_t* stage = ring + st * L::STAGE;
        float4* kb = reinterpret_cast<float4*>(stage);
        float4* ks = reinterpret_cast<float4*>(stage + L::KS);
#pragma unroll 2
        for (int j = p; j < L::K_PLANE / 16; j += SPLITTERS) {
          const float4 x = kb[j];
          uint4 b, sm;
          split(x.x, b.x, sm.x);
          split(x.y, b.y, sm.y);
          split(x.z, b.z, sm.z);
          split(x.w, b.w, sm.w);
          kb[j] = *reinterpret_cast<const float4*>(&b);
          ks[j] = *reinterpret_cast<const float4*>(&sm);
        }
        // v^T's row n (a d index) holds the tile's 32 kv rows in 16-byte
        // units, unit 2m the rows 8m, 8m+2, 8m+4, 8m+6 and unit 2m+1 the odd
        // ones, under the 128-byte swizzle (unit ^ n % 8)
        const float* vr = reinterpret_cast<const float*>(stage + L::VR);
        for (int it = p; it < HD * NT; it += SPLITTERS) {
          const int n = it % HD, m = it / HD;
          float x[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) x[r] = vr[(8 * m + r) * HD + n];
          uint4 b[2], sm[2];
#pragma unroll
          for (int odd = 0; odd < 2; ++odd) {
            split(x[odd], b[odd].x, sm[odd].x);
            split(x[odd + 2], b[odd].y, sm[odd].y);
            split(x[odd + 4], b[odd].z, sm[odd].z);
            split(x[odd + 6], b[odd].w, sm[odd].w);
            const int off = n * 128 + (((2 * m + odd) ^ (n % 8)) * 16);
            *reinterpret_cast<uint4*>(stage + L::VB + off) = b[odd];
            *reinterpret_cast<uint4*>(stage + L::VS + off) = sm[odd];
          }
        }
        // the generic writes, visible to wgmma's async reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&ready[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp / 4, wiw = warp % 4, gr = lane / 4, tg = lane % 4;
    const int w_lo = q0 + 64 * wg, w_hi = w_lo + 63;  // this warpgroup's q rows
    const int row0 = w_lo + 16 * wiw + gr;             // the thread's rows: row0, row0 + 8
    // the thread's q values, rows row0 and row0 + 8 at d = t and t + 4 of a
    // k step: chunk kk / 4, 16-byte unit 2 (kk % 4) (+1) ^ gr under the swizzle
    const uint8_t* qa = smem + (64 * wg + 16 * wiw + gr) * 128 + tg * 4;

    float acc[HD / 2], part[HD / 2], sc[BK / 2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = part[j] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    mbar_wait(qbar, 0);

    for (int i = 0; i < tiles; ++i) {
      const int st = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      mbar_wait(&full[st], phase);
      mbar_wait(&ready[st], phase);
      const int k0 = (kt_begin + i) * BK;
      const bool skip = w_lo >= s || (causal && k0 > w_hi) ||
                        (window > 0 && k0 + BK - 1 <= w_lo - window);
      float alpha[2];
      if (!skip) {
        const uint32_t stage = smem_u32(ring + st * L::STAGE);
        // S = Q K^T: each k step's q fragment split as it is read; one set of
        // registers in flight while the next is filled
        uint32_t qb[2][4], qs[2][4];
#pragma unroll
        for (int kk = 0; kk < L::KSTEPS; ++kk) {
          const int hh = kk & 1, u = 2 * (kk % 4);
          const uint8_t* qc = qa + (kk / 4) * (BQ * 128);
          split(*reinterpret_cast<const float*>(qc + ((u ^ gr) * 16)), qb[hh][0], qs[hh][0]);
          split(*reinterpret_cast<const float*>(qc + 1024 + ((u ^ gr) * 16)), qb[hh][1],
                qs[hh][1]);
          split(*reinterpret_cast<const float*>(qc + (((u + 1) ^ gr) * 16)), qb[hh][2],
                qs[hh][2]);
          split(*reinterpret_cast<const float*>(qc + 1024 + (((u + 1) ^ gr) * 16)), qb[hh][3],
                qs[hh][3]);
          wgmma_fence();
          const uint32_t kd = stage + (kk / 4) * (BK * 128) + (kk % 4) * 32;
          wgmma<BK>(sc, qs[hh], desc_sw128(kd), kk != 0);  // a tile's first step starts afresh
          wgmma<BK>(sc, qb[hh], desc_sw128(kd + L::KS), 1);
          wgmma<BK>(sc, qb[hh], desc_sw128(kd), 1);
          wgmma_commit();
          if (kk < L::KSTEPS - 1) {
            wgmma_wait<1>();  // the step before is done: its registers are free
            hold(qb[hh ^ 1]);
            hold(qs[hh ^ 1]);
          }
        }
        wgmma_wait<0>();
        hold(sc);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          hold(qb[j]);
          hold(qs[j]);
        }

        // online softmax in base 2; masked probabilities exactly 0. sc[4j + c]
        // is row row0 + 8 (c / 2), column k0 + 8j + 2 tg + c % 2
        const bool need_mask = k0 + BK > t || (causal && k0 + BK - 1 > w_lo) ||
                               (window > 0 && k0 <= w_hi - window);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float x = sc[4 * j + c] * scale_log2;
            if (need_mask) {
              const int row = row0 + (c < 2 ? 0 : 8);
              const int col = k0 + 8 * j + 2 * tg + (c & 1);
              bool ok = col < t;
              if (causal) ok = ok && col <= row;
              if (window > 0) ok = ok && col > row - window;
              if (!ok) x = NEG_INF;
            }
            sc[4 * j + c] = x;
            mx[c >> 1] = fmaxf(mx[c >> 1], x);
          }
        float base[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          base[r] = m_new == NEG_INF ? 0.f : m_new;  // a row masked so far: exp2 gives 0
          alpha[r] = fast_exp2(m[r] - base[r]);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // P as P V's A fragments: k slot tg of step j is S's column 2 tg, slot
        // tg + 4 column 2 tg + 1, which v^T's permuted rows match
        uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float p[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p[c] = fast_exp2(sc[4 * j + c] - base[c >> 1]);
            l[c >> 1] += p[c];
          }
          split(p[0], pb[j][0], ps[j][0]);
          split(p[2], pb[j][1], ps[j][1]);
          split(p[1], pb[j][2], ps[j][2]);
          split(p[3], pb[j][3], ps[j][3]);
        }
        // this tile's P V into a fresh partial
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t vd = stage + L::VB + 32 * j;
          wgmma<HD>(part, ps[j], desc_sw128(vd), j != 0);
          wgmma<HD>(part, pb[j], desc_sw128(vd + L::VT_PLANE), 1);
          wgmma<HD>(part, pb[j], desc_sw128(vd), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(part);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          hold(pb[j]);
          hold(ps[j]);
        }
      }
      if (lane == 0) mbar_arrive(&empty[st]);  // skipped or done: the stage is free
      if (!skip) {
        // the rescaled output plus the partial, rounded to nearest (one FFMA);
        // acc[4n + c] is row row0 + 8 (c / 2), column 8n + 2 tg + c % 2
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) acc[j] = fmaf(acc[j], alpha[(j >> 1) & 1], part[j]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float inv = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
      if (row >= s) continue;
      float* orow = o + (((int64_t)bi * s + row) * H + h) * HD + 2 * tg;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous fp32 (b, rows, heads, hd) tensor as a 4-D map (hd innermost),
// in boxes of box_d x 1 head x box_rows; zeros past its edges
int encode(CUtensorMap* map, const float* p, int b, int rows, int heads, int hd, int box_d,
           int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -3;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * hd * 4;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 4, row, row * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -100 - static_cast<int>(r);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int b, int s, int t,
           int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using L = Geometry<HD>;
  // Above 48 KB a launch is refused unless the kernel opts in, once per
  // device and instantiation (two threads racing here set the same value).
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  // a map needs a row: at t = 0 no kv tile is loaded, and a one-row map is never read
  const int rows = t > 0 ? t : 1;
  CUtensorMap tmq, tmk, tmv;
  int bad = encode(&tmq, q, b, s, H, HD, 32, BQ, CU_TENSOR_MAP_SWIZZLE_128B);
  if (bad == 0) bad = encode(&tmk, k, b, rows, G, HD, 32, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (bad == 0) bad = encode(&tmv, v, b, rows, G, HD, HD, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (bad != 0) return bad;
  const dim3 grid(H, b, (s + BQ - 1) / BQ);
  flash_fwd_kernel_wgmma<HD><<<grid, THREADS, L::SMEM, stream>>>(
      tmq, tmk, tmv, o, s, t, H, G, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

template <int HD>
int plan_of(int* out) {
  out[0] = THREADS;
  out[1] = Geometry<HD>::SMEM;
  out[2] = BQ;
  out[3] = BK;
  return 0;
}

}  // namespace

// The launch flash_attention_wgmma_fwd makes at head size hd: out[0] threads
// a block, out[1] dynamic shared memory bytes, out[2] q rows a block, out[3]
// kv rows a tile. Touches no device.
extern "C" int flash_attention_wgmma_plan(int hd, int* out) {
  switch (hd) {
    case 64: return plan_of<64>(out);
    case 112: return plan_of<112>(out);
    case 120: return plan_of<120>(out);
    case 128: return plan_of<128>(out);
    default: return -1;
  }
}

// q (b, s, H, hd), k and v (b, t, G, hd), o (b, s, H, hd), fp32, contiguous,
// 16-byte aligned and on the current device; stream belongs to that device.
// window <= 0 means no window.
extern "C" int flash_attention_wgmma_fwd(const float* q, const float* k, const float* v,
                                         float* o, int b, int s, int t, int H, int G, int hd,
                                         int causal, int window, float scale, void* stream) {
  if (b == 0 || s == 0 || H == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, b, s, t, H, G, causal, window, scale, st);
    case 112: return launch<112>(q, k, v, o, b, s, t, H, G, causal, window, scale, st);
    case 120: return launch<120>(q, k, v, o, b, s, t, H, G, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, o, b, s, t, H, G, causal, window, scale, st);
    default: return -1;
  }
}
