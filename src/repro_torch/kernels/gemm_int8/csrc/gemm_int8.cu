// INT8 PU GEMM for NVIDIA Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces: src/repro/kernels/gemm_int8/kernel.py:62 gemm_int8_tpu (body
// _gemm_kernel). Same function: out = sat8(relu(((a @ w + bias + r) >> shift)
// + residual)), with a (M, K) int8, w (K, N) int8 row-major (N contiguous, as
// in JAX), bias (N,) int32, residual (M, N) int8 or null, int32 accumulation,
// r = 2^(shift-1) for shift > 0 (round half up) and 0 for shift == 0, an
// arithmetic right shift, the residual added after the shift, ReLU optional,
// and saturation to [-128, 127] (never a wrap).
//
// No overflow: |a w| <= 2^14 per term, so |acc| <= 2^14 K, 7.5e7 at
// ResNet-50's largest K (4608), far inside int32 with the bias and the
// rounding term; the accumulator is not widened. The epilogue's adds are done
// on uint32 so that an out-of-range bias wraps as JAX's int32 does instead of
// being undefined.
//
// Bound on the card: at ResNet-50's most frequent GEMM (layer3's 3x3 conv at
// batch 16: M = 4096, N = 256, K = 2304) the work is 4.83 G int8 operations,
// 2.44 us at 1979 TOPS, and the kernel must read a (9.44 MB) and w (0.59 MB)
// and write the output (1.05 MB), 3.31 us at 3.35 TB/s: bound by bytes, and
// at the scale of a launch.
//
// Design: the TPU kernel carries an int32 VMEM accumulator across a
// sequential K axis of its grid. Here one block of 256 threads owns a
// 128 x 64 output tile and loops over K itself in steps of 64, the
// accumulator in registers: 8 warps as 4 (M) x 2 (N), each warp a 32 x 32
// sub-tile of 2 x 4 mma.sync.m16n8k32 s8 products. The operands want four
// consecutive K bytes in each 32-bit register, for a along its rows and for
// w along its columns, so the a tile is staged in shared memory as it is
// (row-major, K contiguous) and the w tile transposed on its way in: each
// thread loads a 4 (K) x 4 (N) byte block, transposes it in registers with
// byte permutes, and stores four words, one per column. Shared rows are 80
// bytes (64 + 16 of padding), so fragment reads and the transposed stores are
// free of bank conflicts. The next K tile is loaded into registers while the
// current one is multiplied. Ragged edges: bytes past M, N or K load as zero,
// the way the Pallas kernel masks its last K block, so they add nothing;
// 16-byte loads of a where K % 16 == 0 and a is 16-byte aligned, 4-byte
// loads of w where N % 4 == 0 and w is 4-byte aligned, byte loads otherwise
// (K = 147 at ResNet-50's conv1). A K step of 32 that lies wholly past K is
// skipped. The epilogue is fused: each thread finishes its accumulators and
// writes int8 bytes. A faster kernel (wgmma, TMA, a pipelined ring of tiles)
// is later work.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success) or -1 for arguments out of range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows (M) a block
constexpr int BN = 64;   // output columns (N) a block
constexpr int BK = 64;   // K bytes a tile
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;  // bytes a shared row: 16-byte aligned, conflict-free
constexpr int LDW = LDS / 4;  // the same in 32-bit words

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

template <bool VEC_A, bool VEC_W>
__global__ void __launch_bounds__(THREADS)
gemm_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ bias, const int8_t* __restrict__ residual,
                 int8_t* __restrict__ out, int M, int N, int K, int shift, int relu) {
  __shared__ __align__(16) uint8_t sa[BM * LDS];  // a tile, [m][k]
  __shared__ __align__(16) uint8_t sw[BN * LDS];  // w tile transposed, [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // what this thread loads: a rows ar and ar + 64, bytes ac..ac+15 of the
  // tile's K; w rows (K) wk..wk+3 of the tile, columns (N) wn4..wn4+3
  const int ar = tid >> 2, ac = (tid & 3) * 16;
  const int wk = (tid & 15) * 4, wn4 = (tid >> 4) * 4;

  uint4 ra[2];
  uint32_t rw[4];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + ar + 64 * i, gk = k0 + ac;
      if (VEC_A) {
        ra[i] = (gm < M && gk < K)
                    ? *reinterpret_cast<const uint4*>(a + (size_t)gm * K + gk)
                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (gm < M) {
          const int8_t* row = a + (size_t)gm * K;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (gk + j < K) v[j >> 2] |= (uint32_t)(uint8_t)row[gk + j] << (8 * (j & 3));
        }
        ra[i] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gk = k0 + wk + r, gn = n0 + wn4;
      uint32_t v = 0u;
      if (gk < K) {
        if (VEC_W) {
          if (gn < N) v = *reinterpret_cast<const uint32_t*>(w + (size_t)gk * N + gn);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) v |= (uint32_t)(uint8_t)w[(size_t)gk * N + gn + j] << (8 * j);
        }
      }
      rw[r] = v;
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(sa + (ar + 64 * i) * LDS + ac) = ra[i];
    // transpose the 4x4 byte block: word j of the result holds column j's
    // four K bytes, lowest K first
    const uint32_t t0 = __byte_perm(rw[0], rw[1], 0x5140);
    const uint32_t t1 = __byte_perm(rw[0], rw[1], 0x7362);
    const uint32_t t2 = __byte_perm(rw[2], rw[3], 0x5140);
    const uint32_t t3 = __byte_perm(rw[2], rw[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(sw + (wn4 + j) * LDS + wk) = col[j];
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const uint32_t* sa32 = reinterpret_cast<const uint32_t*>(sa);
  const uint32_t* sw32 = reinterpret_cast<const uint32_t*>(sw);

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous tile has been read by every warp
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);  // in flight while this tile is multiplied
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      if (k0 + ks * 32 >= K) break;  // uniform over the block
      const int kw = ks * 8;  // word offset of this K step in a shared row
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + g;
        af[mi][0] = sa32[row * LDW + kw + t];
        af[mi][1] = sa32[(row + 8) * LDW + kw + t];
        af[mi][2] = sa32[row * LDW + kw + t + 4];
        af[mi][3] = sa32[(row + 8) * LDW + kw + t + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + g;
        bf[ni][0] = sw32[col * LDW + kw + t];
        bf[ni][1] = sw32[col * LDW + kw + t + 4];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // epilogue: accumulator e of (mi, ni) is row g (+8 for e >= 2), column
  // 2t + (e & 1) of that 16 x 8 product
  const int32_t half = shift > 0 ? (int32_t)(1u << (shift - 1)) : 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
        const int gn = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (gm >= M || gn >= N) continue;
        int32_t v = wrap_add(acc[mi][ni][e], bias[gn]);
        v = wrap_add(v, half) >> shift;  // arithmetic on int32_t
        const size_t o = (size_t)gm * N + gn;
        if (residual != nullptr) v = wrap_add(v, residual[o]);
        if (relu) v = max(v, 0);
        out[o] = (int8_t)min(max(v, -128), 127);
      }
}

template <bool VEC_A, bool VEC_W>
int launch(const int8_t* a, const int8_t* w, const int32_t* bias, const int8_t* residual,
           int8_t* out, int M, int N, int K, int shift, int relu, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_int8_kernel<VEC_A, VEC_W>
      <<<grid, THREADS, 0, stream>>>(a, w, bias, residual, out, M, N, K, shift, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gemm_int8_fwd(const int8_t* a, const int8_t* w, const int32_t* bias,
                             const int8_t* residual, int8_t* out, int M, int N, int K,
                             int shift, int relu, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || shift < 0 || shift > 31 || (N + BN - 1) / BN > 65535)
    return -1;
  const bool vec_a = K % 16 == 0 && ((uintptr_t)a & 15) == 0;
  const bool vec_w = N % 4 == 0 && ((uintptr_t)w & 3) == 0;
  if (vec_a && vec_w) return launch<true, true>(a, w, bias, residual, out, M, N, K, shift, relu, stream);
  if (vec_a) return launch<true, false>(a, w, bias, residual, out, M, N, K, shift, relu, stream);
  if (vec_w) return launch<false, true>(a, w, bias, residual, out, M, N, K, shift, relu, stream);
  return launch<false, false>(a, w, bias, residual, out, M, N, K, shift, relu, stream);
}
