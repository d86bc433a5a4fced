// INT8 PU GEMM for NVIDIA Hopper (sm_90a), on the int8 tensor cores: two
// kernels for the two layouts of w, and a split-K reduction.
//
// Replaces: src/repro/kernels/gemm_int8/kernel.py:62 gemm_int8_tpu (body
// _gemm_kernel). Same function: out = sat8(relu(((a @ w + bias + r) >> shift)
// + residual)), with a (M, K) int8, w (K, N) int8, bias (N,) int32, residual
// (M, N) int8 or null, int32 accumulation, r = 2^(shift-1) for shift > 0
// (round half up) and 0 for shift == 0, an arithmetic right shift, the
// residual added after the shift, ReLU optional, and saturation to
// [-128, 127] (never a wrap).
//
// Overflow: |a w| <= 2^14 per term, so |acc| <= 2^14 K, 7.5e7 at
// ResNet-50's largest K (4608), far inside int32. The accumulator is not
// widened: the MMA's s32 accumulation (no .satfinite) wraps modulo 2^32 as
// JAX's int32 jnp.dot does, and every add of the epilogue and of the split-K
// reduction is done on uint32 so that it wraps the same way instead of being
// undefined (all -128 at K = 2^17 sums to 2^31 and gives -2^31, out -128).
//
// Bound on the card: at ResNet-50's most frequent GEMM (layer3's 3x3 conv at
// batch 16: M = 4096, N = 256, K = 2304) the work is 4.83 G int8 operations,
// 2.44 us at 1979 TOPS, and the kernel must read a (9.44 MB) and w (0.59 MB)
// and write the output (1.05 MB), 3.31 us at 3.35 TB/s: bound by bytes, and
// at the scale of a launch. Both kernels run mma.sync.m16n8k32 s8 (wgmma and
// TMA are later work); the operands want four consecutive K bytes in each
// 32-bit register, for a along its rows and for w along its columns.
//
// gemm_int8_fwd: w row-major (N contiguous, as in JAX). One block of 256
// threads owns a 128 x 64 output tile and loops over K itself in steps of
// 64, the accumulator in registers: 8 warps as 4 (M) x 2 (N), each warp a
// 32 x 32 sub-tile of 2 x 4 products. The a tile is staged in shared memory
// as it is (row-major, K contiguous) and the w tile transposed on its way
// in: each thread loads a 4 (K) x 4 (N) byte block, transposes it in
// registers with byte permutes, and stores four words, one per column.
// Shared rows are 80 bytes (64 + 16 of padding), so fragment reads and the
// transposed stores are free of bank conflicts. The next K tile is loaded
// into registers while the current one is multiplied. Ragged edges: bytes
// past M, N or K load as zero, the way the Pallas kernel masks its last K
// block, so they add nothing; 16-byte loads of a where K % 16 == 0 and a is
// 16-byte aligned, 4-byte loads of w where N % 4 == 0 and w is 4-byte
// aligned, byte loads otherwise (K = 147 at ResNet-50's conv1). A K step of
// 32 that lies wholly past K is skipped. The epilogue is fused.
//
// gemm_int8_kmajor_fwd: w column-major (K contiguous: the (N, K) bytes of
// w^T), the layout in which a PU's weights are loaded once. The row-major
// kernel above keeps one K tile in flight and pays two barriers and a
// transpose a tile; at ResNet-50's shapes it waits on loads and launches,
// not on the tensor cores. Here:
// - Both operands are K-major, so both tiles go to shared memory as they
//   are: cp.async.cg 16-byte copies into a ring of STAGES = 4 K tiles of
//   BK = 64 bytes, commit_group / wait_group, one barrier a tile; three
//   tiles are in flight while one is multiplied. Rows are 80 bytes (16 of
//   padding), free of bank conflicts for ldmatrix. cp.async with a source
//   size of 0 zero-fills rows past M or N and 16-byte chunks past K, so a
//   K step of 32 past K multiplies zeros.
// - Fragments by ldmatrix.x4: for K-major s8 an 8 x 8 b16 matrix is 8 rows
//   of 16 K bytes, and thread l receives bytes 4 (l % 4) .. +3 of row l / 4,
//   which is exactly m16n8k32's A and B fragment layout. No byte permutes.
//   Fragments are double-buffered across K steps and tiles.
// - The block tile is 128 x 128 (8 warps of 64 x 32) where such tiles give
//   at least 7/8 of the SMs a block, else 128 x 64 (8 warps of 32 x 32):
//   the host's block_n.
// - Ragged or unaligned K (K % 16 != 0, or a or w not 16-byte aligned:
//   conv1's K = 147) cannot use 16-byte cp.async: the VEC = false
//   instantiation gathers the tile after next into registers (aligned
//   4-byte loads and funnel shifts) while the current one is multiplied and
//   stores it after, into the same ring; bit-equal, since the bytes are the
//   same.
// - The epilogue is staged through shared memory as int32, so that rows
//   reach global memory whole (4-byte stores of out and loads of the
//   residual) and so that split K can sum the staged tiles. A residual
//   tile is copied into shared memory with the first K tile.
// - Split K for grids that leave the card empty (ResNet-50 at batch 1: 8 to
//   16 blocks on 132 SMs for its long-K GEMMs): the host plans S <= 8 slices
//   (repro_torch/kernels/gemm_int8/kernel.py, split_k), gridDim.z = S, slice
//   z takes K tiles [T z / S, T (z + 1) / S) of the T = ceil(K / BK). The S
//   blocks of an output tile form one thread-block cluster (1, 1, S): each
//   stages its int32 partial tile in its own shared memory, and after a
//   cluster barrier block z sums every S-th 4-column group of the tile over
//   the S blocks' shared memory (distributed shared memory, uint32 adds) and
//   applies the epilogue. No workspace, no second kernel. The
//   result is bit-equal to the unsplit sum whatever the order: int32
//   addition modulo 2^32 is the addition of the ring Z / 2^32, which is
//   associative and commutative, and the MMA's own s32 accumulation is that
//   addition too, so every grouping of the same K terms gives the same
//   residue (tests/test_torch_gemm_int8.py holds an emulation of the slices
//   to the reference, the wrap case included).
// - Programmatic dependent launch on short one-wave grids (PDL below): a
//   GEMM's launch overlaps the previous GEMM's epilogue.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success) or -1 for arguments out of range.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cooperative_groups.h>

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

// The PU epilogue of one int32 accumulator: + bias, the round-half-up
// arithmetic shift (half = 2^(shift-1), or 0 at shift 0), + the residual,
// ReLU, saturation to int8.
__device__ __forceinline__ int8_t finish(int32_t acc, int32_t bias, int32_t half, int shift,
                                         int32_t res, int relu) {
  int32_t v = wrap_add(acc, bias);
  v = wrap_add(v, half) >> shift;  // arithmetic on int32_t
  v = wrap_add(v, res);            // the residual, 0 where there is none
  if (relu) v = max(v, 0);
  return (int8_t)min(max(v, -128), 127);
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
        const size_t o = (size_t)gm * N + gn;
        out[o] = finish(acc[mi][ni][e], bias[gn], half, shift,
                        residual != nullptr ? residual[o] : 0, relu);
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

// ------------------------------------------------ w column-major (K-major) --
namespace kmajor {

namespace cg = cooperative_groups;

constexpr int BM = 128;          // output rows (M) a block
constexpr int BK = 64;           // K bytes a tile
constexpr int STAGES = 4;        // K tiles in the ring
constexpr int LDS = BK + 16;     // bytes a shared row: 16-byte aligned, conflict-free
constexpr int CHUNKS = BK / 16;  // 16-byte chunks a row of a tile
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SPLITS = 8;    // the portable cluster size
constexpr int WM_N64 = 32;       // warp rows of the 128 x 64 block: 32 (8 warps) or 64 (4)
constexpr int WM_N128 = 64;      // warp rows of the 128 x 128 block: 64 (8 warps) or 32 (16)
// Programmatic dependent launch: in a grid of one wave (blocks x S <= SMs)
// each block lets the next kernel on the stream be scheduled while it
// finishes (griddepcontrol.launch_dependents after its main loop), and every
// block waits for the kernel before it to complete and flush
// (griddepcontrol.wait) before it touches global memory, so that a GEMM's
// launch and set-up overlap the previous GEMM's epilogue. Launches ask for
// it only where their grid is one wave of short blocks (at most
// PDL_MAX_TILES K tiles each): the latency-bound GEMMs of ResNet-50 at
// batch 1. On the card it cost time elsewhere: blocks let in early pile up
// on the SMs that free first. Both instructions are no-ops in a launch
// without the attribute.
constexpr bool PDL = true;
constexpr int PDL_MAX_TILES = 12;

// A block tile of BM x BN outputs, warps of WM x 32 (MT = WM / 16 products
// down, 4 across).
template <int BN, int WM>
struct Tile {
  static constexpr int MT = WM / 16;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / 32;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int A_ITERS = BM * CHUNKS / THREADS;  // 16-byte chunks a thread a tile
  static constexpr int B_ITERS = BN * CHUNKS / THREADS;
  static constexpr int STAGE_BYTES = (BM + BN) * LDS;
  static constexpr int LDC = BN + 8;  // int32 a row of the staged epilogue tile
  static constexpr int RES = std::max(STAGES * STAGE_BYTES, BM * LDC * 4);  // residual tile
  static constexpr int SMEM = RES + BM * BN;
  // blocks an SM that the register file must hold: at most 128 registers a
  // thread (up to 64 accumulators, 24 fragment registers and addresses)
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes of a row of K bytes from byte k on, zero past K, for the VEC =
// false instantiation: aligned 4-byte loads of the words that hold a byte of
// the row (an aligned word never crosses a page, so the bytes it holds
// outside the row are readable) and funnel shifts, at any alignment and K.
__device__ __forceinline__ uint4 gather16(const int8_t* __restrict__ row, int k, int K) {
  if (k >= K) return make_uint4(0u, 0u, 0u, 0u);
  const uintptr_t p = (uintptr_t)(row + k), end = (uintptr_t)(row + K);
  const uint32_t* wd = reinterpret_cast<const uint32_t*>(p & ~(uintptr_t)3);
  const int sh = 8 * (int)(p & 3);
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = (uintptr_t)(wd + i) < end ? __ldg(wd + i) : 0u;
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __funnelshift_r(x[j], x[j + 1], sh);
    const int nb = K - k - 4 * j;  // bytes of word j inside the row
    if (nb <= 0)
      v[j] = 0u;
    else if (nb < 4)
      v[j] &= (1u << (8 * nb)) - 1u;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// a (M, K) row-major, wt = w^T (N, K) row-major. With gridDim.z = S > 1 the
// grid is launched in clusters of (1, 1, S) blocks, one cluster a tile.
template <int BN, int WM, bool VEC>
__global__ void __launch_bounds__(Tile<BN, WM>::THREADS, Tile<BN, WM>::MIN_BLOCKS)
gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
            const int32_t* __restrict__ bias, const int8_t* __restrict__ residual,
            int8_t* __restrict__ out, int M, int N, int K, int shift, int relu,
            int one_wave, int res_smem) {
  using T = Tile<BN, WM>;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this block's K slice: whole tiles [t0, t0 + nt) of the ceil(K / BK)
  const int tiles = (K + BK - 1) / BK;
  const int t0 = (int)((long long)tiles * blockIdx.z / gridDim.z);
  const int nt = (int)((long long)tiles * (blockIdx.z + 1) / gridDim.z) - t0;

  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // With res_smem (a residual whose rows are 16-byte aligned, S = 1: the
  // host decides) the residual tile is copied into shared memory with the
  // first K tile, so that the epilogue finds it there; else the epilogue
  // loads it itself.
  if (res_smem) {
    constexpr int RCHUNKS = BN / 16;  // 16-byte chunks a row of the residual tile
#pragma unroll
    for (int i = 0; i < BM * RCHUNKS / T::THREADS; ++i) {
      const int c = tid + i * T::THREADS, r = c / RCHUNKS, q = c % RCHUNKS;
      const int gm = m0 + r, gn = n0 + 16 * q;
      const bool ok = gm < M && gn < N;
      cp_async16(base + T::RES + r * BN + 16 * q, ok ? residual + (size_t)gm * N + gn : residual,
                 ok);
    }
    cp_async_commit();  // waited for with the first K tile's group, or below
  }
  // chunk c of a tile is row c / CHUNKS, bytes 16 (c % CHUNKS) .. +15; this
  // thread's chunks are the same in every tile (a row past M or N, or a
  // chunk past K, copies nothing)
  const int q16 = 16 * (tid % CHUNKS);  // THREADS is a multiple of CHUNKS
  const int8_t* ga[T::A_ITERS];
  const int8_t* gb[T::B_ITERS];
  bool va[T::A_ITERS], vb[T::B_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int gm = m0 + (tid + i * T::THREADS) / CHUNKS;
    va[i] = gm < M;
    ga[i] = a + (size_t)gm * K + q16;
  }
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int gn = n0 + (tid + i * T::THREADS) / CHUNKS;
    vb[i] = gn < N;
    gb[i] = wt + (size_t)gn * K + q16;
  }
  const uint32_t s_off = (tid / CHUNKS) * LDS + q16;  // + (THREADS / CHUNKS) LDS an iteration
  auto copy_tile = [&](int stage, int kt) {  // cp.async of tile kt into stage
    const uint32_t sa = base + stage * T::STAGE_BYTES + s_off, sb = sa + BM * LDS;
    const int k0 = kt * BK;
    const bool in_k = k0 + q16 < K;
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i)
      cp_async16(sa + i * (T::THREADS / CHUNKS) * LDS, va[i] && in_k ? ga[i] + k0 : a,
                 va[i] && in_k);
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i)
      cp_async16(sb + i * (T::THREADS / CHUNKS) * LDS, vb[i] && in_k ? gb[i] + k0 : wt,
                 vb[i] && in_k);
  };
  // the VEC = false staging registers: one tile's chunks of a and w
  constexpr int GA = VEC ? 1 : T::A_ITERS, GB = VEC ? 1 : T::B_ITERS;
  auto gather = [&](int kt, uint4 (&ra)[GA], uint4 (&rb)[GB]) {  // tile kt by word loads
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (VEC ? 0 : GA); ++i) {
      const int c = tid + i * T::THREADS, r = c / CHUNKS, q = c % CHUNKS;
      const int gm = m0 + r;
      ra[i] = gm < M ? gather16(a + (size_t)gm * K, k0 + 16 * q, K) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < (VEC ? 0 : GB); ++i) {
      const int c = tid + i * T::THREADS, r = c / CHUNKS, q = c % CHUNKS;
      const int gn = n0 + r;
      rb[i] = gn < N ? gather16(wt + (size_t)gn * K, k0 + 16 * q, K) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto put = [&](int stage, const uint4 (&ra)[GA], const uint4 (&rb)[GB]) {  // into stage
    uint8_t* sa = smem + stage * T::STAGE_BYTES;
    uint8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int i = 0; i < (VEC ? 0 : GA); ++i) {
      const int c = tid + i * T::THREADS;
      *reinterpret_cast<uint4*>(sa + (c / CHUNKS) * LDS + 16 * (c % CHUNKS)) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < (VEC ? 0 : GB); ++i) {
      const int c = tid + i * T::THREADS;
      *reinterpret_cast<uint4*>(sb + (c / CHUNKS) * LDS + 16 * (c % CHUNKS)) = rb[i];
    }
  };

  int acc[T::MT][4][4];
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // ldmatrix addresses of this lane, in bytes from a stage's a and w tiles.
  // A (x4 = a0..a3): lanes 0-15 rows 0-15 at K byte 0, lanes 16-31 rows 0-15
  // at K byte 16. B (x4 = b0, b1 of two 8-column blocks): lanes 0-7 columns
  // 0-7 at 0, 8-15 columns 0-7 at 16, 16-23 columns 8-15 at 0, 24-31
  // columns 8-15 at 16.
  const uint32_t a_off = (wm * WM + (lane & 15)) * LDS + (lane >> 4) * 16;
  const uint32_t b_off = (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 16;

  // prologue: tiles 0 .. STAGES - 2 of the slice (VEC = false: every
  // tile's loads started before the first store, so that they overlap)
  if (VEC) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nt) copy_tile(s, t0 + s);
      cp_async_commit();
    }
  } else {
    uint4 pa[STAGES - 1][GA], pb[STAGES - 1][GB];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < nt) gather(t0 + s, pa[s], pb[s]);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < nt) put(s, pa[s], pb[s]);
  }
  uint4 ra[GA], rb[GB];  // the tile after next, VEC = false

  // Fragments are double-buffered: each K step of 32 loads the next step's
  // (the next tile's first, after the tile barrier, at a tile's last step)
  // before it multiplies its own, so that ldmatrix overlaps the MMAs. A
  // K step of 32 wholly past K multiplies the zeros copied there.
  constexpr int KS = BK / 32;
  auto load_frags = [&](int stage, int ks, uint32_t (&fa)[T::MT][4], uint32_t (&fb)[4][2]) {
    const uint32_t sa = base + stage * T::STAGE_BYTES, sb = sa + BM * LDS;
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi) ldsm_x4(fa[mi], sa + a_off + mi * 16 * LDS + 32 * ks);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      ldsm_x4(r, sb + b_off + nj * 16 * LDS + 32 * ks);
      fb[2 * nj][0] = r[0];
      fb[2 * nj][1] = r[1];
      fb[2 * nj + 1][0] = r[2];
      fb[2 * nj + 1][1] = r[3];
    }
  };
  uint32_t af[2][T::MT][4], bf[2][4][2];
  if (VEC) cp_async_wait<STAGES - 2>();  // tile 0 has landed (this thread's copies)
  __syncthreads();                        // ... every thread's
  load_frags(0, 0, af[0], bf[0]);
  for (int i = 0; i < nt; ++i) {
    const int next = i + STAGES - 1;  // goes into tile i - 1's stage, free since the
                                      // barrier that ended tile i - 1
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks == 0) {
        if (VEC) {
          if (next < nt) copy_tile(next % STAGES, t0 + next);
          cp_async_commit();  // possibly empty: keeps one group a tile
        } else if (next < nt) {
          gather(t0 + next, ra, rb);  // in flight while tile i is multiplied
        }
      }
      if (ks == KS - 1) {
        if (!VEC && next < nt) put(next % STAGES, ra, rb);
        if (VEC) cp_async_wait<STAGES - 2>();  // tile i + 1 has landed
        __syncthreads();  // ... and every warp has its last fragments of tile i
      }
      // (past the last tile this reads a stage that is not used: harmless)
      load_frags(ks == KS - 1 ? (i + 1) % STAGES : i % STAGES, (ks + 1) % KS, af[(ks + 1) % 2],
                 bf[(ks + 1) % 2]);
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[ks % 2][mi], bf[ks % 2][ni]);
    }
  }

  cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();                // every warp is done with the ring
  if (PDL && one_wave) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Epilogue through shared memory, so that global memory sees whole rows:
  // each warp stages its accumulators as int32 (accumulator e of (mi, ni) is
  // row g (+8 for e >= 2), columns 2t + (e & 1) of that 16 x 8 product; row
  // stride BN + 8 words keeps the 8-byte stores free of bank conflicts),
  // then each thread takes 4 consecutive columns of a row at a time (split
  // K: summed over the cluster's S staged tiles) and applies the fused
  // epilogue with 4-byte loads of the residual and 4-byte stores of out.
  constexpr int LDC = T::LDC;
  int32_t* cs = reinterpret_cast<int32_t*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * WM + mi * 16 + g + 8 * h, c = wn * 32 + ni * 8 + 2 * t;
          *reinterpret_cast<int2*>(cs + r * LDC + c) =
              make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
  }
  __syncthreads();

  const int32_t half = shift > 0 ? (int32_t)(1u << (shift - 1)) : 0;
  // 4-byte accesses of out and the residual where every row of N starts
  // aligned; uniform over the block
  const bool vec4 = N % 4 == 0 && ((uintptr_t)out & 3) == 0 &&
                    ((uintptr_t)residual & 3) == 0;
  // THREADS is a multiple of the 4-column groups a row, so a thread keeps
  // one group (and its 4 biases) over every row it finishes
  constexpr int QUADS = BN / 4;
  const int col = 4 * (tid % QUADS), gn = n0 + col;
  int32_t bias4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bias4[j] = gn + j < N ? bias[gn + j] : 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z;
  if (S > 1) cluster.sync();  // every slice's partial tile is staged
  // with S > 1 this block finishes every S-th group of the tile; the
  // residuals of 4 groups are loaded first, so that their loads are in
  // flight together
  constexpr int ITERS = BM * QUADS / T::THREADS;  // groups a thread at S = 1
  const int first = (S > 1 ? (int)cluster.block_rank() * T::THREADS : 0) + tid;
  const int step = S * T::THREADS;
#pragma unroll 1
  for (int i0 = 0; i0 < ITERS && first + i0 * step < BM * QUADS; i0 += 4) {
    uint32_t res4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = first + (i0 + i) * step, r = c / QUADS, gm = m0 + r;
      if (res_smem)
        res4[i] = *reinterpret_cast<const uint32_t*>(smem + T::RES + r * BN + col);
      else
        res4[i] = vec4 && residual != nullptr && c < BM * QUADS && gm < M && gn < N
                      ? *reinterpret_cast<const uint32_t*>(residual + (size_t)gm * N + gn)
                      : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = first + (i0 + i) * step;
      const int r = c / QUADS, gm = m0 + r;
      if (c >= BM * QUADS || gm >= M || gn >= N) continue;
      const int off = r * LDC + col;
      int4 v = *reinterpret_cast<const int4*>(cs + off);
      if (S > 1) {
        int4 p[MAX_SPLITS];  // every slice's load in flight at once
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
          if (q < S) p[q] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(cs + off, q));
        uint32_t sum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
          if (q < S) {
            sum[0] += (uint32_t)p[q].x;
            sum[1] += (uint32_t)p[q].y;
            sum[2] += (uint32_t)p[q].z;
            sum[3] += (uint32_t)p[q].w;
          }
        v = make_int4((int32_t)sum[0], (int32_t)sum[1], (int32_t)sum[2], (int32_t)sum[3]);
      }
      const int32_t vals[4] = {v.x, v.y, v.z, v.w};
      const size_t o = (size_t)gm * N + gn;
      if (vec4) {  // N % 4 == 0, so gn + 4 <= N
        uint32_t packed = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int32_t rj = (int32_t)(int8_t)(res4[i] >> (8 * j));
          packed |= (uint32_t)(uint8_t)finish(vals[j], bias4[j], half, shift, rj, relu)
                    << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(out + o) = packed;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N)
            out[o + j] = finish(vals[j], bias4[j], half, shift,
                                residual != nullptr ? residual[o + j] : 0, relu);
      }
    }
  }
  if (S > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

template <int BN, int WM, bool VEC>
int launch(const int8_t* a, const int8_t* wt, const int32_t* bias, const int8_t* residual,
           int8_t* out, int M, int N, int K, int splits, int shift, int relu,
           cudaStream_t stream) {
  using T = Tile<BN, WM>;
  // Above 48 KB a launch is refused unless the kernel opts in; the opt-in
  // holds per device, so it is made once per device and instantiation (two
  // threads racing here both set the same value)
  static bool opted_in[MAX_DEVICES] = {};
  static int sm_count[MAX_DEVICES] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(gemm_kernel<BN, WM, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) {
      sm_count[dev] = sms;
      opted_in[dev] = true;
    }
  } else {
    sms = sm_count[dev];
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  cfg.blockDim = dim3(T::THREADS);
  const int res_smem = residual != nullptr && splits == 1 && N % 16 == 0 &&
                       ((uintptr_t)residual & 15) == 0;
  cfg.dynamicSmemBytes = res_smem ? T::SMEM : T::RES;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  int n_attrs = 0;
  const dim3& g = cfg.gridDim;
  const int one_wave = (long long)g.x * g.y * g.z <= sms;
  const int tiles_per_block = ((K + BK - 1) / BK + splits - 1) / splits;
  if (PDL && one_wave && tiles_per_block <= PDL_MAX_TILES) {
    attrs[n_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n_attrs++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (splits > 1) {  // the S slices of a tile, one cluster
    attrs[n_attrs].id = cudaLaunchAttributeClusterDimension;
    attrs[n_attrs].val.clusterDim.x = 1;
    attrs[n_attrs].val.clusterDim.y = 1;
    attrs[n_attrs++].val.clusterDim.z = splits;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n_attrs;
  return cudaLaunchKernelEx(&cfg, gemm_kernel<BN, WM, VEC>, a, wt, bias, residual, out, M, N, K,
                            shift, relu, one_wave, res_smem);
}

}  // namespace kmajor

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

// The column-major launch at block_n (64 or 128): out[0] threads a block,
// out[1] warp rows, out[2] ring stages, out[3] dynamic shared memory bytes
// with the residual staged in shared memory, out[4] without it. Touches no
// device.
extern "C" int gemm_int8_kmajor_plan(int block_n, int* out) {
  auto fill = [&](auto tile, int wm) {
    using T = decltype(tile);
    out[0] = T::THREADS;
    out[1] = wm;
    out[2] = kmajor::STAGES;
    out[3] = T::SMEM;
    out[4] = T::RES;
    return 0;
  };
  if (block_n == 128) return fill(kmajor::Tile<128, kmajor::WM_N128>{}, kmajor::WM_N128);
  if (block_n == 64) return fill(kmajor::Tile<64, kmajor::WM_N64>{}, kmajor::WM_N64);
  return -1;
}

// w column-major: wt points at w^T, (N, K) row-major. block_n is 64 or 128;
// 1 <= splits <= 8 slices K into whole 64-byte tiles, at most one a tile.
extern "C" int gemm_int8_kmajor_fwd(const int8_t* a, const int8_t* wt, const int32_t* bias,
                                    const int8_t* residual, int8_t* out, int M, int N, int K,
                                    int block_n, int splits, int shift, int relu,
                                    cudaStream_t stream) {
  const int tiles = (K + kmajor::BK - 1) / kmajor::BK;
  if (M <= 0 || N <= 0 || K <= 0 || shift < 0 || shift > 31 || splits < 1 || splits > tiles ||
      splits > kmajor::MAX_SPLITS || (block_n != 64 && block_n != 128) ||
      (N + block_n - 1) / block_n > 65535)
    return -1;
  const bool vec = K % 16 == 0 && ((uintptr_t)a & 15) == 0 && ((uintptr_t)wt & 15) == 0;
  auto run = [&](auto fn) {
    return fn(a, wt, bias, residual, out, M, N, K, splits, shift, relu, stream);
  };
  if (block_n == 128)
    return vec ? run(kmajor::launch<128, kmajor::WM_N128, true>)
               : run(kmajor::launch<128, kmajor::WM_N128, false>);
  return vec ? run(kmajor::launch<64, kmajor::WM_N64, true>)
             : run(kmajor::launch<64, kmajor::WM_N64, false>);
}
