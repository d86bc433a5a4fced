// fp32 GEMM y = x @ w for NVIDIA Hopper (sm_90a): fp32-accurate products on
// the TF32 tensor cores (3xTF32) through wgmma, fed by a TMA ring.
//
// Replaces no TPU kernel: the JAX package leaves its dense products to XLA,
// and the port sent them to cuBLAS in fp32 with TF32 off, which runs them on
// the CUDA cores. This kernel exists because those products are most of a
// prefill's time (h2o-danube-3-4b's pipeline, PERF.md section 5).
//
// Bound on the card. At the pipeline's MLP shapes (M = 4608 rows, K x N of
// 3840 x 10240 and 10240 x 3840) a product is 2MNK = 362.4 GFLOP against
// ~0.4 GB of x, w and y: bound by operations, ~100x past the card's ratio.
// On the fp32 CUDA cores (67 TFLOP/s) that is 5.41 ms; the TF32 tensor
// cores (495 TFLOP/s) would take 0.73 ms, but one TF32 product keeps 10
// bits of mantissa, ~1000x fp32's error. So each operand is split,
// v = big + small with big = v rounded to TF32 and small the remainder, and
// a.b = a_small.b_big + a_big.b_small + a_big.b_big, each term on the
// tensor cores (a_small.b_small, ~2^-22 of a.b, is dropped): three
// products, a bound of 3 x 0.73 = 2.20 ms (165 TFLOP/s of fp32 work).
//
// What the design does about it:
// - wgmma reads a TF32 operand from shared memory only K-major, and w is
//   stored (K, N) with N contiguous. So each tile is computed transposed,
//   y^T = w^T x^T: w^T is wgmma's A, read into registers from the N-major
//   tile TMA landed and split there (64 rows a consumer warpgroup, 4 values
//   a thread a k step of 8); x^T is B, K-major as x is stored.
// - B's split is made once a stage, in shared memory, by the producer
//   warpgroup: big overwrites the tile in place, small goes to a second
//   buffer, and the consumers' wgmmas read both by descriptor. big is rounded on
//   the integer pipe (add half an ulp, mask: cvt.rna for finite values);
//   small enters unrounded, and the tensor cores read a TF32 operand's top
//   19 bits, so small enters truncated (as the flash kernel does).
// - The tensor cores add to their fp32 accumulators with truncation, not to
//   nearest: over K = 3840 (1440 adds) one accumulator drifts to ~40x fp32's
//   error, linear in K (measured on the H100; ref.py models it). So each
//   32-k stage is summed into a fresh accumulator (12 wgmmas) and then
//   added, rounded to nearest, to the tile's sum on the CUDA cores: the
//   drift of 12 adds to a partial of random sign, as fp32's error.
// - Warp specialisation: a producer warpgroup (one warp's lane 0 issues the
//   loads, its other three warps split, so that a refill never waits on a
//   split) keeps a ring of STAGES stages of 32 k (x: BM rows of 128 B; w: 4
//   boxes of 32 k x 32 n; both under TMA's 128-byte swizzle, which the wgmma
//   descriptor and the A loads follow) behind mbarriers (full: landed;
//   ready: split; empty: both consumers done); two consumer
//   warpgroups of 64 rows of y^T each run 3 wgmma m64nBMk8 a k step, one
//   group in flight while the next step's A is loaded and split.
//   setmaxnreg moves registers from the producers (40 a thread) to the
//   consumers (232), which hold the partial, the sum (96 each) and two
//   sets of A.
// - A persistent grid: one block an SM walks the output tiles (m fastest),
//   so one tile's epilogue overlaps the next tile's loads. The epilogue
//   writes y from the sums: a warp's store covers 4 rows of y x 8
//   consecutive columns, 32-byte sectors filled whole.
// - Ragged M, N and K: TMA fills rows, columns and k past the edge with
//   zeros (which add nothing), and the epilogue stores only inside y.
//
// The tile: 128 columns of y (two warpgroups of 64) by 192 rows, wgmma's
// m64n192k8, in a ring of 3 stages of 64 KB. On the H100 (700 W) it reached
// 109-115 TFLOP/s of fp32 work at the pipeline's shapes, 85 at N = 960,
// where 24 x 8 tiles on 132 SMs leave the second wave half idle and the
// last column of tiles half empty.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success), -2 for strides or a pointer TMA cannot take (x, w rows 16-byte
// aligned), -3 if the driver has no cuTensorMapEncodeTiled, and -100 - r
// for a CUresult r of the encoder.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;        // k a stage: one 128-byte swizzle row of fp32
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
constexpr int SPLITTERS = 96;  // the producer warpgroup less its load warp
constexpr int BN = CONSUMERS * 64;  // columns of y a tile (rows of y^T)
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int BOX = 32 * BK * 4;    // one w box: 32 k x 32 n
constexpr int W_BYTES = BN * BK * 4;
constexpr int MAX_DEVICES = 64;

constexpr int BM = 192;       // rows of y a tile (wgmma's N)
constexpr int ACC = BM / 2;   // a thread's share of a 64 x BM accumulator
constexpr int X_BYTES = BM * BK * 4;
constexpr int STAGE_BYTES = 2 * X_BYTES + W_BYTES;  // x (big), x small, w
constexpr int STAGES = (SMEM_LIMIT - 1024 - 256) / STAGE_BYTES;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
static_assert(STAGES >= 2, "a ring needs two stages");
static_assert(BM % 32 == 0 && BM <= 256, "wgmma's N, whole 8-row swizzle atoms");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v = big + small to fp32 accuracy: big is v rounded to TF32, to nearest
// with ties away from zero (cvt.rna.tf32.f32 for finite v) on the integer
// pipe; small = v - big, exact in fp32, read by the tensor cores truncated.
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
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

// a 2-D box of the tensor map at (c0 innermost, c1) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
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

// d (64 x 192, fp32, 96 a thread) += a (64 x 8, tf32 in registers) b (8 x 192, tf32 by descriptor)
__device__ __forceinline__ void wgmma_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// y (M, N) row-major, its row stride N; the maps: x (M, K) in boxes of
// 32 k x BM rows, w (K, N) in boxes of 32 n x 32 k, both 128-byte swizzled
__global__ void __launch_bounds__(THREADS, 1)
    gemm_f32_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                    float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle's atoms start 1024-aligned in the shared window
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SPLITTERS);      // every split thread
      mbar_init(&empty[s], CONSUMERS * 4);  // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int kbs = (K + BK - 1) / BK;
  // this block's tiles are blockIdx.x, + gridDim.x, ...; stage i is k block
  // i % kbs of its (i / kbs)-th tile, in ring slot i % STAGES
  const int total = ((tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1) * kbs;

  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == CONSUMERS * 4) {
      // the load warp: its lane 0 keeps the ring full
      if (lane == 0) {
        for (int i = 0; i < total; ++i) {
          const int s = i % STAGES, tile = blockIdx.x + (i / kbs) * gridDim.x, kb = i % kbs;
          const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
          mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes
          const uint32_t st = smem_u32(smem + s * STAGE_BYTES);
          mbar_expect_tx(&full[s], X_BYTES + W_BYTES);
          tma_load(st, &tmx, kb * BK, m0, &full[s]);
#pragma unroll
          for (int j = 0; j < BN / 32; ++j)
            tma_load(st + 2 * X_BYTES + j * BOX, &tmw, n0 + 32 * j, kb * BK, &full[s]);
        }
      }
    } else {
      // the split warps: x's tile into big (in place) and small as it lands
      const int p = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
      for (int i = 0; i < total; ++i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        float4* xb = reinterpret_cast<float4*>(smem + s * STAGE_BYTES);
        float4* xs = xb + X_BYTES / 16;
#pragma unroll 4
        for (int j = p; j < X_BYTES / 16; j += SPLITTERS) {
          const float4 v = xb[j];
          uint4 b, sm;
          split(v.x, b.x, sm.x);
          split(v.y, b.y, sm.y);
          split(v.z, b.z, sm.z);
          split(v.w, b.w, sm.w);
          xb[j] = *reinterpret_cast<const float4*>(&b);
          xs[j] = *reinterpret_cast<const float4*>(&sm);
        }
        // the generic writes, visible to wgmma's async reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp / 4, wiw = warp % 4, g = lane / 4, t = lane % 4;
    // where this thread's A values lie in a stage (k step 0): rows n of y^T
    // at g and g + 8, k at t and t + 4, in w's boxes under the swizzle
    uint32_t aoff[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = wg * 64 + wiw * 16 + g + 8 * (q & 1);
      const int k = t + 4 * (q >> 1);
      aoff[q] = 2 * X_BYTES + (n / 32) * BOX + k * 128 + ((((n % 32) / 4) ^ k) * 16) +
                (n % 4) * 4;
    }
    float acc[ACC], part[ACC];
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = part[j] = 0.f;
    uint32_t big[2][4], small[2][4];
    for (int i = 0; i < total; ++i) {
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      mbar_wait(&full[s], phase);
      mbar_wait(&ready[s], phase);
      const uint8_t* st = smem + s * STAGE_BYTES;
      const uint32_t sx = smem_u32(st), sxs = sx + X_BYTES;
#pragma unroll
      for (int k8 = 0; k8 < BK / 8; ++k8) {
        const int h = k8 & 1;  // this step's A registers; the other set may be in flight
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(*reinterpret_cast<const float*>(st + aoff[q] + k8 * 1024), big[h][q], small[h][q]);
        wgmma_fence();
        const uint64_t dx = desc_sw128(sx + k8 * 32), dxs = desc_sw128(sxs + k8 * 32);
        wgmma_n192(part, small[h], dx, k8 != 0);  // a stage's first step starts afresh
        wgmma_n192(part, big[h], dxs, 1);
        wgmma_n192(part, big[h], dx, 1);
        wgmma_commit();
        if (k8 < BK / 8 - 1) {
          wgmma_wait<1>();  // the step before is done: its A registers are free
          hold(big[h ^ 1]);
          hold(small[h ^ 1]);
        }
      }
      wgmma_wait<0>();
      hold(part);
      hold(big[1]);
      hold(small[1]);
      if (lane == 0) mbar_arrive(&empty[s]);
      // the stage's partial into the tile's sum, rounded to nearest
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] += part[j];
      if (i % kbs == kbs - 1) {
        // acc[j] is y^T's (row, col) = y (m0 + col, n0 + row)
        const int tile = blockIdx.x + (i / kbs) * gridDim.x;
        const int m0 = (tile % m_tiles) * BM;
        const int n = (tile / m_tiles) * BN + wg * 64 + wiw * 16 + g;
#pragma unroll
        for (int j = 0; j < ACC; ++j) {
          const int nn = n + 8 * ((j >> 1) & 1);
          const int m = m0 + (j >> 2) * 8 + 2 * t + (j & 1);
          if (m < M && nn < N) y[static_cast<size_t>(m) * N + nn] = acc[j];
          acc[j] = 0.f;
        }
      }
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

// a row-major (rows, cols) fp32 matrix of row stride ld, in boxes of
// (box_cols, box_rows) under the 128-byte swizzle; zeros past its edges
int encode(CUtensorMap* map, const float* p, int rows, int cols, long long ld, int box_cols,
           int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -3;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -100 - static_cast<int>(r);
}

int launch(const float* x, const float* w, float* y, int M, int N, int K, long long ldx,
           long long ldw, cudaStream_t stream) {
  // Above 48 KB a launch is refused unless the kernel opts in, once per
  // device (two threads racing here set the same value).
  static bool opted_in[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  CUtensorMap tmx, tmw;
  int bad = encode(&tmx, x, M, K, ldx, BK, BM);
  if (bad == 0) bad = encode(&tmw, w, K, N, ldw, 32, BK);
  if (bad != 0) return bad;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms[dev] ? tiles : sms[dev];
  gemm_f32_kernel<<<grid, THREADS, SMEM, stream>>>(tmx, tmw, y, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// y (M, N) = x (M, K) @ w (K, N), fp32: x and w row-major with row strides
// ldx and ldw (elements), y contiguous; all on the current device, x and w
// 16-byte aligned with ldx and ldw multiples of 4; stream of that device.
extern "C" int gemm_f32_fwd(const float* x, const float* w, float* y, int M, int N, int K,
                            long long ldx, long long ldw, void* stream) {
  if (M == 0 || N == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 || ldx % 4 ||
      ldw % 4 || K == 0)
    return -2;
  return launch(x, w, y, M, N, K, ldx, ldw, static_cast<cudaStream_t>(stream));
}
