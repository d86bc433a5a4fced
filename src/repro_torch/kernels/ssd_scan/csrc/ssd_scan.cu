// Mamba2 SSD scan for NVIDIA Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py:78 ssd_scan_tpu (body
// _ssd_kernel). Same function: for each (batch, head), with h the (N, P)
// fp32 state starting at zero, a = A[head] < 0 and dt_t > 0,
//   h <- exp(dt_t a) h + dt_t B_t^T x_t,   then   y_t = C_t h,
// in time order; xh is (b, s, H, P), dt (b, s, H), A (H,), B and C (b, s, N)
// shared by the H heads of a batch row. It returns y (b, s, H, P) and the
// final state (b, H, N, P). The TPU kernel computes the same sums in the
// chunked matrix form (C B^T . L . dt) X + exp(cum) C h_in per chunk; the
// two agree to fp32 rounding, and both are held to the sequential
// recurrence.
//
// Bound on the card: at the zamba2-7b serving prefill shape (b=4, s=1024,
// H=112, P=64, N=64) the work is 4 N P operations a step and head (the state
// update decay*h + (dt x) B and the product C h), 7.5 GFLOP, 0.112 ms at the
// 67 TFLOP/s fp32 CUDA-core peak; the bytes are xh and y (117 MB each), dt,
// B and C (6 MB) and the final state (7.3 MB), 0.074 ms at 3.35 TB/s. So it
// is bound by operations on the CUDA cores.
//
// Why not tensor cores: the chunked form at chunk L = 64 does C B^T, W X,
// C h and B^T X, 4 x 4096 multiply-adds a step and head, twice the
// recurrence's 4 N P = 16,384 operations. Held to fp32 (the port's parity
// rule), each product runs as 3xTF32, about 6x the recurrence's fp32 work,
// ~4.5x with the upper triangle of C B^T skipped; mma.sync tf32 reaches
// 323 TFLOP/s on this card, only 4.8x the CUDA cores' 67. So the chunked
// form's floor is at or above the recurrence's; it waits for wgmma.
//
// What the design does about it: the P columns of h are independent (x[:, p]
// feeds only h[:, p] and y[:, p]), so a block owns PC of them and the grid
// is (H, b, P / PC): more than one block a (batch, head). Each column has R
// threads, and thread r of a column keeps the N / R rows of h in the float4
// groups r, r + R, r + 2R, ... in registers for the whole sequence (the R
// threads then read R neighbouring float4s of B and C: no bank conflicts);
// a thread owns CPT neighbouring columns, so each float4 of B and C it reads
// from shared memory serves CPT columns. Steps run in pairs, and the R
// partial sums of the pair's 2 CPT values of y meet in one scatter across
// the R-lane group (__shfl_xor_sync, half the values swapped a round), each
// as the butterfly ((p0 + p1) + (p2 + p3)) over four sums of a thread's
// rows: the order of every sum depends on (PC, R, CPT) alone. Inputs reach
// shared memory through a ring of STAGES tiles of `chunk` steps each (x's
// PC columns, B, C and dt), copied by cp.async (16 bytes where the rows are
// 16-byte aligned, else 4): tiles t + 1 .. t + STAGES - 1 are in flight
// while tile t runs, and one barrier a tile both publishes the tile that
// landed and frees the slot the next copy fills. Each warp turns the tile's
// dt into decays exp(dt a) once (warp-local, no barrier). The tile decides
// only when inputs are staged, so results do not depend on it. The ragged
// last tile is shorter; nothing is padded in device memory. At the prefill
// shape the plan (Python, kernel.plan) is PC 32, R 2, CPT 2, two slots of
// 24 steps: 896 blocks of one warp, 64 registers of h a thread, 31 KB of
// shared memory, seven blocks an SM, one wave. Plans with more warps an SM
// (14-27: R 4 or 8) ran 15-60 % slower on the card (tools/scan_variants.py):
// a thread's reads of B and C and shuffles of y grow against its FMAs
// faster than the extra warps hide latency.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success) or -1 for a plan (N, R, PC, CPT) that is not instantiated or not
// legal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block can have on sm_90
constexpr int STAGES = 2;         // tiles in the ring: the next in flight while one runs

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floats of one ring slot: x (chunk x PC), B and C (chunk x N each), dt
// (chunk, rounded up to whole float4s)
__host__ __device__ inline int slot_floats(int chunk, int PC, int N) {
  return chunk * (PC + 2 * N) + ((chunk + 3) & ~3);
}

// One step of the recurrence on a thread's rows of h (the float4 groups
// q R of B4 and C4) in each of its CPT columns: the state update, and the
// thread's partial sum of y_t of each column in four sums over its rows. B
// and C are read once for the CPT columns.
template <int NQ, int R, int CPT>
__device__ __forceinline__ void ssd_step(float (&h)[CPT][4 * NQ], float decay,
                                         const float (&u)[CPT], const float4* B4,
                                         const float4* C4, float (&yo)[CPT]) {
  float acc[CPT][4];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 bq = B4[q * R], cq = C4[q * R];
    const int n = 4 * q;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      h[c][n] = fmaf(decay, h[c][n], u[c] * bq.x);
      h[c][n + 1] = fmaf(decay, h[c][n + 1], u[c] * bq.y);
      h[c][n + 2] = fmaf(decay, h[c][n + 2], u[c] * bq.z);
      h[c][n + 3] = fmaf(decay, h[c][n + 3], u[c] * bq.w);
      acc[c][0] = fmaf(cq.x, h[c][n], acc[c][0]);
      acc[c][1] = fmaf(cq.y, h[c][n + 1], acc[c][1]);
      acc[c][2] = fmaf(cq.z, h[c][n + 2], acc[c][2]);
      acc[c][3] = fmaf(cq.w, h[c][n + 3], acc[c][3]);
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) yo[c] = (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
}

// The R partial sums of K values (a thread's CPT columns at U steps,
// value u CPT + c) meet across the R-lane group, each as ((p0 + p1) + (p2 +
// p3)) + ..., the order of a butterfly (addition commutes, so every lane
// that ends with a sum has the same bits, whatever K). The first log2 S
// rounds (S = min(R, K)) swap half the values instead of adding both, so
// lane r ends with the sums of values S i + (r mod S), i < K / S, in v[i].
template <int R, int K, unsigned MASK>
__device__ __forceinline__ void scatter_sum(float (&v)[K], int r) {
  constexpr int S = R < K ? R : K;
#pragma unroll
  for (int m = 1, len = K; m < S; m <<= 1, len >>= 1) {
    const bool hi = r & m;
#pragma unroll
    for (int i = 0; i < len / 2; ++i) {
      const float keep = hi ? v[2 * i + 1] : v[2 * i];
      const float send = hi ? v[2 * i] : v[2 * i + 1];
      v[i] = keep + __shfl_xor_sync(MASK, send, m);
    }
  }
#pragma unroll
  for (int m = S; m < R; m <<= 1)
#pragma unroll
    for (int i = 0; i < K / S; ++i) v[i] += __shfl_xor_sync(MASK, v[i], m);
}

// Stores the sums scatter_sum left in this lane: value u CPT + c is y of
// column c at step u (yp at step 0); lanes r >= S hold copies.
template <int R, int K, int CPT>
__device__ __forceinline__ void store_sums(float* yp, int64_t step, const float (&v)[K], int r) {
  constexpr int S = R < K ? R : K;
  if (r < S) {
#pragma unroll
    for (int i = 0; i < K / S; ++i) {
      const int idx = S * i + (r & (S - 1));
      yp[(idx / CPT) * step + idx % CPT] = v[i];
    }
  }
}

template <int N, int R, int PC, int CPT>
__global__ void __launch_bounds__(PC / CPT * R)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ y,
                float* __restrict__ h_out, int s, int H, int P, int chunk, int vec) {
  constexpr int NT = PC / CPT * R;  // threads
  constexpr int NQ = N / (4 * R);   // float4 groups of h a thread and column
  constexpr int WS = NT < 32 ? NT : 32;
  constexpr unsigned WMASK = NT < 32 ? (1u << NT) - 1 : 0xffffffffu;
  static_assert(N % (4 * R) == 0 && PC % 4 == 0 && PC % CPT == 0 && (CPT & (CPT - 1)) == 0 &&
                (NT < 32 || NT % 32 == 0), "plan");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = slot_floats(chunk, PC, N);
  const int tpad = (chunk + 3) & ~3;
  float* sdec = smem + STAGES * slot + (threadIdx.x / 32) * tpad;  // this warp's decays

  const int tid = threadIdx.x;
  const int r = tid % R, pc = tid / R * CPT, lane = tid % 32;  // pc: the first column
  const int hd = blockIdx.x, bi = blockIdx.y, p0 = blockIdx.z * PC;
  const int64_t step = (int64_t)H * P;  // floats between two steps of xh and y
  const float* xb = x + (int64_t)bi * s * step + (int64_t)hd * P + p0;  // (bi, 0, hd, p0)
  float* yb = y + (int64_t)bi * s * step + (int64_t)hd * P + p0 + pc;
  const float* dtb = dt + (int64_t)bi * s * H + hd;  // (bi, 0, hd)
  const float* Bb = B + (int64_t)bi * s * N;         // (bi, 0, 0)
  const float* Cb = C + (int64_t)bi * s * N;
  const float a = A[hd];
  const int tiles = (s + chunk - 1) / chunk;

  // start the copies of one tile into its ring slot (no wait)
  auto load = [&](int tile) {
    float* sx = smem + (tile % STAGES) * slot;
    float* sB = sx + chunk * PC;
    float* sC = sB + chunk * N;
    float* sdt = sC + chunk * N;
    const int t0 = tile * chunk, nt = min(chunk, s - t0);
    const float* Bt = Bb + (int64_t)t0 * N;  // nt * N contiguous floats, as is C's
    const float* Ct = Cb + (int64_t)t0 * N;
    if (vec) {
      constexpr int XV = PC / 4;  // 16-byte pieces of a step's x
      for (int c = tid; c < nt * XV; c += NT) {
        const int tt = c / XV, k = 4 * (c - tt * XV);
        cp_async16(sx + tt * PC + k, xb + (int64_t)(t0 + tt) * step + k);
      }
      for (int c = 4 * tid; c < nt * N; c += 4 * NT) {
        cp_async16(sB + c, Bt + c);
        cp_async16(sC + c, Ct + c);
      }
    } else {
      for (int c = tid; c < nt * PC; c += NT) {
        const int tt = c / PC, k = c - tt * PC;
        cp_async4(sx + tt * PC + k, xb + (int64_t)(t0 + tt) * step + k);
      }
      for (int c = tid; c < nt * N; c += NT) {
        cp_async4(sB + c, Bt + c);
        cp_async4(sC + c, Ct + c);
      }
    }
    for (int c = tid; c < nt; c += NT) cp_async4(sdt + c, dtb + (int64_t)(t0 + c) * H);
  };

  for (int t = 0; t < STAGES - 1; ++t) {  // every thread commits a group a tile, empty or not
    if (t < tiles) load(t);
    cp_async_commit();
  }

  float h[CPT][4 * NQ];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int n = 0; n < 4 * NQ; ++n) h[c][n] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();            // everyone's have; the slot of tile - 1 is free
    if (tile + STAGES - 1 < tiles) load(tile + STAGES - 1);
    cp_async_commit();

    const float* sx = smem + (tile % STAGES) * slot;
    const float4* sB4 = reinterpret_cast<const float4*>(sx + chunk * PC);
    const float4* sC4 = reinterpret_cast<const float4*>(sx + chunk * (PC + N));
    const float* sdt = sx + chunk * (PC + 2 * N);
    const int t0 = tile * chunk, nt = min(chunk, s - t0);
    for (int j = lane; j < nt; j += WS) sdec[j] = expf(sdt[j] * a);
    __syncwarp(WMASK);

    // steps in pairs: the pair's 2 CPT sums meet in one scatter, and the
    // lanes of a column share the stores
    const float* xs = sx + pc;
    const float4* B4 = sB4 + r;
    const float4* C4 = sC4 + r;
    float* yp = yb + (int64_t)t0 * step;
    int tt = 0;
    for (; tt + 2 <= nt; tt += 2, yp += 2 * step) {
      float ua[CPT], uc[CPT], ya[CPT], yc[CPT], v[2 * CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ua[c] = sdt[tt] * xs[tt * PC + c];
        uc[c] = sdt[tt + 1] * xs[(tt + 1) * PC + c];
      }
      ssd_step<NQ, R, CPT>(h, sdec[tt], ua, B4 + tt * (N / 4), C4 + tt * (N / 4), ya);
      ssd_step<NQ, R, CPT>(h, sdec[tt + 1], uc, B4 + (tt + 1) * (N / 4),
                           C4 + (tt + 1) * (N / 4), yc);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        v[c] = ya[c];
        v[CPT + c] = yc[c];
      }
      scatter_sum<R, 2 * CPT, WMASK>(v, r);
      store_sums<R, 2 * CPT, CPT>(yp, step, v, r);
    }
    if (tt < nt) {  // an odd tile's last step
      float ua[CPT], ya[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) ua[c] = sdt[tt] * xs[tt * PC + c];
      ssd_step<NQ, R, CPT>(h, sdec[tt], ua, B4 + tt * (N / 4), C4 + tt * (N / 4), ya);
      scatter_sum<R, CPT, WMASK>(ya, r);
      store_sums<R, CPT, CPT>(yp, step, ya, r);
    }
  }
  cp_async_wait<0>();

  float* hb = h_out + ((int64_t)bi * H + hd) * N * P + p0 + pc;  // (bi, hd, 0, p0 + pc)
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int n = 4 * (r + q * R);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CPT; ++c) hb[(int64_t)(n + e) * P + c] = h[c][4 * q + e];
  }
}

template <int N, int R, int PC, int CPT>
int launch(const float* x, const float* dt, const float* A, const float* B, const float* C,
           float* y, float* h_out, int b, int s, int H, int P, int chunk, int vec,
           cudaStream_t stream) {
  constexpr int NT = PC / CPT * R;
  const int warps = (NT + 31) / 32;
  const size_t smem =
      ((size_t)STAGES * slot_floats(chunk, PC, N) + (size_t)warps * ((chunk + 3) & ~3)) *
      sizeof(float);
  if (smem > (size_t)MAX_SMEM) return -1;
  auto kernel = ssd_scan_kernel<N, R, PC, CPT>;
  if (smem > 48 * 1024) {  // above 48 KB only after an opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(H, b, P / PC), NT, smem, stream>>>(x, dt, A, B, C, y, h_out, s, H, P, chunk,
                                                       vec);
  return cudaGetLastError();  // a refused launch (too much shared memory) shows here
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// xh, y: (b, s, H, P); dt: (b, s, H); A: (H,); B, C: (b, s, N); h_out:
// (b, H, N, P); all fp32, contiguous and on the current device. The plan:
// pc columns a block (P % pc == 0), r threads a column, cpt columns a thread,
// a ring of STAGES tiles of `chunk` steps; the caller keeps its shared
// memory within MAX_SMEM (the wrapper's plan does).
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A, const float* B,
                            const float* C, float* y, float* h_out, int b, int s, int H, int P,
                            int N, int pc, int r, int cpt, int chunk, void* stream) {
  if (pc <= 0 || P % pc != 0 || chunk < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(x) && aligned16(B) && aligned16(C);
#define SSD_CASE(NN, RR, PCC, CC)                                                      \
  if (N == NN && r == RR && pc == PCC && cpt == CC)                                    \
    return launch<NN, RR, PCC, CC>(x, dt, A, B, C, y, h_out, b, s, H, P, chunk, vec, st);
  SSD_CASE(64, 2, 32, 2)  // zamba2-7b (P 64)
  SSD_CASE(16, 4, 16, 1)  // zamba2-7b reduced (P 32)
  SSD_CASE(4, 1, 4, 1)    // the TestSSDScan shapes and sweep: P 8 and 16, N 4 and 8
  SSD_CASE(8, 2, 4, 1)
  SSD_CASE(4, 1, 8, 1)
  SSD_CASE(8, 2, 8, 1)
#undef SSD_CASE
  return -1;
}
