// RWKV6 wkv recurrence for NVIDIA Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:57 wkv6_tpu (body _wkv6_kernel).
// Same function: for each (batch, head), with S the (P, P) fp32 state,
//   y_t = r_t . (S + diag(u) k_t^T v_t),   then   S <- diag(w_t) S + k_t^T v_t,
// in time order; r, k, v, w are (b, s, H, P), u is (H, P), the state
// (b, H, P, P). It returns y (b, s, H, P) and the final state.
//
// Bound on the card: at the rwkv6-7b serving prefill shape (b=4, s=1024,
// H=64, P=64) the kernel must read r/k/v/w (268 MB), write y (67 MB) and read
// and write the state (8.4 MB): 344 MB, 0.103 ms at 3.35 TB/s. The work is
// 5 P^2 operations a step and head (r.S, and the state update w*S + k*v),
// 5.4 GFLOP, 0.080 ms at the 67 TFLOP/s fp32 CUDA-core peak. So it is bound
// by bytes, and only a kernel that streams r/k/v/w once, keeps the state on
// chip for the whole sequence and writes only y and the final state can
// approach it. At the decode step (b=1, s=1) the bytes are the state read
// and written once, 2.2 MB, 0.65 us.
//
// Why not tensor cores: a chunked matrix form (r S over a chunk, the
// intra-chunk r k^T products under the decays) does more multiply-adds than
// the recurrence, and held to fp32 (the port's parity rule) each product
// runs as 3xTF32; mma.sync tf32 reaches 323 TFLOP/s on this card, only 4.8x
// the CUDA cores' 67, and the kernel is bound by bytes in any case.
//
// What the design does about it: the columns j of S are independent, so a
// block owns PC of them and the grid is (H, b, P / PC). Each column has R
// threads, and thread ri of a column keeps the rows of S in the float4
// groups ri, ri + R, ... in registers for the whole sequence (the R threads
// read R neighbouring float4s of r, k and w: no bank conflicts); a thread
// owns CPT neighbouring columns, so each float4 of r, k and w it reads from
// shared memory serves CPT columns:
//   y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,   S_ij <- w_i S_ij + k_i v_j.
// Steps run in pairs, and the R partial sums of r.S of a step's CPT values
// meet in a scatter across the R-lane group (__shfl_xor_sync, half the
// values swapped a round) as soon as the step ends, each as the butterfly
// over four sums of a thread's rows: the first step's shuffles then overlap
// the second step's FMAs, which matters at one warp a scheduler (the
// prefill plan); sum_i r_i u_i k_i is the same for every column, so it is
// taken once a step for the block, by eight lanes a step over the rows g,
// g + 8, ... and a butterfly: the order of every sum depends on (PC, R,
// CPT) and P alone. r, k, w (all P of a step) and v (the block's PC columns)
// reach shared memory through a ring of STAGES tiles of `chunk` steps,
// copied by cp.async (16 bytes where the rows are 16-byte aligned, else 4):
// tiles t + 1 .. t + STAGES - 1 are in flight while tile t runs. A tile
// takes two barriers: one publishes the tile that landed and frees the slot
// the next copy fills, one publishes its sums r.u.k. The tile decides only
// when inputs are staged, so results do not depend on it. The ragged last
// tile is shorter; nothing is padded. Blocks own disjoint columns and each
// thread reads its own entries of the state (first of all its loads) before
// it writes them, so the final state may be written over the initial one
// (the decode path passes the cache's state as both). The plan (Python,
// kernel.plan) keeps all P columns in a block where b H blocks reach 256,
// as at the rwkv6-7b prefill (PC 64, R 4, CPT 4, two slots of 48 steps: 256
// blocks of 64 threads, 96 KB of shared memory, two blocks an SM): a split
// there stages each head's r, k and w once a block, and 512 blocks of 32
// columns ran 15-20 % slower on the card (tools/scan_variants.py). The
// decode step (b 1, s 1) splits the columns four ways (PC 16, R 2, CPT 1):
// 256 blocks instead of 64; it stages nothing, so it runs wkv6_step_kernel,
// the same layout without the ring, its barriers or the r.u.k pass.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success) or -1 for a plan (P, R, PC, CPT) that is not instantiated or not
// legal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block can have on sm_90
constexpr int G = 8;              // lanes that sum r.u.k of one step
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

// One step of the recurrence on a thread's rows of S (the float4 groups
// q R of r4, k4 and w4) in each of its CPT columns: the thread's partial
// sum of r.S with the state before the step, in four sums over its rows,
// and the update. r, k and w are read once for the CPT columns.
template <int NQ, int R, int CPT>
__device__ __forceinline__ void wkv_step(float (&S)[CPT][4 * NQ], const float4* r4,
                                         const float4* k4, const float4* w4,
                                         const float (&vj)[CPT], float (&part)[CPT]) {
  float acc[CPT][4];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 rq = r4[q * R], kq = k4[q * R], wq = w4[q * R];
    const int n = 4 * q;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[c][0] = fmaf(rq.x, S[c][n], acc[c][0]);
      S[c][n] = fmaf(wq.x, S[c][n], kq.x * vj[c]);
      acc[c][1] = fmaf(rq.y, S[c][n + 1], acc[c][1]);
      S[c][n + 1] = fmaf(wq.y, S[c][n + 1], kq.y * vj[c]);
      acc[c][2] = fmaf(rq.z, S[c][n + 2], acc[c][2]);
      S[c][n + 2] = fmaf(wq.z, S[c][n + 2], kq.z * vj[c]);
      acc[c][3] = fmaf(rq.w, S[c][n + 3], acc[c][3]);
      S[c][n + 3] = fmaf(wq.w, S[c][n + 3], kq.w * vj[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) part[c] = (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
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

// Reads (STORE false) or writes this thread's entries of a (P, P) state (st
// at the thread's first column): rows 4 (ri + q R) + e of CPT columns.
template <int P, int R, int CPT, bool STORE, typename T>
__device__ __forceinline__ void state_rows(float (&S)[CPT][P / R], T* st, int ri) {
#pragma unroll
  for (int q = 0; q < P / (4 * R); ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int64_t at = (int64_t)(4 * (ri + q * R) + e) * P + c;
        if constexpr (STORE) st[at] = S[c][4 * q + e];
        else S[c][4 * q + e] = st[at];
      }
}

// Stores y_j = r.S_j + v_j sum_i r_i u_i k_i from the sums of r.S that
// scatter_sum left in this lane: value u CPT + c is column c at step u (yp,
// vs and ruk at step 0, vs at the thread's first column); lanes r >= S hold
// copies.
template <int R, int K, int CPT, int PC>
__device__ __forceinline__ void store_sums(float* yp, int64_t step, const float (&v)[K],
                                           const float* vs, const float* ruk, int r) {
  constexpr int S = R < K ? R : K;
  if (r < S) {
#pragma unroll
    for (int i = 0; i < K / S; ++i) {
      const int idx = S * i + (r & (S - 1)), u = idx / CPT, c = idx % CPT;
      yp[u * step + c] = fmaf(vs[u * PC + c], ruk[u], v[i]);
    }
  }
}

template <int P, int R, int PC, int CPT>
__global__ void __launch_bounds__(PC / CPT * R)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* state, float* __restrict__ y,
            float* state_out, int s, int H, int chunk, int vec) {
  constexpr int NT = PC / CPT * R;  // threads
  constexpr int NQ = P / (4 * R);   // float4 groups of a column of S a thread
  constexpr unsigned WMASK = NT < 32 ? (1u << NT) - 1 : 0xffffffffu;
  static_assert(P % (4 * R) == 0 && PC % 4 == 0 && PC % CPT == 0 && (CPT & (CPT - 1)) == 0 &&
                NT % G == 0 && (NT < 32 || NT % 32 == 0), "plan");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = chunk * (3 * P + PC);  // r, k, w (chunk x P each), v (chunk x PC)
  float* su = smem + STAGES * slot;       // u of the head
  float* sruk = su + P;                   // sum_i r_i u_i k_i of each step of the tile

  const int tid = threadIdx.x;
  const int ri = tid % R, pc = tid / R * CPT;  // pc: the first of the thread's columns
  const int h = blockIdx.x, bi = blockIdx.y, j0 = blockIdx.z * PC;
  const int64_t step = (int64_t)H * P;                                // floats between two steps
  const int64_t seq0 = (int64_t)bi * s * step + (int64_t)h * P;      // (bi, 0, h, 0)
  const int64_t st0 = ((int64_t)bi * H + h) * P * P + j0 + pc;       // (bi, h, 0, j)
  const int tiles = (s + chunk - 1) / chunk;

  // start the copies of one tile into its ring slot (no wait)
  auto load = [&](int tile) {
    float* sr = smem + (tile % STAGES) * slot;
    float* sk = sr + chunk * P;
    float* sw = sk + chunk * P;
    float* sv = sw + chunk * P;
    const int t0 = tile * chunk, nt = min(chunk, s - t0);
    const float* rt = r + seq0 + (int64_t)t0 * step;
    const float* kt = k + seq0 + (int64_t)t0 * step;
    const float* wt = w + seq0 + (int64_t)t0 * step;
    const float* vt = v + seq0 + (int64_t)t0 * step + j0;
    if (vec) {
      constexpr int V = P / 4, VC = PC / 4;  // 16-byte pieces of a step's r and of its v
      for (int c = tid; c < nt * V; c += NT) {
        const int tt = c / V, e = 4 * (c - tt * V);
        const int64_t g = (int64_t)tt * step + e;
        cp_async16(sr + tt * P + e, rt + g);
        cp_async16(sk + tt * P + e, kt + g);
        cp_async16(sw + tt * P + e, wt + g);
      }
      for (int c = tid; c < nt * VC; c += NT) {
        const int tt = c / VC, e = 4 * (c - tt * VC);
        cp_async16(sv + tt * PC + e, vt + (int64_t)tt * step + e);
      }
    } else {
      for (int c = tid; c < nt * P; c += NT) {
        const int tt = c / P, e = c - tt * P;
        const int64_t g = (int64_t)tt * step + e;
        cp_async4(sr + c, rt + g);
        cp_async4(sk + c, kt + g);
        cp_async4(sw + c, wt + g);
      }
      for (int c = tid; c < nt * PC; c += NT) {
        const int tt = c / PC, e = c - tt * PC;
        cp_async4(sv + c, vt + (int64_t)tt * step + e);
      }
    }
  };

  // the state's loads first: their latency then overlaps the tiles' copies
  float S[CPT][4 * NQ];  // rows 4 (ri + q R) + e of columns j0 + pc + c
  state_rows<P, R, CPT, false>(S, state + st0, ri);
  for (int t = 0; t < STAGES - 1; ++t) {  // every thread commits a group a tile, empty or not
    if (t < tiles) load(t);
    cp_async_commit();
  }
  for (int i = tid; i < P; i += NT) su[i] = u[h * P + i];

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();            // everyone's have (and u is staged); tile - 1's slot is free
    if (tile + STAGES - 1 < tiles) load(tile + STAGES - 1);
    cp_async_commit();

    const float* sr = smem + (tile % STAGES) * slot;
    const float* sk = sr + chunk * P;
    const float* sw = sk + chunk * P;
    const float* sv = sw + chunk * P;
    const int t0 = tile * chunk, nt = min(chunk, s - t0);
    for (int base = 0; base < nt; base += NT / G) {  // the same trip count in every thread
      const int tt = base + tid / G, g = tid % G;
      float acc = 0.f;
      if (tt < nt)
        for (int i = g; i < P; i += G) acc = fmaf(sr[tt * P + i] * su[i], sk[tt * P + i], acc);
      acc += __shfl_xor_sync(WMASK, acc, 1);
      acc += __shfl_xor_sync(WMASK, acc, 2);
      acc += __shfl_xor_sync(WMASK, acc, 4);
      if (tt < nt && g == 0) sruk[tt] = acc;
    }
    __syncthreads();  // the tile's sums r.u.k are in place

    // steps in pairs: each step's sums meet while the next step runs, and
    // the lanes of a column share the stores
    const float4* r4 = reinterpret_cast<const float4*>(sr) + ri;
    const float4* k4 = reinterpret_cast<const float4*>(sk) + ri;
    const float4* w4 = reinterpret_cast<const float4*>(sw) + ri;
    const float* vs = sv + pc;
    float* yp = y + seq0 + (int64_t)t0 * step + j0 + pc;
    int tt = 0;
    for (; tt + 2 <= nt; tt += 2, yp += 2 * step) {
      float va[CPT], vc[CPT], pa[CPT], pb[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        va[c] = vs[tt * PC + c];
        vc[c] = vs[(tt + 1) * PC + c];
      }
      const int a = tt * (P / 4), b = (tt + 1) * (P / 4);
      wkv_step<NQ, R, CPT>(S, r4 + a, k4 + a, w4 + a, va, pa);
      scatter_sum<R, CPT, WMASK>(pa, ri);
      wkv_step<NQ, R, CPT>(S, r4 + b, k4 + b, w4 + b, vc, pb);
      scatter_sum<R, CPT, WMASK>(pb, ri);
      store_sums<R, CPT, CPT, PC>(yp, step, pa, vs + tt * PC, sruk + tt, ri);
      store_sums<R, CPT, CPT, PC>(yp + step, step, pb, vs + (tt + 1) * PC, sruk + tt + 1, ri);
    }
    if (tt < nt) {  // an odd tile's last step
      float va[CPT], pa[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) va[c] = vs[tt * PC + c];
      const int a = tt * (P / 4);
      wkv_step<NQ, R, CPT>(S, r4 + a, k4 + a, w4 + a, va, pa);
      scatter_sum<R, CPT, WMASK>(pa, ri);
      store_sums<R, CPT, CPT, PC>(yp, step, pa, vs + tt * PC, sruk + tt, ri);
    }
  }
  cp_async_wait<0>();
  state_rows<P, R, CPT, true>(S, state_out + st0, ri);
}

// The decode step (s = 1) has no tiles to stage, so it needs no ring and no
// barrier: each thread loads its rows of r, k, w and u (float4 where they
// are 16-byte aligned) and its columns of v straight from device memory,
// beside its entries of the state, and sums r.u.k over its own rows:
//   y_j = sum over the R lanes of (sum_i r_i S_ij + v_j sum_i r_i u_i k_i),
// the inner sums over the thread's rows in four sums each, the R lanes met
// by scatter_sum: an order fixed by the plan alone.
template <int P, int R, int PC, int CPT>
__global__ void __launch_bounds__(PC / CPT * R)
wkv6_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* state, float* __restrict__ y,
                 float* state_out, int H, int vec) {
  constexpr int NT = PC / CPT * R;
  constexpr int NQ = P / (4 * R);
  constexpr int S4 = R < CPT ? R : CPT;  // lanes of a column group that store
  constexpr unsigned WMASK = NT < 32 ? (1u << NT) - 1 : 0xffffffffu;
  const int tid = threadIdx.x;
  const int ri = tid % R, pc = tid / R * CPT;
  const int h = blockIdx.x, bi = blockIdx.y, j0 = blockIdx.z * PC;
  const int64_t row0 = ((int64_t)bi * H + h) * P;       // (bi, 0, h, 0) of r, k, v, w, y
  const int64_t st0 = row0 * P + j0 + pc;               // (bi, h, 0, j)

  float S[CPT][4 * NQ];
  state_rows<P, R, CPT, false>(S, state + st0, ri);
  float4 rq[NQ], kq[NQ], wq[NQ], uq[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = 4 * (ri + q * R);
    if (vec) {
      rq[q] = *reinterpret_cast<const float4*>(r + row0 + i);
      kq[q] = *reinterpret_cast<const float4*>(k + row0 + i);
      wq[q] = *reinterpret_cast<const float4*>(w + row0 + i);
      uq[q] = *reinterpret_cast<const float4*>(u + (int64_t)h * P + i);
    } else {
      const float* rp = r + row0 + i;
      const float* kp = k + row0 + i;
      const float* wp = w + row0 + i;
      const float* up = u + (int64_t)h * P + i;
      rq[q] = make_float4(rp[0], rp[1], rp[2], rp[3]);
      kq[q] = make_float4(kp[0], kp[1], kp[2], kp[3]);
      wq[q] = make_float4(wp[0], wp[1], wp[2], wp[3]);
      uq[q] = make_float4(up[0], up[1], up[2], up[3]);
    }
  }
  float vj[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) vj[c] = v[row0 + j0 + pc + c];

  float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;  // sum_i r_i u_i k_i over this thread's rows
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    b0 = fmaf(rq[q].x * uq[q].x, kq[q].x, b0);
    b1 = fmaf(rq[q].y * uq[q].y, kq[q].y, b1);
    b2 = fmaf(rq[q].z * uq[q].z, kq[q].z, b2);
    b3 = fmaf(rq[q].w * uq[q].w, kq[q].w, b3);
  }
  const float ruk = (b0 + b1) + (b2 + b3);
  float part[CPT];
  wkv_step<NQ, 1, CPT>(S, rq, kq, wq, vj, part);  // the registers hold this thread's groups only
#pragma unroll
  for (int c = 0; c < CPT; ++c) part[c] = fmaf(vj[c], ruk, part[c]);
  scatter_sum<R, CPT, WMASK>(part, ri);
  if (ri < S4) {
#pragma unroll
    for (int i = 0; i < CPT / S4; ++i) y[row0 + j0 + pc + S4 * i + (ri & (S4 - 1))] = part[i];
  }
  state_rows<P, R, CPT, true>(S, state_out + st0, ri);
}

template <int P, int R, int PC, int CPT>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* state, float* y, float* state_out, int b, int s, int H, int chunk,
           int vec, cudaStream_t stream) {
  if (s == 1) {  // the decode step: no ring (vec also needs u aligned there)
    const int vec_u = vec && (reinterpret_cast<uintptr_t>(u) & 15) == 0;
    wkv6_step_kernel<P, R, PC, CPT><<<dim3(H, b, P / PC), PC / CPT * R, 0, stream>>>(
        r, k, v, w, u, state, y, state_out, H, vec_u);
    return cudaGetLastError();
  }
  const size_t smem =
      ((size_t)STAGES * chunk * (3 * P + PC) + P + ((chunk + 3) & ~3)) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return -1;
  auto kernel = wkv6_kernel<P, R, PC, CPT>;
  if (smem > 48 * 1024) {  // above 48 KB only after an opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(H, b, P / PC), PC / CPT * R, smem, stream>>>(r, k, v, w, u, state, y,
                                                             state_out, s, H, chunk, vec);
  return cudaGetLastError();  // a refused launch (too much shared memory) shows here
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// r, k, v, w, y: (b, s, H, P); u: (H, P); state, state_out: (b, H, P, P); all
// fp32 and contiguous. state_out may be state itself. The plan: pc columns a
// block (P % pc == 0), tc threads a column, cpt columns a thread, a ring of
// STAGES tiles of `chunk` steps; the caller keeps its shared memory within
// MAX_SMEM (the wrapper's plan does).
extern "C" int wkv6_fwd(const float* r, const float* k, const float* v, const float* w,
                        const float* u, const float* state, float* y, float* state_out, int b,
                        int s, int H, int P, int pc, int tc, int cpt, int chunk, void* stream) {
  if (pc <= 0 || P % pc != 0 || chunk < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w);
#define WKV_CASE(PP, RR, PCC, CC)                                                            \
  if (P == PP && tc == RR && pc == PCC && cpt == CC)                                         \
    return launch<PP, RR, PCC, CC>(r, k, v, w, u, state, y, state_out, b, s, H, chunk, vec, \
                                   st);
  WKV_CASE(64, 4, 64, 4)  // rwkv6-7b prefill: 256 blocks at b 4, H 64
  WKV_CASE(64, 2, 16, 1)  // rwkv6-7b decode: 256 blocks at b 1
  WKV_CASE(32, 2, 16, 1)
  WKV_CASE(16, 2, 8, 1)
  WKV_CASE(8, 2, 4, 1)
#undef WKV_CASE
  return -1;
}
