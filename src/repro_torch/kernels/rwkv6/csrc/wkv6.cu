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
// approach it.
//
// What the design does about it: the TPU kernel carried the state in VMEM
// scratch across a sequential grid axis of time chunks; blocks on the card
// run in no order, so here one block owns one (batch, head) and loops over
// time itself. Thread j of the block's P threads keeps column S[:, j] in
// registers for the whole sequence, so the state is read once and written
// once. r, k, w and v of a tile of `chunk` steps are staged in shared memory
// with coalesced loads (thread j loads element j of each step), and each
// step reads r, k, w as float4 broadcasts:
//   y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,   S_ij <- w_i S_ij + k_i v_j.
// The time order is that of the sequential recurrence; the tile only decides
// when inputs are staged, so results do not depend on it. The ragged last
// tile is shorter; nothing is padded. Each block reads its whole state before
// it writes any of it, so the final state may be written over the initial
// one (the decode path passes the cache's state as both). Parallelism is
// b * H blocks of P threads, low at decode (64 blocks); a split of the
// columns' rows over more threads and double-buffered tiles are later work.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success) or -1 for a head size that is not instantiated (8, 16, 32, 64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int P>
__global__ void __launch_bounds__(P)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* state, float* __restrict__ y,
            float* state_out, int s, int H, int chunk) {
  extern __shared__ float4 smem4[];
  __shared__ float4 su4[P / 4];
  float* sr = reinterpret_cast<float*>(smem4);
  float* sk = sr + chunk * P;
  float* sw = sk + chunk * P;
  float* sv = sw + chunk * P;

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int64_t step = (int64_t)H * P;  // floats between two time steps
  const int64_t seq0 = (int64_t)bi * s * step + (int64_t)h * P + j;  // (bi, 0, h, j)
  const int64_t st0 = ((int64_t)bi * H + h) * P * P + j;  // (bi, h, 0, j)

  reinterpret_cast<float*>(su4)[j] = u[h * P + j];
  float S[P];
#pragma unroll
  for (int i = 0; i < P; ++i) S[i] = state[st0 + (int64_t)i * P];

  for (int t0 = 0; t0 < s; t0 += chunk) {
    const int n = min(chunk, s - t0);
    __syncthreads();  // the previous tile is consumed (and u is staged)
    // unrolled so that 32 loads are in flight, not each step's four alone
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const int64_t g = seq0 + (int64_t)(t0 + tt) * step;
      sr[tt * P + j] = r[g];
      sk[tt * P + j] = k[g];
      sw[tt * P + j] = w[g];
      sv[tt * P + j] = v[g];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float4* r4 = reinterpret_cast<const float4*>(sr + tt * P);
      const float4* k4 = reinterpret_cast<const float4*>(sk + tt * P);
      const float4* w4 = reinterpret_cast<const float4*>(sw + tt * P);
      const float vj = sv[tt * P + j];
      // two partial sums each, to halve the chains of dependent FMAs
      float a0 = 0.f, a1 = 0.f;  // sum_i r_i S_ij (state before this step)
      float b0 = 0.f, b1 = 0.f;  // sum_i r_i u_i k_i
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = su4[q];
        const int i = 4 * q;
        a0 = fmaf(rq.x, S[i], a0);
        b0 = fmaf(rq.x * uq.x, kq.x, b0);
        S[i] = fmaf(wq.x, S[i], kq.x * vj);
        a1 = fmaf(rq.y, S[i + 1], a1);
        b1 = fmaf(rq.y * uq.y, kq.y, b1);
        S[i + 1] = fmaf(wq.y, S[i + 1], kq.y * vj);
        a0 = fmaf(rq.z, S[i + 2], a0);
        b0 = fmaf(rq.z * uq.z, kq.z, b0);
        S[i + 2] = fmaf(wq.z, S[i + 2], kq.z * vj);
        a1 = fmaf(rq.w, S[i + 3], a1);
        b1 = fmaf(rq.w * uq.w, kq.w, b1);
        S[i + 3] = fmaf(wq.w, S[i + 3], kq.w * vj);
      }
      y[seq0 + (int64_t)(t0 + tt) * step] = fmaf(vj, b0 + b1, a0 + a1);
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) state_out[st0 + (int64_t)i * P] = S[i];
}

template <int P>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* state, float* y, float* state_out, int b,
                   int s, int H, int chunk, cudaStream_t stream) {
  const size_t smem = (size_t)4 * chunk * P * sizeof(float);  // r, k, w, v tiles
  wkv6_kernel<P><<<dim3(H, b), P, smem, stream>>>(r, k, v, w, u, state, y, state_out, s, H,
                                                  chunk);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (b, s, H, P); u: (H, P); state, state_out: (b, H, P, P); all
// fp32 and contiguous. state_out may be state itself. The caller keeps
// 4 * chunk * P * 4 bytes within the 48 KB of shared memory a launch gets
// without an opt-in.
extern "C" int wkv6_fwd(const float* r, const float* k, const float* v, const float* w,
                        const float* u, const float* state, float* y, float* state_out, int b,
                        int s, int H, int P, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 8: return launch<8>(r, k, v, w, u, state, y, state_out, b, s, H, chunk, st);
    case 16: return launch<16>(r, k, v, w, u, state, y, state_out, b, s, H, chunk, st);
    case 32: return launch<32>(r, k, v, w, u, state, y, state_out, b, s, H, chunk, st);
    case 64: return launch<64>(r, k, v, w, u, state, y, state_out, b, s, H, chunk, st);
    default: return -1;
  }
}
