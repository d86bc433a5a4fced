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
// is bound by operations, and only a kernel that keeps the state on chip for
// the whole sequence (no chunk states in device memory) and keeps the FMA
// pipes busy can approach it.
//
// What the design does about it: the TPU kernel carried the state in VMEM
// scratch across a sequential grid axis of chunks; blocks on the card run in
// no order, so here one block owns one (batch, head) and loops over time
// itself. Thread p of the block's P threads keeps column h[:, p] (N floats)
// in registers for the whole sequence, so the state never leaves the SM and
// is written once, at the end. x, dt, B and C of a tile of `chunk` steps are
// staged in shared memory with coalesced loads; each step reads B and C back
// as float4 broadcasts (every thread reads the same address), and the y sum
// runs in four partial sums to shorten its chain of dependent FMAs. The
// time order is that of the sequential recurrence; the tile only decides
// when inputs are staged, so results do not depend on it. The ragged last
// tile is shorter; nothing is padded. Parallelism is b * H blocks of P
// threads (448 blocks of 64 at the prefill shape, about 3.4 a SM); the
// chunked tensor-core form (wgmma on C B^T and on the chunk states) and a
// split of N over more threads are later work.
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success) or -1 for a (P, N) that is not instantiated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int P, int N>
__global__ void __launch_bounds__(P)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ y,
                float* __restrict__ h_out, int s, int H, int chunk) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // chunk x P
  float* sB = sx + chunk * P;                   // chunk x N (16-byte aligned: P % 4 == 0)
  float* sC = sB + chunk * N;                   // chunk x N
  float* sdt = sC + chunk * N;                  // chunk

  const int p = threadIdx.x;
  const int hd = blockIdx.x;
  const int bi = blockIdx.y;
  const int64_t step = (int64_t)H * P;                                // floats between two steps of xh
  const int64_t seq0 = (int64_t)bi * s * step + (int64_t)hd * P + p;  // (bi, 0, hd, p)
  const float* dtb = dt + (int64_t)bi * s * H + hd;                   // (bi, 0, hd)
  const float* Bb = B + (int64_t)bi * s * N;                          // (bi, 0, 0)
  const float* Cb = C + (int64_t)bi * s * N;
  const float a = A[hd];

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;

  for (int t0 = 0; t0 < s; t0 += chunk) {
    const int nt = min(chunk, s - t0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) sx[tt * P + p] = x[seq0 + (int64_t)(t0 + tt) * step];
    // B and C of the tile are nt * N contiguous floats each
    for (int i = p; i < nt * N; i += P) {
      sB[i] = Bb[(int64_t)t0 * N + i];
      sC[i] = Cb[(int64_t)t0 * N + i];
    }
    for (int i = p; i < nt; i += P) sdt[i] = dtb[(int64_t)(t0 + i) * H];
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float d = sdt[tt];
      const float decay = expf(d * a);
      const float u = d * sx[tt * P + p];
      const float4* B4 = reinterpret_cast<const float4*>(sB + tt * N);
      const float4* C4 = reinterpret_cast<const float4*>(sC + tt * N);
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = B4[q], cq = C4[q];
        const int n = 4 * q;
        h[n] = fmaf(decay, h[n], u * bq.x);
        h[n + 1] = fmaf(decay, h[n + 1], u * bq.y);
        h[n + 2] = fmaf(decay, h[n + 2], u * bq.z);
        h[n + 3] = fmaf(decay, h[n + 3], u * bq.w);
        y0 = fmaf(cq.x, h[n], y0);
        y1 = fmaf(cq.y, h[n + 1], y1);
        y2 = fmaf(cq.z, h[n + 2], y2);
        y3 = fmaf(cq.w, h[n + 3], y3);
      }
      y[seq0 + (int64_t)(t0 + tt) * step] = (y0 + y1) + (y2 + y3);
    }
  }
  float* hb = h_out + ((int64_t)bi * H + hd) * N * P + p;  // (bi, hd, 0, p)
#pragma unroll
  for (int n = 0; n < N; ++n) hb[(int64_t)n * P] = h[n];
}

template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* B,
                   const float* C, float* y, float* h_out, int b, int s, int H, int chunk,
                   cudaStream_t stream) {
  const size_t smem = (size_t)chunk * (P + 2 * N + 1) * sizeof(float);  // x, B, C, dt tiles
  ssd_scan_kernel<P, N><<<dim3(H, b), P, smem, stream>>>(x, dt, A, B, C, y, h_out, s, H, chunk);
  return cudaGetLastError();
}

}  // namespace

// xh, y: (b, s, H, P); dt: (b, s, H); A: (H,); B, C: (b, s, N); h_out:
// (b, H, N, P); all fp32, contiguous and on the current device. The caller
// keeps chunk * (P + 2N + 1) * 4 bytes within the 48 KB of shared memory a
// launch gets without an opt-in.
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A, const float* B,
                            const float* C, float* y, float* h_out, int b, int s, int H, int P,
                            int N, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_CASE(PP, NN) \
  if (P == PP && N == NN) return launch<PP, NN>(x, dt, A, B, C, y, h_out, b, s, H, chunk, st);
  SSD_CASE(64, 64)  // zamba2-7b
  SSD_CASE(32, 16)  // zamba2-7b reduced
  SSD_CASE(8, 4)    // the TestSSDScan shapes and sweep
  SSD_CASE(8, 8)
  SSD_CASE(16, 4)
  SSD_CASE(16, 8)
#undef SSD_CASE
  return -1;
}
