// Flash-attention forward for NVIDIA Hopper (sm_90a), fp32 math on CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_tpu
// (body _attn_kernel). Same function: blockwise online-softmax GQA attention,
// kv head = h / (H/G), scale 1/sqrt(hd) unless given; a row's valid columns
// are col < t, col <= row when causal, col > row - window when a window is
// given (q and kv positions both count from 0); padded kv rows are zeroed;
// m, l and acc are fp32, exp(s - m_new) is zeroed on masked entries, and the
// output is acc / max(l, 1e-30) in q's dtype (fp32 or bf16).
//
// Bound on the card: at the serving prefill shape of qwen3-0.6b
// (b=4, s=t=1024, H=16, G=8, hd=128, causal) the work is
// 4*hd*b*H*s(s+1)/2 = 17.2 GFLOP against ~0.1 GB of q/k/v/o traffic, so the
// kernel is compute-bound: on fp32 CUDA cores (67 TFLOP/s) that is 0.26 ms,
// while the bytes alone take 0.03 ms at 3.35 TB/s.
//
// What the design does about it: it keeps the FMA pipes, not shared-memory
// loads, the limiter. One block of 256 threads owns a (batch, q-head,
// 64-row q tile); it stages q once, then walks 64-row kv tiles through one
// shared buffer (K for the scores, then V for the product). Each thread owns
// a 4x4 micro-tile of the 64x64 score tile and a 4 x (4*ceil(hd/64)) slice of
// the output accumulator, and reads shared memory as float4 (rows padded by
// 4 floats, so the reads are free of bank conflicts). kv tiles wholly above
// the causal diagonal or wholly left of the window are skipped (they add
// exactly 0), and the heaviest causal q tiles are launched first. The
// tensor-core route (wgmma on bf16, TMA, warp specialisation) comes later.
//
// Head dims 16, 32, 64, 112 (zamba2-7b), 120 (h2o-danube-3-4b), 128 and 256
// are instantiated. A head dim needs HD % 4 == 0 for the float4 staging; one
// that is not a multiple of 64 leaves the threads past HD idle in the output
// columns (d < HD guards).
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success), -1 for an unsupported head dim and -2 for an unsupported dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv rows per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory opt-in is remembered

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(p2[0]);
    const float2 b = __bfloat1622float2(p2[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
    p2[0] = __floats2bfloat162_rn(x.x, x.y);
    p2[1] = __floats2bfloat162_rn(x.z, x.w);
  }
};

// Copy rows [row0, row0 + 64) of one head into a 64 x HD fp32 tile with row
// stride HD + 4; rows at or past row0 + n_valid are written as zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int row0, int n_valid,
                                           int64_t row_stride, int tid) {
  constexpr int V4 = HD / 4;
  constexpr int STRIDE = HD + 4;
  for (int idx = tid; idx < 64 * V4; idx += THREADS) {
    const int r = idx / V4;
    const int c = (idx - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = Io<T>::load4(src + (int64_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * STRIDE + c) = x;
  }
}

// Reductions over the 16 lanes that share a q row (lanes 0-15 or 16-31).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int s, int t, int H, int G, int causal, int window,
                 float scale) {
  constexpr int QS = HD + 4;          // row stride of the q and k/v tiles
  constexpr int PS = BK + 4;          // row stride of the probability tile
  constexpr int NJ = (HD + 63) / 64;  // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + BQ * QS;
  float* sP = sKV + BK * QS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16j; output columns 4tx + 64jj
  const int ty = tid >> 4;  // rows 4ty .. 4ty+3 of the tile
  const int nq = (s + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = h / (H / G);

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)G * HD;
  const T* qb = q + ((int64_t)bi * s * H + h) * HD;
  const T* kb = k + ((int64_t)bi * t * G + g) * HD;
  const T* vb = v + ((int64_t)bi * t * G + g) * HD;

  stage_tile<T, HD>(sQ, qb, q0, min(BQ, s - q0), q_stride, tid);

  // kv tiles that can hold a valid column for some row of this q tile
  int kv_end = t;
  if (causal) kv_end = min(t, q0 + BQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int kt_begin = kv_begin / BK;
  const int kt_end = (kv_end + BK - 1) / BK;

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int kn = min(BK, t - k0);
    __syncthreads();  // the last tile's product is done with sKV and sP
    stage_tile<T, HD>(sKV, kb, k0, kn, kv_stride, tid);
    __syncthreads();

    // scores: 4x4 per thread
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, online-softmax statistics, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool valid = col < t;
        if (causal) valid = valid && col <= row;
        if (window > 0) valid = valid && col > row - window;
        ok[j] = valid;
        sc[i][j] = valid ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = max16(mx);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      rs = sum16(rs);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jj][c] *= alpha;
    }
    __syncthreads();  // scores are done with K; P is complete
    stage_tile<T, HD>(sKV, vb, k0, kn, kv_stride, tid);
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * PS + c);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx * 4 + 64 * jj;
        if (d < HD) {
          const float4 v0 = *reinterpret_cast<const float4*>(sKV + (c + 0) * QS + d);
          const float4 v1 = *reinterpret_cast<const float4*>(sKV + (c + 1) * QS + d);
          const float4 v2 = *reinterpret_cast<const float4*>(sKV + (c + 2) * QS + d);
          const float4 v3 = *reinterpret_cast<const float4*>(sKV + (c + 3) * QS + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i][jj];
            a[0] = fmaf(pv[i].w, v3.x, fmaf(pv[i].z, v2.x, fmaf(pv[i].y, v1.x, fmaf(pv[i].x, v0.x, a[0]))));
            a[1] = fmaf(pv[i].w, v3.y, fmaf(pv[i].z, v2.y, fmaf(pv[i].y, v1.y, fmaf(pv[i].x, v0.y, a[1]))));
            a[2] = fmaf(pv[i].w, v3.z, fmaf(pv[i].z, v2.z, fmaf(pv[i].y, v1.z, fmaf(pv[i].x, v0.z, a[2]))));
            a[3] = fmaf(pv[i].w, v3.w, fmaf(pv[i].z, v2.w, fmaf(pv[i].y, v1.w, fmaf(pv[i].x, v0.w, a[3]))));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < s) {
      const float den = fmaxf(l[i], 1e-30f);
      T* orow = o + (((int64_t)bi * s + row) * H + h) * HD;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx * 4 + 64 * jj;
        if (d < HD)
          Io<T>::store4(orow + d, make_float4(acc[i][jj][0] / den, acc[i][jj][1] / den,
                                              acc[i][jj][2] / den, acc[i][jj][3] / den));
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int s, int t,
                   int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int QS = HD + 4;
  constexpr int PS = BK + 4;
  const int smem = (int)sizeof(float) * (BQ * QS + BK * QS + BQ * PS);
  // Above 48 KB a launch is refused unless the kernel opts in. The opt-in
  // holds per device, so it is made once per device and instantiation (two
  // threads racing here both set the same value).
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const dim3 grid((s + BQ - 1) / BQ, H, b);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, H, G, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int b, int s, int t,
                int H, int G, int hd, int causal, int window, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 112: return launch<T, 112>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 120: return launch<T, 120>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    default: return -1;
  }
}

}  // namespace

// q (b, s, H, hd), k and v (b, t, G, hd), o (b, s, H, hd), all contiguous,
// 16-byte aligned and on the current device; stream belongs to that device.
// dtype 0 = fp32, 1 = bf16. window <= 0 means no window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int s, int t, int H, int G, int hd, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (b == 0 || s == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, b, s, t, H, G, hd, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, b, s, t, H, G, hd, causal, window, scale, st);
  return -2;
}
