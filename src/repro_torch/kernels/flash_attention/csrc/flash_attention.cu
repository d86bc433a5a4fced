// Flash-attention forward for NVIDIA Hopper (sm_90a): fp32-accurate products
// on the TF32 tensor cores (3xTF32), an asynchronous K/V ring.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_tpu
// (body _attn_kernel). Same function: blockwise online-softmax GQA attention,
// kv head = h / (H/G), scale 1/sqrt(hd) unless given; a row's valid columns
// are col < t, col <= row when causal, col > row - window when a window is
// given (q and kv positions both count from 0); padded kv rows are zeroed;
// m, l and acc are fp32, masked probabilities are exactly 0, and the output
// is acc / max(l, 1e-30) in q's dtype (fp32 or bf16).
//
// Bound on the card. At the qwen3-0.6b prefill (b 4, s = t = 1024, H 16,
// G 8, hd 128, causal) the work is 4*hd*b*H*s(s+1)/2 = 17.20 GFLOP against
// 100.7 MB of q/k/v/o (0.030 ms at 3.35 TB/s): compute-bound. On fp32 CUDA
// cores (67 TFLOP/s) that is 0.2567 ms; as 3 TF32 products per product on
// the tensor cores (3 x 17.20 GFLOP at 495 TFLOP/s) 0.1042 ms. Plain TF32
// (one product) misses the 2e-5 parity by ~50x, so each operand is split,
// x = big + small with big = x rounded to TF32 (as cvt.rna) and small the
// remainder, and a.b = a_small.b_big + a_big.b_small + a_big.b_big, each
// term exact on the tensor cores and summed in fp32: the error stays ~1e-6
// at the prefill shapes, as plain fp32's.
//
// What the design does about it:
// - Products on tensor cores: mma.sync m16n8k8 tf32, S = Q.K^T and O += P.V
//   each as the three products above. bf16 inputs are exact in TF32, so
//   their small parts are zero and dropped (one product for Q.K^T, two for
//   P.V: P is fp32). On the H100 mma.sync tf32 peaks near 323 TFLOP/s, not
//   the data sheet's 495 (that is wgmma's), so the 3xTF32 ceiling is ~108
//   TFLOP/s of fp32 work (tools/flash_variants.py measures both).
// - The split is the cost to cut: cvt.rna.tf32.f32 is no single SASS
//   instruction on sm_90a (an inf guard, an add, a select, a mask), and the
//   splits outnumber the MMAs. Here big is rounded on the integer pipe (add
//   half an ulp, mask: the same rounding for finite inputs) and small goes
//   in unrounded: the tensor cores read a tf32 operand's top 19 bits, so
//   small enters truncated, at no cost in error. Each operand is split once
//   as its fragment is loaded, and each K and V fragment feeds two 16-row q
//   tiles (32 rows a warp), halving the loads and splits a product. Q is
//   staged raw in shared memory: split there it would take twice the
//   bytes, and 8 warps of 32 rows would not fit.
// - P stays in registers: S's accumulator (columns 2t, 2t+1 of an 8-wide
//   block) is P.V's A fragment when P.V's k index is permuted to match:
//   k slot t is kv row 2t, slot t+4 is row 2t+1, and V's rows are read in
//   that order. No shared-memory round trip, no shuffle.
// - An asynchronous K/V ring: separate K and V tiles, two stages, filled by
//   cp.async.cg (16 B, rows at or past t zero-filled), tile j+1 in flight
//   while tile j computes; one __syncthreads per kv tile, which both
//   publishes tile j and frees tile j-1's stage.
// - Every head dim is a multiple of 8 (the MMA's k step and n width), so hd
//   112 and 120 leave no lane idle. Row strides of hd + 4 floats make every
//   fragment load free of bank conflicts.
// - Softmax in base 2 with scale*log2(e) folded into the scores (ex2.approx);
//   the per-element mask only on tiles that cross the causal diagonal, the
//   window's left edge or t, per warp; tiles wholly masked for a warp are
//   skipped by it, and for the block not loaded. The heaviest causal q
//   tiles are launched first (the q tile is the grid's slowest dimension).
//
// Tiles: 8 warps of 32 q rows (256 a block) and 32-row kv tiles up to hd
// 128; at hd 256 4 warps of 16 rows and 16-row kv tiles, to hold the output
// accumulator in registers; at hd 224 8 warps of 16 rows and 16-row kv
// tiles. Shared memory (fp32): hd 128 202,752 B, hd 120 190,464 B, hd 112
// 178,176 B, hd 224 175,104 B, hd 256 133,120 B: one block an SM.
// Registers and spills (nvcc -Xptxas -v, sm_90a, on an H100; chip_smoke.py
// prints them): fp32 hd 16/32/64/112/120/128/256 use 119/141/176/226/244/
// 243/228 registers, bf16 113/135/170/234/250/250/219; no instantiation
// spills. Static shared memory 0 B (all of it dynamic, as above).
//
// Plain C interface for ctypes; the return value is a cudaError_t (0 on
// success), -1 for an unsupported head dim and -2 for an unsupported dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory opt-in is remembered

template <int HD>
struct Tiles {
  static constexpr int WARPS = 8;  // warps a block
  static constexpr int MT = 2;     // 16-row q tiles a warp
  static constexpr int BK = 32;    // kv rows a tile
};
template <>
struct Tiles<256> {
  static constexpr int WARPS = 4;
  static constexpr int MT = 1;
  static constexpr int BK = 16;
};
// Zamba2's shared attention (hd 224): one 16-row q tile a warp and 16-row kv
// tiles, as at 256, to hold the output accumulator in registers; 8 warps, as
// the fp32 q tile of 128 rows and two stages of k and v fit one block
template <>
struct Tiles<224> {
  static constexpr int WARPS = 8;
  static constexpr int MT = 1;
  static constexpr int BK = 16;
};

// x = big + small to fp32 accuracy: big is x rounded to TF32, to nearest
// with ties away from zero (cvt.rna.tf32.f32 for finite x) on the integer
// pipe; small = x - big, exact in fp32, goes to the tensor cores as it is,
// which read its top 19 bits (small truncated to TF32).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x to ~2 ulp; 0 below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a b on the tensor cores: a 16x8 (row), b 8x8 (col), d 16x8, tf32 in, fp32 sum
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// d += a b in 3xTF32; a split part known to be zero (a bf16 input) is skipped
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  if constexpr (!EXACT_A) mma(d, a.small, b.big);
  if constexpr (!EXACT_B) mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr bool EXACT = false;  // small part nonzero
  static __device__ __forceinline__ float get(const float* p) { return *p; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool EXACT = true;  // bf16 is exact in TF32
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// a B fragment from two shared-memory elements, split (fp32) or as it is (bf16)
template <typename T>
__device__ __forceinline__ void load_b(FragB& f, const T* p0, const T* p1) {
  const float x0 = Elem<T>::get(p0), x1 = Elem<T>::get(p1);
  if constexpr (Elem<T>::EXACT) {
    f.big[0] = __float_as_uint(x0);
    f.big[1] = __float_as_uint(x1);
  } else {
    split(x0, f.big[0], f.small[0]);
    split(x1, f.big[1], f.small[1]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// reductions over the 4 lanes that share a row of an mma fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int HD>
struct Layout {
  static constexpr int WARPS = Tiles<HD>::WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = Tiles<HD>::MT;
  static constexpr int WROWS = 16 * MT;  // q rows a warp
  static constexpr int BQ = WROWS * WARPS;
  static constexpr int BK = Tiles<HD>::BK;
  static constexpr int NT = BK / 8;   // 8-wide column blocks of a score tile
  static constexpr int ND = HD / 8;   // 8-wide column blocks of the output
  static constexpr int QS = HD + 4;   // row stride (floats) of the q tile
  static constexpr int KS = HD + 16 / (int)sizeof(T);  // row stride (elements) of a k/v tile
  static constexpr int Q_BYTES = BQ * QS * 4;
  static constexpr int KV_BYTES = BK * KS * (int)sizeof(T);  // one k or v tile
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES;        // two stages of k and v
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<T, HD>::THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int s, int t, int H, int G, int causal, int window,
                 float scale_log2) {
  using L = Layout<T, HD>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NT, ND = L::ND, QS = L::QS, KS = L::KS;
  constexpr int MT = L::MT, WROWS = L::WROWS;
  constexpr bool EXACT = Elem<T>::EXACT;
  constexpr int CH = HD * (int)sizeof(T) / 16;  // 16-byte chunks a k/v row
  constexpr int VEC = 16 / (int)sizeof(T);       // elements a chunk
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::Q_BYTES);  // [stage][k, v][BK][KS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row group and thread-in-group
  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;  // heaviest causal tiles first
  const int g = h / (H / G);

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)G * HD;
  const T* qb = q + ((int64_t)bi * s * H + h) * HD;
  const T* kb = k + ((int64_t)bi * t * G + g) * HD;
  const T* vb = v + ((int64_t)bi * t * G + g) * HD;

  // kv tiles that can hold a valid column for some row of this q tile
  const int kv_end = causal ? min(t, q0 + BQ) : t;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = kv_begin / BK;
  const int kt_end = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    T* sK = ring + stage * 2 * BK * KS;
    T* sV = sK + BK * KS;
    for (int idx = tid; idx < BK * CH; idx += L::THREADS) {
      const int r = idx / CH, c = (idx - r * CH) * VEC;
      const bool ok = k0 + r < t;
      const int64_t off = (int64_t)(ok ? k0 + r : 0) * kv_stride + c;
      cp_async16(sK + r * KS + c, kb + off, ok);
      cp_async16(sV + r * KS + c, vb + off, ok);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // stage q as fp32; rows at or past s are zeros
  for (int idx = tid; idx < BQ * (HD / VEC); idx += L::THREADS) {
    const int r = idx / (HD / VEC), c = (idx - r * (HD / VEC)) * VEC;
    float4 x[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < s) {
      const T* src = qb + (int64_t)(q0 + r) * q_stride + c;
      if constexpr (EXACT) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
        const float2 cc = __bfloat1622float2(p2[2]), d = __bfloat1622float2(p2[3]);
        x[0] = make_float4(a.x, a.y, b.x, b.y);
        x[VEC / 4 - 1] = make_float4(cc.x, cc.y, d.x, d.y);
      } else {
        x[0] = *reinterpret_cast<const float4*>(src);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) *reinterpret_cast<float4*>(sQ + r * QS + c + 4 * i) = x[i];
  }

  // this warp's q rows [w_lo, w_lo + WROWS); the thread's rows w_lo + 16 mt + gr (+ 8)
  const int w_lo = q0 + warp * WROWS, w_hi = w_lo + WROWS - 1;
  const float* qrow = sQ + (warp * WROWS + gr) * QS + tg;

  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = NEG_INF;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][n][c] = 0.f;
  }

  int stage = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, stage ^= 1) {
    cp_async_wait_all();  // this thread's copies of tile kt have landed
    __syncthreads();      // everyone's have; everyone is done with tile kt-1's stage
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();

    const int k0 = kt * BK;
    if (w_lo >= s) continue;  // no real row in this warp
    if (causal && k0 > w_hi) continue;
    if (window > 0 && k0 + BK - 1 <= w_lo - window) continue;
    const bool need_mask = k0 + BK > t || (causal && k0 + BK - 1 > w_lo) ||
                           (window > 0 && k0 <= w_hi - window);
    const T* sK = ring + stage * 2 * BK * KS;
    const T* sV = sK + BK * KS;

    // S = Q K^T, WROWS x BK a warp; each K fragment serves the warp's MT q tiles
    float sc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[mt][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      FragA qa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* qp = qrow + 16 * mt * QS + kk;
        if constexpr (EXACT) {
          qa[mt].big[0] = __float_as_uint(qp[0]);
          qa[mt].big[1] = __float_as_uint(qp[8 * QS]);
          qa[mt].big[2] = __float_as_uint(qp[4]);
          qa[mt].big[3] = __float_as_uint(qp[8 * QS + 4]);
        } else {
          split(qp[0], qa[mt].big[0], qa[mt].small[0]);
          split(qp[8 * QS], qa[mt].big[1], qa[mt].small[1]);
          split(qp[4], qa[mt].big[2], qa[mt].small[2]);
          split(qp[8 * QS + 4], qa[mt].big[3], qa[mt].small[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB kf;
        const T* kp = sK + (8 * j + gr) * KS + kk + tg;
        load_b(kf, kp, kp + 4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3<EXACT, EXACT>(sc[mt][j], qa[mt], kf);
      }
    }

    // online softmax in base 2; masked probabilities exactly 0
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = sc[mt][j][c] * scale_log2;
          if (need_mask) {
            const int row = w_lo + 16 * mt + gr + (c < 2 ? 0 : 8);
            const int col = k0 + 8 * j + 2 * tg + (c & 1);
            bool ok = col < t;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            if (!ok) x = NEG_INF;
          }
          sc[mt][j][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      float alpha[2], base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[mt][i], quad_max(mx[i]));
        base[i] = m_new == NEG_INF ? 0.f : m_new;  // a row masked so far: exp2 gives 0
        alpha[i] = fast_exp2(m[mt][i] - base[i]);
        m[mt][i] = m_new;
        l[mt][i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = fast_exp2(sc[mt][j][c] - base[c >> 1]);
          sc[mt][j][c] = p;
          l[mt][c >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
    }

    // O += P V; P's accumulator is the A fragment with k slot t = kv row 2t,
    // slot t+4 = kv row 2t+1 of each 8-row block; each V fragment serves MT q tiles
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA pa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(sc[mt][j][0], pa[mt].big[0], pa[mt].small[0]);
        split(sc[mt][j][2], pa[mt].big[1], pa[mt].small[1]);
        split(sc[mt][j][1], pa[mt].big[2], pa[mt].small[2]);
        split(sc[mt][j][3], pa[mt].big[3], pa[mt].small[3]);
      }
      const T* vp = sV + (8 * j + 2 * tg) * KS + gr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB vf;
        load_b(vf, vp + 8 * n, vp + KS + 8 * n);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3<false, EXACT>(acc[mt][n], pa[mt], vf);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w_lo + 16 * mt + gr + 8 * i;
      const float inv = 1.f / fmaxf(quad_sum(l[mt][i]), 1e-30f);
      if (row >= s) continue;
      T* orow = o + (((int64_t)bi * s + row) * H + h) * HD + 2 * tg;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float a = acc[mt][n][2 * i] * inv, b = acc[mt][n][2 * i + 1] * inv;
        if constexpr (std::is_same_v<T, float>)
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(a, b);
        else
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(a, b);
      }
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int s, int t,
                   int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using L = Layout<T, HD>;
  // Above 48 KB a launch is refused unless the kernel opts in. The opt-in
  // holds per device, so it is made once per device and instantiation (two
  // threads racing here both set the same value).
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const dim3 grid(H, b, (s + L::BQ - 1) / L::BQ);
  flash_fwd_kernel<T, HD><<<grid, L::THREADS, L::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, H, G, causal, window, scale * LOG2E);
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
    case 224: return launch<T, 224>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, t, H, G, causal, window, scale, stream);
    default: return -1;
  }
}

template <typename T, int HD>
int plan_of(int* out) {
  using L = Layout<T, HD>;
  out[0] = L::THREADS;
  out[1] = L::SMEM;
  out[2] = L::BQ;
  out[3] = L::BK;
  return 0;
}

template <typename T>
int plan_hd(int hd, int* out) {
  switch (hd) {
    case 16: return plan_of<T, 16>(out);
    case 32: return plan_of<T, 32>(out);
    case 64: return plan_of<T, 64>(out);
    case 112: return plan_of<T, 112>(out);
    case 120: return plan_of<T, 120>(out);
    case 128: return plan_of<T, 128>(out);
    case 224: return plan_of<T, 224>(out);
    case 256: return plan_of<T, 256>(out);
    default: return -1;
  }
}

}  // namespace

// The launch flash_attention_fwd makes at head size hd and dtype (0 = fp32,
// 1 = bf16): out[0] threads a block, out[1] dynamic shared memory bytes,
// out[2] q rows a block, out[3] kv rows a tile. Touches no device.
extern "C" int flash_attention_plan(int hd, int dtype, int* out) {
  if (dtype == 0) return plan_hd<float>(hd, out);
  if (dtype == 1) return plan_hd<__nv_bfloat16>(hd, out);
  return -2;
}

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
