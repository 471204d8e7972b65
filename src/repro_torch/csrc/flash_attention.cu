// FlashAttention forward and two-pass backward for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_pallas (_kernel)
// and, for the gradient, the blockwise backward that the JAX package pairs
// with it (repro/kernels/ref.py::_flash_bwd).
//
// q (B, S, H, D) attends k/v (B, Sk, Hkv, D); query head h reads kv head
// h / (H / Hkv) (GQA; MQA at Hkv = 1).  All arithmetic is f32 over f32 or
// bf16 storage, as in the Pallas kernel: scores of q * scale against k,
// masked to -1e30 where a causal query precedes its key (qpos >= kpos), an
// online softmax (m, l, acc), out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)) (B, H, S) saved for the backward.
//
// Kernels:
//   fwd_kernel    one CTA per (q tile of 64, head, batch): streams 64-key
//                 K and V tiles through shared memory; a causal tile skips
//                 the key tiles above its diagonal.
//   delta_kernel  Delta = rowsum(dO * O) in f32, one warp per row.
//   dq_kernel     one CTA per (q tile of 64, head, batch): recomputes
//                 p = exp(s - lse), dp = dO V^T, ds = p (dp - Delta) scale,
//                 dq += ds K over the key tiles (the reference's pass 1).
//   dkdv_kernel   one CTA of 256 threads per (key tile of 64, kv head,
//                 batch): loops over the G query heads of its kv head and
//                 their q tiles, dv += p^T dO, dk += ds^T q (pass 2).  The
//                 G heads are summed inside the CTA: no atomics across CTAs.
//
// What bounds it: operations.  At the training shape (S 4096, d 128) the
// causal forward does ~2 S^2 d flops per head against ~4 S d bytes: far
// above the card's balance point.  This first version computes on the
// scalar f32 pipes with fused multiply-adds (f32 inputs must hold 2e-5
// against the plain version, so no TF32), with register tiles of 4 x 8
// (2 x 8 in dk/dv) scores per thread over shared-memory tiles stored
// transposed with an odd leading dimension, so that both orientations read
// without bank conflicts; tiles arrive with 16-byte loads.  Tensor cores (mma/wgmma for bf16), TMA and pipelined loads
// are left for a later change.  Tails are masked: S and Sk need not be
// multiples of a tile; loads past the end are zero-filled, so padding can
// never inject a NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr int kThreads = 128;
constexpr int kTX = 8;                  // column groups of a thread tile
constexpr int kTY = kThreads / kTX;     // row groups
constexpr int kBQ = 64;                 // query rows of a tile
constexpr int kBK = 64;                 // keys of a forward / dq tile
constexpr int kBKV = 64;                // keys of a dk/dv CTA
constexpr int kKVThreads = 256;         // threads of a dk/dv CTA
constexpr int kKVTY = kKVThreads / kTX; // its row groups
constexpr int kLQ = kBQ + 1;            // odd leading dimensions
constexpr int kLK = kBK + 1;
constexpr int kLKV = kBKV + 1;
constexpr int kLP = kBQ + 4;            // p / ds tiles, [key][query]
constexpr int kLPT = kBKV + 4;          // p^T / ds^T tiles, [query][key]

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// 16-byte global loads widened to f32.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Rows [r0, r0 + ROWS) of one head of a (B, S, Hx, D) tensor, transposed
// into dst[e * ld + r] as f32 times ``mul``; rows at or past S read 0.
// ``src`` points at (b, 0, hx, 0); row t starts at src + t * stride.
// Each thread moves 16 bytes a load (rows are 16-byte aligned: D is a
// multiple of 8 and the wrapper checks the base pointers).
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_t(float* dst, int ld, const T* src,
                                       int r0, int S, size_t stride,
                                       float mul) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kPerRow = D / kVec;
  static_assert(D % kVec == 0, "rows split into whole 16-byte vectors");
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int e0 = (i % kPerRow) * kVec;
    const int t = r0 + r;
    float f[kVec];
    if (t < S) {
      Io<T>::load(src + static_cast<size_t>(t) * stride + e0, f);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[(e0 + j) * ld + r] = f[j] * mul;
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (D * kLQ + D * kLK + kBK * kLP);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * D * kLQ + D * kLK + kBK * kLP);
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * D * kLKV + 2 * D * kLQ + 2 * kBQ * kLPT + 2 * kBQ);
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, int S, int Sk, int H, int Hkv, int causal,
           float scale) {
  constexpr int R = kBQ / kTY;   // query rows of a thread
  constexpr int C = kBK / kTX;   // keys of a thread
  constexpr int CD = D / kTX;    // output columns of a thread
  extern __shared__ float smem[];
  float* Qt = smem;                 // [D][kLQ]  q * scale, transposed
  float* KVt = Qt + D * kLQ;        // [D][kLK]  K, then V, transposed
  float* Ps = KVt + D * kLK;        // [kBK][kLP] probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const T* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * ks + kvh * D;

  load_t<T, D, kBQ, kThreads>(Qt, kLQ, q + static_cast<size_t>(b) * S * qs + h * D, q0,
                    S, qs, scale);

  float acc[R][CD], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, min(q0 + kBQ, S)) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's P.V is done with KVt and Ps
    load_t<T, D, kBK, kThreads>(KVt, kLK, kb, k0, Sk, ks, 1.0f);
    __syncthreads();
    float s[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[R], bk[C];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = Qt[e * kLQ + ty + kTY * r];
#pragma unroll
      for (int c = 0; c < C; ++c) bk[c] = KVt[e * kLK + tx + kTX * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }
    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + ty + kTY * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = k0 + tx + kTX * c;
        if (j >= Sk || (causal && i < j)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max8(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        Ps[(tx + kTX * c) * kLP + ty + kTY * r] = p;
      }
      l[r] = l[r] * alpha + row_sum8(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();   // every thread is done reading K; Ps is complete
    load_t<T, D, kBK, kThreads>(KVt, kLK, vb, k0, Sk, ks, 1.0f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = Ps[j * kLP + ty + kTY * r];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float vv = KVt[(tx + kTX * c) * kLK + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty + kTY * r;
    if (i >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * S + i) * qs + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[tx + kTX * c] = from_f<T>(acc[r][c] / lc);
    if (tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + i] = m[r] + logf(lc);
  }
}

// ----------------------------------------------------------------- delta

// Delta[b, h, s] = sum_e dO[b, s, h, e] * O[b, s, h, e]; one warp a row.
template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ out,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, long rows, int S,
                             int H) {
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // whole warps leave together
  const T* o = out + row * D;
  const T* d = dout + row * D;
  float acc = 0.0f;
  for (int e = lane; e < D; e += 32) acc = fmaf(to_f(d[e]), to_f(o[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long b = row / (static_cast<long>(S) * H);
    const long rem = row % (static_cast<long>(S) * H);
    const long s = rem / H;
    const long h = rem % H;
    delta[(b * H + h) * S + s] = acc;
  }
}

// -------------------------------------------------------------------- dq

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int Sk, int H, int Hkv, int causal,
          float scale) {
  constexpr int R = kBQ / kTY;
  constexpr int C = kBK / kTX;
  constexpr int CD = D / kTX;
  extern __shared__ float smem[];
  float* Qt = smem;                 // [D][kLQ]  q * scale
  float* dOt = Qt + D * kLQ;        // [D][kLQ]  dO
  float* KVt = dOt + D * kLQ;       // [D][kLK]  V, then K
  float* dSs = KVt + D * kLK;       // [kBK][kLP] ds

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
  const T* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * ks + kvh * D;

  load_t<T, D, kBQ, kThreads>(Qt, kLQ, q + qoff, q0, S, qs, scale);
  load_t<T, D, kBQ, kThreads>(dOt, kLQ, dout + qoff, q0, S, qs, 1.0f);
  float lse_r[R], dl_r[R], acc[R][CD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty + kTY * r;
    const size_t row = (static_cast<size_t>(b) * H + h) * S + i;
    lse_r[r] = i < S ? lse[row] : 0.0f;
    dl_r[r] = i < S ? delta[row] : 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, min(q0 + kBQ, S)) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's ds.K is done with KVt and dSs
    load_t<T, D, kBK, kThreads>(KVt, kLK, vb, k0, Sk, ks, 1.0f);
    __syncthreads();
    float dp[R][C], s[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) dp[r][c] = s[r][c] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[R], bv[C];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = dOt[e * kLQ + ty + kTY * r];
#pragma unroll
      for (int c = 0; c < C; ++c) bv[c] = KVt[e * kLK + tx + kTX * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) dp[r][c] = fmaf(a[r], bv[c], dp[r][c]);
    }
    __syncthreads();   // every thread is done reading V
    load_t<T, D, kBK, kThreads>(KVt, kLK, kb, k0, Sk, ks, 1.0f);
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[R], bk[C];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = Qt[e * kLQ + ty + kTY * r];
#pragma unroll
      for (int c = 0; c < C; ++c) bk[c] = KVt[e * kLK + tx + kTX * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + ty + kTY * r;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = k0 + tx + kTX * c;
        const bool live = i < S && j < Sk && !(causal && i < j);
        const float p = live ? expf(s[r][c] - lse_r[r]) : 0.0f;
        dSs[(tx + kTX * c) * kLP + ty + kTY * r] =
            p * (dp[r][c] - dl_r[r]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ds[r] = dSs[j * kLP + ty + kTY * r];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = KVt[(tx + kTX * c) * kLK + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][c] = fmaf(ds[r], kv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty + kTY * r;
    if (i >= S) continue;
    T* o = dq + (static_cast<size_t>(b) * S + i) * qs + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[tx + kTX * c] = from_f<T>(acc[r][c]);
  }
}

// ------------------------------------------------------------------ dk/dv

template <typename T, int D>
__global__ void __launch_bounds__(kKVThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int H,
            int Hkv, int causal, float scale) {
  constexpr int R = kBKV / kKVTY;  // keys of a thread
  constexpr int C = kBQ / kTX;   // query rows of a thread
  constexpr int CD = D / kTX;
  extern __shared__ float smem[];
  float* Kt = smem;                 // [D][kLKV]
  float* Vt = Kt + D * kLKV;        // [D][kLKV]
  float* Qt = Vt + D * kLKV;        // [D][kLQ]  q (unscaled)
  float* dOt = Qt + D * kLQ;        // [D][kLQ]
  float* Pt = dOt + D * kLQ;        // [kBQ][kLPT]  p^T
  float* dSt = Pt + kBQ * kLPT;     // [kBQ][kLPT]  ds^T
  float* lse_s = dSt + kBQ * kLPT;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int k0 = blockIdx.x * kBKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = static_cast<size_t>(b) * Sk * ks + kvh * D;

  load_t<T, D, kBKV, kKVThreads>(Kt, kLKV, k + koff, k0, Sk, ks, 1.0f);
  load_t<T, D, kBKV, kKVThreads>(Vt, kLKV, v + koff, k0, Sk, ks, 1.0f);
  float dka[R][CD], dva[R][CD];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[r][c] = dva[r][c] = 0.0f;

  const int q_lo = causal ? (k0 / kBQ) * kBQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
    const size_t roff = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = q_lo; q0 < S; q0 += kBQ) {
      __syncthreads();   // the previous tile is done with Qt, dOt, Pt, dSt
      load_t<T, D, kBQ, kKVThreads>(Qt, kLQ, q + qoff, q0, S, qs, 1.0f);
      load_t<T, D, kBQ, kKVThreads>(dOt, kLQ, dout + qoff, q0, S, qs, 1.0f);
      for (int i = threadIdx.x; i < kBQ; i += kKVThreads) {
        lse_s[i] = q0 + i < S ? lse[roff + q0 + i] : 0.0f;
        dl_s[i] = q0 + i < S ? delta[roff + q0 + i] : 0.0f;
      }
      __syncthreads();
      float st[R][C], dpt[R][C];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) st[r][c] = dpt[r][c] = 0.0f;
#pragma unroll 4
      for (int e = 0; e < D; ++e) {
        float kk[R], vv[R], qq[C], dd[C];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          kk[r] = Kt[e * kLKV + ty + kKVTY * r];
          vv[r] = Vt[e * kLKV + ty + kKVTY * r];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qq[c] = Qt[e * kLQ + tx + kTX * c];
          dd[c] = dOt[e * kLQ + tx + kTX * c];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            st[r][c] = fmaf(kk[r], qq[c], st[r][c]);
            dpt[r][c] = fmaf(vv[r], dd[c], dpt[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = k0 + ty + kKVTY * r;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int il = tx + kTX * c;
          const int i = q0 + il;
          const bool live = i < S && j < Sk && !(causal && i < j);
          const float p = live ? expf(st[r][c] * scale - lse_s[il]) : 0.0f;
          Pt[il * kLPT + ty + kKVTY * r] = p;
          dSt[il * kLPT + ty + kKVTY * r] = p * (dpt[r][c] - dl_s[il]) * scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float p[R], ds[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          p[r] = Pt[i * kLPT + ty + kKVTY * r];
          ds[r] = dSt[i * kLPT + ty + kKVTY * r];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float dov = dOt[(tx + kTX * c) * kLQ + i];
          const float qv = Qt[(tx + kTX * c) * kLQ + i];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dva[r][c] = fmaf(p[r], dov, dva[r][c]);
            dka[r][c] = fmaf(ds[r], qv, dka[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = k0 + ty + kKVTY * r;
    if (j >= Sk) continue;
    const size_t row = (static_cast<size_t>(b) * Sk + j) * ks + kvh * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[row + tx + kTX * c] = from_f<T>(dka[r][c]);
      dv[row + tx + kTX * c] = from_f<T>(dva[r][c]);
    }
  }
}

// -------------------------------------------------------------- launchers

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int Sk, int H, int Hkv, int causal,
                float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(fwd_kernel<T, D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, Sk, H, Hkv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int S, int Sk, int H, int Hkv,
                int causal, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long rows = static_cast<long>(B) * S * H;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const T*>(out), dot, delta, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<T, D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, dq_smem<D>(),
                    stream>>>(qt, kt, vt, dot, lse, delta,
                              static_cast<T*>(dq), S, Sk, H, Hkv, causal,
                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_kernel<T, D>, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, D><<<dim3((Sk + kBKV - 1) / kBKV, Hkv, B), kKVThreads,
                      dkdv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

#define FLASH_BY_DIM(FN, T, ...)                 \
  switch (D) {                                   \
    case 32: return FN<T, 32>(__VA_ARGS__);      \
    case 64: return FN<T, 64>(__VA_ARGS__);      \
    case 80: return FN<T, 80>(__VA_ARGS__);      \
    case 128: return FN<T, 128>(__VA_ARGS__);    \
    default: return cudaErrorInvalidValue;       \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, S, H, D), k/v (B, Sk, Hkv, D),
// lse (B, H, S) f32; all contiguous.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int Sk, int H,
                         int Hkv, int D, int dtype, int causal, float scale,
                         void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_BY_DIM(fwd, float, q, k, v, out, lse, B, S, Sk, H, Hkv, causal,
                 scale, s)
  }
  if (dtype == 1) {
    FLASH_BY_DIM(fwd, __nv_bfloat16, q, k, v, out, lse, B, S, Sk, H, Hkv,
                 causal, scale, s)
  }
  return cudaErrorInvalidValue;
}

// delta: (B, H, S) f32 scratch.  dq like q, dk/dv like k/v.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int S, int Sk, int H, int Hkv, int D, int dtype,
                         int causal, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_BY_DIM(bwd, float, q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                 Sk, H, Hkv, causal, scale, s)
  }
  if (dtype == 1) {
    FLASH_BY_DIM(bwd, __nv_bfloat16, q, k, v, out, dout, lse, delta, dq, dk,
                 dv, B, S, Sk, H, Hkv, causal, scale, s)
  }
  return cudaErrorInvalidValue;
}
