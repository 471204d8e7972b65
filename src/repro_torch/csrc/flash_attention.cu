// FlashAttention forward and two-pass backward for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_pallas (_kernel)
// and, for the gradient, the blockwise backward that the JAX package pairs
// with it (repro/kernels/ref.py::_flash_bwd).
//
// q (B, S, H, D) attends k/v (B, Sk, Hkv, D); query head h reads kv head
// h / (H / Hkv) (GQA; MQA at Hkv = 1).  As in the Pallas kernel: scores of
// q.k times scale in f32, masked where a causal query precedes its key
// (qpos >= kpos, also when S != Sk), an f32 online softmax (m, l, acc),
// out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (B, H, S) f32
// saved for the backward.  Any S and Sk: tails are masked, and rows read
// past the end arrive as zeros, so padding never injects a NaN.
//
// What bounds it: operations.  At the training shape (S 4096, d 128) the
// causal forward does ~2 S^2 d flops per head against ~4 S d bytes, far
// above the card's balance point, so the products belong on the tensor
// cores.  Which dtype takes which kernel:
//
// bf16 (every caller on the card: training, Jamba prefill):
//   fwd_wgmma_kernel  one CTA per (128 query rows, head, batch): two
//                 consumer warpgroups of 64 rows and a producer warpgroup
//                 that hands its registers to them (setmaxnreg).
//                 The producer streams the Q tile and a 2-stage ring of
//                 128-key K and V tiles by TMA (4-D tensor maps over (d,
//                 heads, rows, batch), boxes of 64 columns x 128 rows in the
//                 128-byte swizzle, rows past S / Sk and columns past d
//                 zero-filled; d 32 and 80 run padded to 64 and 128), with
//                 full/empty mbarrier pairs.  Each consumer computes
//                 S = Q K^T by wgmma m64n128k16 with both operands in shared
//                 memory, the online softmax on the accumulator fragments
//                 (exp2 with scale * log2(e) folded in, row reductions over
//                 the 4 lanes of a row), and O += P V by wgmma with P in
//                 registers (the accumulator's fragment is the A operand's)
//                 and V read MN-major in place.  Key tiles above the
//                 diagonal are never loaded; only diagonal and tail tiles
//                 pay for the mask.
//   dq_mma_kernel one CTA of 4 warps per (64 query rows, head, batch),
//                 16 rows a warp: recomputes s = q k^T and dp = dO v^T by
//                 mma.sync m16n8k16 from ldmatrix fragments, p = exp(s*scale
//                 - lse), ds = p (dp - Delta) scale, and dq += ds k with ds
//                 in registers and k read through ldmatrix.trans.  K and V
//                 tiles of 64 keys stream through a 2-stage cp.async ring.
//   dkdv_mma_kernel one CTA of 4 warps per (64 keys, kv head, batch), 16
//                 keys a warp, looping over the G query heads of its kv head
//                 and their 64-row q tiles (a 2-stage cp.async ring of Q,
//                 dO, lse and Delta): computes s^T = k q^T and dp^T = v dO^T
//                 directly in the keys-by-queries orientation, so p^T and
//                 ds^T are already the A operands of dv += p^T dO and
//                 dk += ds^T q (in registers; q and dO through
//                 ldmatrix.trans).  No transposed copy is kept and the G
//                 heads are summed inside the CTA: no atomics.
//   All three grids put the heads innermost and the heaviest causal tiles
//   first, so the short tiles fill the tail.  Products add in f32, and the
//   scale is applied to the f32 scores, never to bf16 q.  P and dS enter
//   their products (P V, dS k, P^T dO, dS^T q) as two bf16 halves,
//   hi = bf16(x) and lo = bf16(x - hi), one MMA each: rounded once to bf16,
//   as a bf16 library kernel does, the early causal rows' gradients miss
//   the per-element bar of the plain version at S 1000 (on the card and
//   in tests/test_torch_flash_attention.py's emulation), and their outputs
//   at S 4096, while hi + lo keeps ~16 bits.  That costs 1.5x the
//   forward's tensor-core work and 1.4x the backward's.
//
// f32 (the parity phases and tests; tensor cores would mean TF32, whose
// 10-bit mantissa cannot hold 2e-5 against the plain version):
//   fwd_kernel, dq_kernel, dkdv_kernel  the first design: scalar f32 FMAs
//                 over register tiles of 4 x 8 (2 x 8 in dk/dv) scores a
//                 thread, shared-memory tiles stored transposed with an odd
//                 leading dimension, 64-row / 64-key tiles, 16-byte loads.
//   delta_kernel  Delta = rowsum(dO * O) in f32, one warp per row; both
//                 dtypes use it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ===================================================== f32: scalar kernels


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

// Rows [r0, r0 + ROWS) of one head of a (B, S, Hx, D) tensor, transposed
// into dst[e * ld + r] as f32 times ``mul``; rows at or past S read 0.
// ``src`` points at (b, 0, hx, 0); row t starts at src + t * stride.
// Each thread moves 16 bytes a load (rows are 16-byte aligned: D is a
// multiple of 8 and the wrapper checks the base pointers).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_t(float* dst, int ld, const float* src,
                                       int r0, int S, size_t stride,
                                       float mul) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  static_assert(D % kVec == 0, "rows split into whole 16-byte vectors");
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int e0 = (i % kPerRow) * kVec;
    const int t = r0 + r;
    const float4 f =
        t < S ? *reinterpret_cast<const float4*>(
                    src + static_cast<size_t>(t) * stride + e0)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[e0 * ld + r] = f.x * mul;
    dst[(e0 + 1) * ld + r] = f.y * mul;
    dst[(e0 + 2) * ld + r] = f.z * mul;
    dst[(e0 + 3) * ld + r] = f.w * mul;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
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
  const float* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * D;
  const float* vb = v + static_cast<size_t>(b) * Sk * ks + kvh * D;

  load_t<D, kBQ, kThreads>(Qt, kLQ, q + static_cast<size_t>(b) * S * qs + h * D, q0,
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
    load_t<D, kBK, kThreads>(KVt, kLK, kb, k0, Sk, ks, 1.0f);
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
    load_t<D, kBK, kThreads>(KVt, kLK, vb, k0, Sk, ks, 1.0f);
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
    float* o = out + (static_cast<size_t>(b) * S + i) * qs + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[tx + kTX * c] = acc[r][c] / lc;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int Sk, int H, int Hkv, int causal,
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
  const float* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * D;
  const float* vb = v + static_cast<size_t>(b) * Sk * ks + kvh * D;

  load_t<D, kBQ, kThreads>(Qt, kLQ, q + qoff, q0, S, qs, scale);
  load_t<D, kBQ, kThreads>(dOt, kLQ, dout + qoff, q0, S, qs, 1.0f);
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
    load_t<D, kBK, kThreads>(KVt, kLK, vb, k0, Sk, ks, 1.0f);
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
    load_t<D, kBK, kThreads>(KVt, kLK, kb, k0, Sk, ks, 1.0f);
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
    float* o = dq + (static_cast<size_t>(b) * S + i) * qs + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[tx + kTX * c] = acc[r][c];
  }
}

// ------------------------------------------------------------------ dk/dv

template <int D>
__global__ void __launch_bounds__(kKVThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int Sk,
            int H,
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

  load_t<D, kBKV, kKVThreads>(Kt, kLKV, k + koff, k0, Sk, ks, 1.0f);
  load_t<D, kBKV, kKVThreads>(Vt, kLKV, v + koff, k0, Sk, ks, 1.0f);
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
      load_t<D, kBQ, kKVThreads>(Qt, kLQ, q + qoff, q0, S, qs, 1.0f);
      load_t<D, kBQ, kKVThreads>(dOt, kLQ, dout + qoff, q0, S, qs, 1.0f);
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
      dk[row + tx + kTX * c] = dka[r][c];
      dv[row + tx + kTX * c] = dva[r][c];
    }
  }
}

// ================================================ bf16: forward, wgmma + TMA

constexpr int kFwdRows = 128;     // query rows of a CTA: 2 warpgroups of 64
constexpr int kFwdKeys = 128;     // keys of a K / V tile
constexpr int kFwdStages = 2;
constexpr int kFwdConsumers = 256;
// + a producer warpgroup, of which one thread issues the loads: a whole
// warpgroup, so that its registers can go to the consumers (setmaxnreg:
// 384 threads start at 168 registers; 40 + 2 x 232 fit the SM's 64 K)
constexpr int kFwdThreads = kFwdConsumers + 128;
constexpr uint32_t kProducerRegs = 40;
constexpr uint32_t kConsumerRegs = 232;
constexpr int kBoxCols = 64;      // bf16 columns of a box: one 128-byte row
constexpr uint32_t kBoxBytes = kFwdKeys * kBoxCols * 2;   // 16 KB, 128 rows
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the forward, 1024-aligned: tiles of 128 rows x 64
// columns (one TMA box each), NB of them across the padded head dim.
template <int NB>
struct FwdSmem {
  bf16 q[NB][kFwdRows * kBoxCols];
  bf16 k[kFwdStages][NB][kFwdKeys * kBoxCols];
  bf16 v[kFwdStages][NB][kFwdKeys * kBoxCols];
  uint64_t q_full, k_full[kFwdStages], v_full[kFwdStages], empty[kFwdStages];
};

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t* a,
                                              uint64_t db) {
  hopper::wgmma_m64n128k16_rs(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a,
                                             uint64_t db) {
  hopper::wgmma_m64n64k16_rs(o, a, db);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragments (wgmma m64nN and mma m16n8 alike): a thread's
// element i of a warp's 16 rows lies in row g + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * t + i % 2, g = lane / 4 and t = lane % 4.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int Sk, int H, int Hkv, int causal, float scale) {
  constexpr int DP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  constexpr int NB = DP / kBoxCols;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023;
  FwdSmem<NB>& sm = *reinterpret_cast<FwdSmem<NB>*>(smem_raw + pad);

  const int h = blockIdx.x;   // heads vary fastest: heavy tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int k_end = causal ? min(Sk, min(q0 + kFwdRows, S)) : Sk;
  const int n_tiles = (k_end + kFwdKeys - 1) / kFwdKeys;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.empty[s], kFwdConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kFwdConsumers) {   // the producer warpgroup; one thread issues
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kFwdConsumers) {
      hopper::mbar_expect_tx(&sm.q_full, NB * kBoxBytes);
      for (int c = 0; c < NB; ++c)
        hopper::tma_load_4d(sm.q[c], &tq, &sm.q_full, c * kBoxCols, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kFwdStages;
        const uint32_t ph = (it / kFwdStages) & 1;
        hopper::mbar_wait(&sm.empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&sm.k_full[st], NB * kBoxBytes);
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(sm.k[st][c], &tk, &sm.k_full[st], c * kBoxCols,
                              kvh, it * kFwdKeys, b);
        hopper::mbar_expect_tx(&sm.v_full[st], NB * kBoxBytes);
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(sm.v[st][c], &tv, &sm.v_full[st], c * kBoxCols,
                              kvh, it * kFwdKeys, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row0 = q0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int t2 = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;
  float o[DP / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;

  hopper::mbar_wait(&sm.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kFwdStages;
    const uint32_t ph = (it / kFwdStages) & 1;
    const int k0 = it * kFwdKeys;
    hopper::mbar_wait(&sm.k_full[st], ph);

    // S = Q K^T: 64 rows x 128 keys, DP / 16 steps of k16
    float s[64];
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* qa = sm.q[kk / 4] + wg * 64 * kBoxCols + (kk % 4) * 16;
      const bf16* kb = sm.k[st][kk / 4] + (kk % 4) * 16;
      hopper::wgmma_m64n128k16_ss(s, hopper::desc_sw128(qa, 16, 1024),
                                  hopper::desc_sw128(kb, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // mask: the Sk tail (zero-filled keys score 0, not -inf) and the
    // causal diagonal, on the tiles that reach them
    if (k0 + kFwdKeys > Sk || (causal && k0 + kFwdKeys - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + 8 * (i / 4) + t2 + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (col >= Sk || (causal && row < col)) s[i] = -INFINITY;
      }
    }
    // online softmax on the fragments, in f32
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float ms[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      ms[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * sl2;
      alpha[r] = exp2f(fmaf(m[r], sl2, -ms[r]));   // 0 while m is -inf
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    // P as bf16 pairs hi + lo: p_hi[4 kk .. 4 kk + 3] is key slice kk
    uint32_t p_hi[32], p_lo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i % 2;
      const float a = exp2f(fmaf(s[2 * i], sl2, -ms[r]));
      const float c = exp2f(fmaf(s[2 * i + 1], sl2, -ms[r]));
      l[r] += a + c;
      hopper::split_bf16(a, c, p_hi[i], p_lo[i]);
    }

    // O += P V = P_hi V + P_lo V: 8 steps of 16 keys; V MN-major (d
    // contiguous), 64-column blocks 16 KB apart, groups of 8 keys 1024
    // bytes apart
    hopper::mbar_wait(&sm.v_full[st], ph);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
      const uint64_t dv = hopper::desc_sw128(
          sm.v[st][0] + kk * 16 * kBoxCols, kBoxBytes, 1024);
      wgmma_pv<DP>(o, p_hi + 4 * kk, dv);
      wgmma_pv<DP>(o, p_lo + 4 * kk, dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    const float inv = 1.0f / lc;
    bf16* dst = out + (static_cast<size_t>(b) * S + row) * H * D +
                static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + t2) =
          hopper::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t2 == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + row] = m[r] * scale + logf(lc);
  }
}

// ============================================ bf16: backward, mma + cp.async

constexpr int kBwdThreads = 128;   // 4 warps of 16 rows
constexpr int kBwdRows = 64;       // q rows (dq) or keys (dk/dv) of a CTA
constexpr int kBwdCols = 64;       // keys (dq) or q rows (dk/dv) of a tile

// Rows [r0, r0 + 64) of one head of a (B, S, Hx, D) bf16 tensor into
// dst[64][D + 8] by 16-byte cp.async; rows at or past S are zero-filled.
// ``src`` points at (b, 0, hx, 0), ``stride`` elements a row.
template <int D>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int r0,
                                        int S, size_t stride) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBwdCols * kChunks; i += kBwdThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool in = r0 + r < S;
    hopper::cp_async16(dst + r * (D + 8) + c,
                       in ? src + static_cast<size_t>(r0 + r) * stride + c
                          : src,
                       in ? 16 : 0);
  }
}

using hopper::ldsm_a;
using hopper::ldsm_b;
using hopper::ldsm_bt;

// c[8][4] (16 rows x 64) = A (16 rows of ``at``) * B^T (64 rows of ``bt``)
// over the D columns of both.
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[8][4], const bf16* at,
                                         int arow, const bf16* bt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_a<LD>(a, at, arow, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_b<LD>(b, bt, 16 * np, 16 * kk, lane);
      hopper::mma_16816(c[2 * np], a, b[0], b[1]);
      hopper::mma_16816(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[D / 8][4] (16 rows x D) += X (16 x 64 f32 fragments, split into
// bf16 hi + lo) * Y (the 64 x D rows of ``y``).
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4],
                                        const float (&x)[8][4], const bf16* y,
                                        int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)   // r: (row g, g + 8) x (keys 0-7, 8-15)
      hopper::split_bf16(x[2 * kc + r / 2][2 * (r % 2)],
                         x[2 * kc + r / 2][2 * (r % 2) + 1], hi[r], lo[r]);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_bt<LD>(b, y, 16 * kc, 16 * nd, lane);
      hopper::mma_16816(acc[2 * nd], hi, b[0], b[1]);
      hopper::mma_16816(acc[2 * nd], lo, b[0], b[1]);
      hopper::mma_16816(acc[2 * nd + 1], hi, b[2], b[3]);
      hopper::mma_16816(acc[2 * nd + 1], lo, b[2], b[3]);
    }
  }
}

// Rows of a warp's accumulator to a (.., Hx, D) bf16 tensor; rows at or
// past ``n`` are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float (&acc)[D / 8][4],
                                           int row0, int n, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          hopper::pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D>
constexpr size_t mma_smem() {   // 6 tiles of [64][D + 8] bf16 + lse, Delta
  return 6 * kBwdRows * (D + 8) * sizeof(bf16) + 4 * kBwdCols * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int Sk, int H, int Hkv, int causal,
              float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* dOs = Qs + kBwdRows * LD;                 // [64][LD]
  bf16* Ks = dOs + kBwdRows * LD;                 // [2][64][LD]
  bf16* Vs = Ks + 2 * kBwdCols * LD;              // [2][64][LD]

  const int h = blockIdx.x;   // heads vary fastest: heavy tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * D;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * ks + kvh * D;
  const int k_end = causal ? min(Sk, min(q0 + kBwdRows, S)) : Sk;
  const int n_tiles = (k_end + kBwdCols - 1) / kBwdCols;

  cp_rows<D>(Qs, q + qoff, q0, S, qs);
  cp_rows<D>(dOs, dout + qoff, q0, S, qs);
  cp_rows<D>(Ks, kb, 0, Sk, ks);
  cp_rows<D>(Vs, vb, 0, Sk, ks);
  hopper::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * S + row;
    lse2[r] = row < S ? lse[at] * kLog2e : 0.0f;
    dl[r] = row < S ? delta[at] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % 2;
    if (it + 1 < n_tiles) {
      const int next = (it + 1) * kBwdCols;
      cp_rows<D>(Ks + (st ^ 1) * kBwdCols * LD, kb, next, Sk, ks);
      cp_rows<D>(Vs + (st ^ 1) * kBwdCols * LD, vb, next, Sk, ks);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * kBwdCols * LD;
    const bf16* Vt = Vs + st * kBwdCols * LD;
    float s[8][4], dp[8][4];
    mma_rows<D>(s, Qs, 16 * warp, Kt, lane);
    mma_rows<D>(dp, dOs, 16 * warp, Vt, lane);
    const int k0 = it * kBwdCols;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + 16 * warp + lane / 4 + 8 * (e / 2);
        const int col = k0 + 8 * j + 2 * (lane % 4) + e % 2;
        const bool live = row < S && col < Sk && !(causal && row < col);
        const float p = live ? exp2f(fmaf(s[j][e], sl2, -lse2[e / 2])) : 0.0f;
        s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;   // ds
      }
    mma_acc<D>(acc, s, Kt, lane);
    __syncthreads();   // the stage is read; the next prefetch may overwrite
  }
  store_rows<D>(dq + qoff, qs, acc, q0 + 16 * warp, S, lane);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Sk,
                int H, int Hkv, int causal, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* Vs = Ks + kBwdRows * LD;                  // [64][LD]
  bf16* Qs = Vs + kBwdRows * LD;                  // [2][64][LD]
  bf16* dOs = Qs + 2 * kBwdCols * LD;             // [2][64][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBwdCols * LD);   // [2][64]
  float* Ds = Ls + 2 * kBwdCols;                                   // [2][64]

  const int kvh = blockIdx.x;   // kv heads vary fastest: heavy tiles first
  const int k0 = blockIdx.y * kBwdRows;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = static_cast<size_t>(b) * Sk * ks + kvh * D;
  const int q_lo = causal ? k0 / kBwdCols * kBwdCols : 0;
  const int nq = q_lo < S ? (S - q_lo + kBwdCols - 1) / kBwdCols : 0;
  const int total = G * nq;

  // item n: query head kvh * G + n / nq, q rows q_lo + (n % nq) * 64
  auto issue = [&](int n, int st) {
    const int h = kvh * G + n / nq;
    const int q0 = q_lo + (n % nq) * kBwdCols;
    const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
    cp_rows<D>(Qs + st * kBwdCols * LD, q + qoff, q0, S, qs);
    cp_rows<D>(dOs + st * kBwdCols * LD, dout + qoff, q0, S, qs);
    const size_t roff = (static_cast<size_t>(b) * H + h) * S;
    const int i = threadIdx.x % kBwdCols;
    const bool in = q0 + i < S;
    const float* src = threadIdx.x < kBwdCols ? lse : delta;
    float* dst = threadIdx.x < kBwdCols ? Ls : Ds;
    hopper::cp_async4(dst + st * kBwdCols + i, in ? src + roff + q0 + i : src,
                      in ? 4 : 0);
  };

  cp_rows<D>(Ks, k + koff, k0, Sk, ks);
  cp_rows<D>(Vs, v + koff, k0, Sk, ks);
  if (total > 0) issue(0, 0);
  hopper::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;

  for (int n = 0; n < total; ++n) {
    const int st = n % 2;
    if (n + 1 < total) {
      issue(n + 1, st ^ 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_lo + (n % nq) * kBwdCols;
    const bf16* Qt = Qs + st * kBwdCols * LD;
    const bf16* dOt = dOs + st * kBwdCols * LD;
    const float* Lt = Ls + st * kBwdCols;
    const float* Dt = Ds + st * kBwdCols;
    // s^T = k q^T: 16 keys of this warp x 64 queries; p^T in place
    float p[8][4];
    mma_rows<D>(p, Ks, 16 * warp, Qt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * (lane % 4) + e % 2;
        const int key = k0 + 16 * warp + lane / 4 + 8 * (e / 2);
        const bool live = q0 + il < S && key < Sk && !(causal && q0 + il < key);
        p[j][e] = live ? exp2f(fmaf(p[j][e], sl2, -Lt[il] * kLog2e)) : 0.0f;
      }
    mma_acc<D>(dva, p, dOt, lane);   // dv += p^T dO
    float ds[8][4];
    mma_rows<D>(ds, Vs, 16 * warp, dOt, lane);   // dp^T = v dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * (lane % 4) + e % 2;
        ds[j][e] = p[j][e] * (ds[j][e] - Dt[il]) * scale;
      }
    mma_acc<D>(dka, ds, Qt, lane);   // dk += ds^T q
    __syncthreads();   // the stage is read; the next prefetch may overwrite
  }
  hopper::cp_async_wait<0>();   // nothing in flight when the CTA leaves
  store_rows<D>(dk + koff, ks, dka, k0 + 16 * warp, Sk, lane);
  store_rows<D>(dv + koff, ks, dva, k0 + 16 * warp, Sk, lane);
}

// -------------------------------------------------------------- launchers

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int S, int Sk, int H, int Hkv,
                    int causal, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Sk, H,
      Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int B, int S,
                    int Sk, int H, int Hkv, int causal, float scale,
                    cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const long rows = static_cast<long>(B) * S * H;
  delta_kernel<float, D><<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                           stream>>>(static_cast<const float*>(out), dot,
                                     delta, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, dq_smem<D>(),
                    stream>>>(qt, kt, vt, dot, lse, delta,
                              static_cast<float*>(dq), S, Sk, H, Hkv, causal,
                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_kernel<D>, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3((Sk + kBKV - 1) / kBKV, Hkv, B), kKVThreads,
                      dkdv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, taken from the driver through the CUDA runtime
// (this library is not linked against libcuda).
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The forward's 4-D map over a contiguous (B, rows, heads, D) bf16 tensor,
// innermost dimension first: boxes of 64 columns x 1 head x 128 rows x 1
// batch, in the 128-byte swizzle, zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int rows,
                     int heads, int D) {
  static_assert(kFwdRows == kFwdKeys, "Q and K/V maps share one box");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * e, dims[1] * dims[0] * e,
                                 dims[2] * dims[1] * dims[0] * e};
  const cuuint32_t box[4] = {kBoxCols, 1, kFwdRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int Sk, int H, int Hkv,
                     int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, H, D);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Sk, Hkv, D);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Sk, Hkv, D);
  if (err != cudaSuccess) return err;
  constexpr size_t smem =
      sizeof(FwdSmem<(D + kBoxCols - 1) / kBoxCols>) + 1024;   // + alignment
  err = allow_smem(fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kFwdRows - 1) / kFwdRows, B);
  fwd_wgmma_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, S, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B, int S,
                     int Sk, int H, int Hkv, int causal, float scale,
                     cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const long rows = static_cast<long>(B) * S * H;
  delta_kernel<bf16, D><<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                          stream>>>(static_cast<const bf16*>(out), dot, delta,
                                    rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_mma_kernel<D>, mma_smem<D>());
  if (err != cudaSuccess) return err;
  dq_mma_kernel<D><<<dim3(H, (S + kBwdRows - 1) / kBwdRows, B), kBwdThreads,
                     mma_smem<D>(), stream>>>(qt, kt, vt, dot, lse, delta,
                                              static_cast<bf16*>(dq), S, Sk, H,
                                              Hkv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_mma_kernel<D>, mma_smem<D>());
  if (err != cudaSuccess) return err;
  dkdv_mma_kernel<D><<<dim3(Hkv, (Sk + kBwdRows - 1) / kBwdRows, B),
                       kBwdThreads, mma_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

// CALL(d) for the head dim D at run time.
#define FLASH_BY_DIM(CALL)        \
  switch (D) {                    \
    case 32: return CALL(32);     \
    case 64: return CALL(64);     \
    case 80: return CALL(80);     \
    case 128: return CALL(128);   \
    default: return cudaErrorInvalidValue; \
  }

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor-core kernels).
// q/out (B, S, H, D), k/v (B, Sk, Hkv, D), lse (B, H, S) f32; all
// contiguous and 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int Sk, int H,
                         int Hkv, int D, int dtype, int causal, float scale,
                         void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, out, lse, B, S, Sk, H, Hkv, causal, scale, s
#define FWD_F32(d) fwd_f32<d>(FWD_ARGS)
#define FWD_BF16(d) fwd_bf16<d>(FWD_ARGS)
  if (dtype == 0) FLASH_BY_DIM(FWD_F32)
  if (dtype == 1) FLASH_BY_DIM(FWD_BF16)
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
#define BWD_ARGS \
  q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, Sk, H, Hkv, causal, scale, s
#define BWD_F32(d) bwd_f32<d>(BWD_ARGS)
#define BWD_BF16(d) bwd_bf16<d>(BWD_ARGS)
  if (dtype == 0) FLASH_BY_DIM(BWD_F32)
  if (dtype == 1) FLASH_BY_DIM(BWD_BF16)
  return cudaErrorInvalidValue;
}
