// FlashAttention forward and two-pass backward for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_pallas (_kernel)
// and, for the gradient, the blockwise backward that the JAX package pairs
// with it (repro/kernels/ref.py::_flash_bwd).
//
// q (B, S, H, DK) attends k (B, Sk, Hkv, DK) and v (B, Sk, Hkv, DV); out
// is (B, S, H, DV).  The (DK, DV) pairs: (d, d) for d in 32, 64, 80, 128,
// 160, and MLA's (192, 128) (deepseek-v2: 128 + 64 rope columns of q and
// k, 128 of v), in both passes and both dtypes.  Query head h reads kv head
// h / (H / Hkv) (GQA; MQA at Hkv = 1).  As in the Pallas kernel, which
// reads dk from q and dv from v: scores of q.k times scale in f32, masked
// where a causal query precedes its key (qpos >= kpos, also when S != Sk),
// an f32 online softmax (m, l, acc), out = acc / max(l, 1e-30) and lse =
// m + log(max(l, 1e-30)) (B, H, S) f32 saved for the backward.  Any S and
// Sk: tails are masked, and rows read past the end arrive as zeros, so
// padding never injects a NaN.
//
// What bounds it: operations.  At the training shape (S 4096, d 128) the
// causal forward does ~2 S^2 d flops per head against ~4 S d bytes, far
// above the card's balance point, so the products belong on the tensor
// cores.  Which dtype takes which kernel:
//
// bf16 (every caller on the card: training, Jamba prefill, pixtral,
// deepseek-v2's MLA):
//   fwd_wgmma_kernel  one CTA per (128 query rows, head, batch): two
//                 consumer warpgroups of 64 rows and a producer warpgroup
//                 that hands its registers to them (setmaxnreg).
//                 The producer streams the Q tile and a 2-stage ring of
//                 128-key K and V tiles by TMA (4-D tensor maps over (d,
//                 heads, rows, batch), boxes of 64 columns x 128 rows in the
//                 128-byte swizzle, rows past S / Sk and columns past d
//                 zero-filled; d 32 and 80 run padded to 64 and 128; d 160
//                 in boxes of 32 columns in the 64-byte swizzle, FwdTile;
//                 MLA's q and k in three boxes, v in two), with full/empty
//                 mbarrier pairs.  Each consumer computes
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
//                 Above d 160 a tile is taken in two halves of 32 keys, one
//                 after the other: the 16 x dk accumulator (96 f32 at dk
//                 192) beside s and dp of 16 x 64 spilled (255 registers,
//                 44 bytes), and so did unrolled halves that ptxas
//                 interleaved (40 bytes).
//   dkdv_mma_kernel (d <= 128) one CTA of 4 warps per (64 keys, kv head,
//                 batch), 16 keys a warp, looping over the G query heads of
//                 its kv head and their 64-row q tiles (a 2-stage cp.async
//                 ring of Q, dO, lse and Delta): computes s^T = k q^T and
//                 dp^T = v dO^T directly in the keys-by-queries orientation,
//                 so p^T and ds^T are already the A operands of dv += p^T dO
//                 and dk += ds^T q (in registers; q and dO through
//                 ldmatrix.trans).  No transposed copy is kept and the G
//                 heads are summed inside the CTA: no atomics.  A warp holds
//                 both 16 x d accumulators, 128 f32 at d 128 beside p^T and
//                 ds^T: 255 registers there, so no wider d fits it.
//   dkdv_pair_kernel (d 160 and MLA's 192 / 128) the same
//                 CTA, ring and orientation with 8 warps, two to each 16-key
//                 slice, split by product: one computes s^T and p^T, hands
//                 p^T to its partner through shared memory (4 KB a slice)
//                 and sums dv += p^T dO; the partner computes dp^T
//                 meanwhile, waits on a named barrier, forms ds^T and sums
//                 dk += ds^T q.  Both take a q tile in two halves of 32
//                 queries, each handed over on a barrier of its own, so the
//                 partner starts on the first half while the other computes
//                 the second.  A thread holds one accumulator (at most 16 x
//                 192 f32) beside one 16 x 32 fragment (with 16 x 64 ones
//                 ptxas spilled at 192 / 128), no product is computed
//                 twice, and the G heads are still summed inside the CTA.
//                 One CTA an SM (143 KB of shared memory at 192 / 128 and at
//                 160).
//   All grids put the heads innermost and the heaviest causal tiles
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

__host__ __device__ constexpr int dmax(int a, int b) {
  return a > b ? a : b;
}

// q and k are DK wide, v and out DV; one K-then-V tile is max(DK, DV).
template <int DK, int DV>
constexpr size_t fwd_smem() {
  return sizeof(float) * (DK * kLQ + dmax(DK, DV) * kLK + kBK * kLP);
}
template <int DK, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * ((DK + DV) * kLQ + dmax(DK, DV) * kLK + kBK * kLP);
}
template <int DK, int DV>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         ((DK + DV) * kLKV + (DK + DV) * kLQ + 2 * kBQ * kLPT + 2 * kBQ);
}

// ---------------------------------------------------------------- forward

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int S, int Sk, int H, int Hkv, int causal,
           float scale) {
  constexpr int R = kBQ / kTY;   // query rows of a thread
  constexpr int C = kBK / kTX;   // keys of a thread
  constexpr int CD = DV / kTX;   // output columns of a thread
  extern __shared__ float smem[];
  float* Qt = smem;                 // [DK][kLQ]  q * scale, transposed
  float* KVt = Qt + DK * kLQ;       // [max(DK, DV)][kLK]  K, then V
  float* Ps = KVt + dmax(DK, DV) * kLK;   // [kBK][kLP] probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const size_t qs = static_cast<size_t>(H) * DK;
  const size_t os = static_cast<size_t>(H) * DV;
  const size_t ks = static_cast<size_t>(Hkv) * DK;
  const size_t vs = static_cast<size_t>(Hkv) * DV;
  const float* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * DK;
  const float* vb = v + static_cast<size_t>(b) * Sk * vs + kvh * DV;

  load_t<DK, kBQ, kThreads>(Qt, kLQ,
                            q + static_cast<size_t>(b) * S * qs + h * DK, q0,
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
    load_t<DK, kBK, kThreads>(KVt, kLK, kb, k0, Sk, ks, 1.0f);
    __syncthreads();
    float s[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < DK; ++e) {
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
    load_t<DV, kBK, kThreads>(KVt, kLK, vb, k0, Sk, vs, 1.0f);
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
    float* o = out + (static_cast<size_t>(b) * S + i) * os + h * DV;
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

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int Sk, int H, int Hkv, int causal,
          float scale) {
  constexpr int R = kBQ / kTY;
  constexpr int C = kBK / kTX;
  constexpr int CD = DK / kTX;
  extern __shared__ float smem[];
  float* Qt = smem;                 // [DK][kLQ]  q * scale
  float* dOt = Qt + DK * kLQ;       // [DV][kLQ]  dO
  float* KVt = dOt + DV * kLQ;      // [max(DK, DV)][kLK]  V, then K
  float* dSs = KVt + dmax(DK, DV) * kLK;   // [kBK][kLP] ds

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const size_t qs = static_cast<size_t>(H) * DK;
  const size_t os = static_cast<size_t>(H) * DV;
  const size_t ks = static_cast<size_t>(Hkv) * DK;
  const size_t vs = static_cast<size_t>(Hkv) * DV;
  const size_t qoff = static_cast<size_t>(b) * S * qs + h * DK;
  const size_t ooff = static_cast<size_t>(b) * S * os + h * DV;
  const float* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * DK;
  const float* vb = v + static_cast<size_t>(b) * Sk * vs + kvh * DV;

  load_t<DK, kBQ, kThreads>(Qt, kLQ, q + qoff, q0, S, qs, scale);
  load_t<DV, kBQ, kThreads>(dOt, kLQ, dout + ooff, q0, S, os, 1.0f);
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
    load_t<DV, kBK, kThreads>(KVt, kLK, vb, k0, Sk, vs, 1.0f);
    __syncthreads();
    float dp[R][C], s[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) dp[r][c] = s[r][c] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < DV; ++e) {
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
    load_t<DK, kBK, kThreads>(KVt, kLK, kb, k0, Sk, ks, 1.0f);
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < DK; ++e) {
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
    float* o = dq + (static_cast<size_t>(b) * S + i) * qs + h * DK;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[tx + kTX * c] = acc[r][c];
  }
}

// ------------------------------------------------------------------ dk/dv

// c[r][c] += sum_e a[e][ty + kKVTY r] b[e][tx + kTX c] over D rows of the
// transposed tiles ``a`` (ld kLKV) and ``b`` (ld kLQ): one of s^T or dp^T.
template <int D, int R, int C>
__device__ __forceinline__ void tile_dot(float (&c)[R][C], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float x[R], y[C];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = a[e * kLKV + ty + kKVTY * r];
#pragma unroll
    for (int j = 0; j < C; ++j) y[j] = b[e * kLQ + tx + kTX * j];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < C; ++j) c[r][j] = fmaf(x[r], y[j], c[r][j]);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kKVThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int Sk,
            int H,
            int Hkv, int causal, float scale) {
  constexpr int R = kBKV / kKVTY;  // keys of a thread
  constexpr int C = kBQ / kTX;   // query rows of a thread
  constexpr int CK = DK / kTX;
  constexpr int CV = DV / kTX;
  extern __shared__ float smem[];
  float* Kt = smem;                 // [DK][kLKV]
  float* Vt = Kt + DK * kLKV;       // [DV][kLKV]
  float* Qt = Vt + DV * kLKV;       // [DK][kLQ]  q (unscaled)
  float* dOt = Qt + DK * kLQ;       // [DV][kLQ]
  float* Pt = dOt + DV * kLQ;       // [kBQ][kLPT]  p^T
  float* dSt = Pt + kBQ * kLPT;     // [kBQ][kLPT]  ds^T
  float* lse_s = dSt + kBQ * kLPT;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int k0 = blockIdx.x * kBKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const size_t qs = static_cast<size_t>(H) * DK;
  const size_t os = static_cast<size_t>(H) * DV;
  const size_t ks = static_cast<size_t>(Hkv) * DK;
  const size_t vs = static_cast<size_t>(Hkv) * DV;
  const size_t koff = static_cast<size_t>(b) * Sk * ks + kvh * DK;
  const size_t voff = static_cast<size_t>(b) * Sk * vs + kvh * DV;

  load_t<DK, kBKV, kKVThreads>(Kt, kLKV, k + koff, k0, Sk, ks, 1.0f);
  load_t<DV, kBKV, kKVThreads>(Vt, kLKV, v + voff, k0, Sk, vs, 1.0f);
  float dka[R][CK], dva[R][CV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < CK; ++c) dka[r][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < CV; ++c) dva[r][c] = 0.0f;
  }

  const int q_lo = causal ? (k0 / kBQ) * kBQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = static_cast<size_t>(b) * S * qs + h * DK;
    const size_t ooff = static_cast<size_t>(b) * S * os + h * DV;
    const size_t roff = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = q_lo; q0 < S; q0 += kBQ) {
      __syncthreads();   // the previous tile is done with Qt, dOt, Pt, dSt
      load_t<DK, kBQ, kKVThreads>(Qt, kLQ, q + qoff, q0, S, qs, 1.0f);
      load_t<DV, kBQ, kKVThreads>(dOt, kLQ, dout + ooff, q0, S, os, 1.0f);
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
      tile_dot<DK, R, C>(st, Kt, Qt, ty, tx);     // s^T = k q^T
      tile_dot<DV, R, C>(dpt, Vt, dOt, ty, tx);   // dp^T = v dO^T
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
        for (int c = 0; c < CV; ++c) {
          const float dov = dOt[(tx + kTX * c) * kLQ + i];
#pragma unroll
          for (int r = 0; r < R; ++r) dva[r][c] = fmaf(p[r], dov, dva[r][c]);
        }
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const float qv = Qt[(tx + kTX * c) * kLQ + i];
#pragma unroll
          for (int r = 0; r < R; ++r) dka[r][c] = fmaf(ds[r], qv, dka[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = k0 + ty + kKVTY * r;
    if (j >= Sk) continue;
    const size_t krow = (static_cast<size_t>(b) * Sk + j) * ks + kvh * DK;
    const size_t vrow = (static_cast<size_t>(b) * Sk + j) * vs + kvh * DV;
#pragma unroll
    for (int c = 0; c < CK; ++c) dk[krow + tx + kTX * c] = dka[r][c];
#pragma unroll
    for (int c = 0; c < CV; ++c) dv[vrow + tx + kTX * c] = dva[r][c];
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
constexpr float kLog2e = 1.4426950408889634f;

// How the forward tiles the head dim D into TMA boxes of 128 rows.  Boxes
// of 64 columns (one 128-byte row, the 128-byte swizzle; d 32 and 80 run
// padded to 64 and 128), except at d 160: 64-column boxes would pad it to
// 192, whose Q tile and 2-stage K/V ring take 240 KB, over a block's 227
// KB, beside a 96-register O accumulator.  There boxes of 32 columns
// (64-byte rows, the 64-byte swizzle) hold 160 exactly: 40 KB of Q and
// 80 KB of K and of V a stage, 200 KB; P V is one m64n160k16 a step and
// Q K^T ten k16 steps, two in each box.
template <int D>
struct FwdTile {
  static constexpr int kCols = D % 64 == 0 || D < 128 ? 64 : 32;
  static constexpr int DP = (D + kCols - 1) / kCols * kCols;   // padded
  static constexpr int NB = DP / kCols;          // boxes across the head dim
  static constexpr int kSteps = kCols / 16;      // k16 steps in a box
  static constexpr uint32_t kBoxBytes = kFwdKeys * kCols * 2;
  static constexpr uint32_t kAtom = 8 * kCols * 2;   // 8 rows of a box
  // a shared-memory descriptor of this tiling's swizzle
  __device__ static uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
    return kCols == 64 ? hopper::desc_sw128(p, lbo, sbo)
                       : hopper::desc_sw64(p, lbo, sbo);
  }
};

// Shared memory of the forward, 1024-aligned: tiles of 128 rows x COLS
// columns (one TMA box each), NBK of them across the padded width of q and
// k, NBV across v's.  MLA's dk 192 / dv 128 takes three 64-column boxes of
// Q and K and two of V: 48 KB of Q and a 2-stage ring of 48 KB of K and 32
// KB of V, 208 KB.
template <int NBK, int NBV, int COLS>
struct FwdSmem {
  bf16 q[NBK][kFwdRows * COLS];
  bf16 k[kFwdStages][NBK][kFwdKeys * COLS];
  bf16 v[kFwdStages][NBV][kFwdKeys * COLS];
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
template <>
__device__ __forceinline__ void wgmma_pv<160>(float (&o)[80], const uint32_t* a,
                                              uint64_t db) {
  hopper::wgmma_m64n160k16_rs(o, a, db);
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
template <int DK, int DV>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int Sk, int H, int Hkv, int causal, float scale) {
  using T = FwdTile<DK>;    // q and k
  using TV = FwdTile<DV>;   // v and out
  static_assert(T::kCols == TV::kCols, "q, k and v share one box width");
  constexpr int NB = T::NB;
  constexpr int NBV = TV::NB;
  constexpr int DP = TV::DP;   // the accumulator's width
  using Smem = FwdSmem<NB, NBV, T::kCols>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

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
      hopper::mbar_expect_tx(&sm.q_full, NB * T::kBoxBytes);
      for (int c = 0; c < NB; ++c)
        hopper::tma_load_4d(sm.q[c], &tq, &sm.q_full, c * T::kCols, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kFwdStages;
        const uint32_t ph = (it / kFwdStages) & 1;
        hopper::mbar_wait(&sm.empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&sm.k_full[st], NB * T::kBoxBytes);
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(sm.k[st][c], &tk, &sm.k_full[st], c * T::kCols,
                              kvh, it * kFwdKeys, b);
        hopper::mbar_expect_tx(&sm.v_full[st], NBV * T::kBoxBytes);
        for (int c = 0; c < NBV; ++c)
          hopper::tma_load_4d(sm.v[st][c], &tv, &sm.v_full[st], c * T::kCols,
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

    // S = Q K^T: 64 rows x 128 keys, T::DP / 16 steps of k16
    float s[64];
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::DP / 16; ++kk) {
      const int c = kk / T::kSteps, k16 = (kk % T::kSteps) * 16;
      const bf16* qa = sm.q[c] + wg * 64 * T::kCols + k16;
      const bf16* kb = sm.k[st][c] + k16;
      hopper::wgmma_m64n128k16_ss(s, T::desc(qa, 16, T::kAtom),
                                  T::desc(kb, 16, T::kAtom), kk > 0);
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
    // contiguous), column blocks a box apart, groups of 8 keys an atom
    // apart (16 KB and 1024 bytes in the 128-byte swizzle)
    hopper::mbar_wait(&sm.v_full[st], ph);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
      const uint64_t dv = T::desc(sm.v[st][0] + kk * 16 * T::kCols,
                                  T::kBoxBytes, T::kAtom);
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
    bf16* dst = out + (static_cast<size_t>(b) * S + row) * H * DV +
                static_cast<size_t>(h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
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
// dst[64][D + 8] by 16-byte cp.async, NT threads sharing the copy; rows at
// or past S are zero-filled.  ``src`` points at (b, 0, hx, 0), ``stride``
// elements a row.
template <int D, int NT = kBwdThreads>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int r0,
                                        int S, size_t stride) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBwdCols * kChunks; i += NT) {
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

// c[2 NP][4] (16 rows x 16 NP) = A (16 rows of ``at``) * B^T (the first 16
// NP rows of ``bt``) over the D columns of both.
template <int D, int NP = 4>
__device__ __forceinline__ void mma_rows(float (&c)[2 * NP][4],
                                         const bf16* at, int arow,
                                         const bf16* bt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_a<LD>(a, at, arow, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];
      ldsm_b<LD>(b, bt, 16 * np, 16 * kk, lane);
      hopper::mma_16816(c[2 * np], a, b[0], b[1]);
      hopper::mma_16816(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[D / 8][4] (16 rows x D) += X (16 x 16 KC f32 fragments, split into
// bf16 hi + lo) * Y (the first 16 KC rows, D wide, of ``y``).
template <int D, int KC = 4>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4],
                                        const float (&x)[2 * KC][4],
                                        const bf16* y, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
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

// 3 tiles of [64][DK + 8] and 3 of [64][DV + 8] bf16, + lse and Delta
template <int DK, int DV>
__host__ __device__ constexpr size_t mma_smem() {
  return 3 * kBwdRows * (DK + DV + 16) * sizeof(bf16) +
         4 * kBwdCols * sizeof(float);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kBwdThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int Sk, int H, int Hkv, int causal,
              float scale) {
  constexpr int LDK = DK + 8;
  constexpr int LDV = DV + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [64][LDK]
  bf16* dOs = Qs + kBwdRows * LDK;                // [64][LDV]
  bf16* Ks = dOs + kBwdRows * LDV;                // [2][64][LDK]
  bf16* Vs = Ks + 2 * kBwdCols * LDK;             // [2][64][LDV]

  const int h = blockIdx.x;   // heads vary fastest: heavy tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qs = static_cast<size_t>(H) * DK;
  const size_t os = static_cast<size_t>(H) * DV;
  const size_t ks = static_cast<size_t>(Hkv) * DK;
  const size_t vs = static_cast<size_t>(Hkv) * DV;
  const size_t qoff = static_cast<size_t>(b) * S * qs + h * DK;
  const size_t ooff = static_cast<size_t>(b) * S * os + h * DV;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * ks + kvh * DK;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * vs + kvh * DV;
  const int k_end = causal ? min(Sk, min(q0 + kBwdRows, S)) : Sk;
  const int n_tiles = (k_end + kBwdCols - 1) / kBwdCols;

  cp_rows<DK>(Qs, q + qoff, q0, S, qs);
  cp_rows<DV>(dOs, dout + ooff, q0, S, os);
  cp_rows<DK>(Ks, kb, 0, Sk, ks);
  cp_rows<DV>(Vs, vb, 0, Sk, vs);
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
  float acc[DK / 8][4];
#pragma unroll
  for (int j = 0; j < DK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // above d 160 a 64-key tile is taken in two halves of 32 keys, one after
  // the other (the loop is not unrolled, so ptxas cannot interleave them):
  // s and dp of 16 x 32 beside the 16 x dk accumulator keep it in registers
  constexpr int KH = DK > 160 ? 2 : 1;
  constexpr int NP = 4 / KH;
  constexpr int kSub = kBwdCols / KH;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % 2;
    if (it + 1 < n_tiles) {
      const int next = (it + 1) * kBwdCols;
      cp_rows<DK>(Ks + (st ^ 1) * kBwdCols * LDK, kb, next, Sk, ks);
      cp_rows<DV>(Vs + (st ^ 1) * kBwdCols * LDV, vb, next, Sk, vs);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int h = 0; h < KH; ++h) {
      const bf16* Kt = Ks + (st * kBwdCols + h * kSub) * LDK;
      const bf16* Vt = Vs + (st * kBwdCols + h * kSub) * LDV;
      float s[2 * NP][4], dp[2 * NP][4];
      mma_rows<DK, NP>(s, Qs, 16 * warp, Kt, lane);
      mma_rows<DV, NP>(dp, dOs, 16 * warp, Vt, lane);
      const int k0 = it * kBwdCols + h * kSub;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + 16 * warp + lane / 4 + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * (lane % 4) + e % 2;
          const bool live = row < S && col < Sk && !(causal && row < col);
          const float p =
              live ? exp2f(fmaf(s[j][e], sl2, -lse2[e / 2])) : 0.0f;
          s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;   // ds
        }
      mma_acc<DK, NP>(acc, s, Kt, lane);
    }
    __syncthreads();   // the stage is read; the next prefetch may overwrite
  }
  store_rows<DK>(dq + qoff, qs, acc, q0 + 16 * warp, S, lane);
}

// What a paired dk/dv CTA reads: its 64 keys of K and V, loaded once, and a
// 2-stage cp.async ring of (Q, dO, lse, Delta) tiles of 64 query rows, item
// n being query head kvh * G + n / nq, rows q_lo + (n % nq) * 64.  NT
// threads share the copies.
template <int DK, int DV, int NT>
struct KvRing {
  static constexpr int LDK = DK + 8;
  static constexpr int LDV = DV + 8;
  bf16* Ks;    // [64][LDK]
  bf16* Vs;    // [64][LDV]
  bf16* Qs;    // [2][64][LDK]
  bf16* dOs;   // [2][64][LDV]
  float* Ls;   // [2][64]
  float* Ds;   // [2][64]
  const bf16 *q, *dout;
  const float *lse, *delta;
  int S, H, b, kvh, G, q_lo, nq;
  size_t qs, os;

  __device__ KvRing(uint8_t* smem, const bf16* q_, const bf16* dout_,
                    const float* lse_, const float* delta_, int S_, int H_,
                    int Hkv, int b_, int kvh_, int k0, int causal)
      : q(q_), dout(dout_), lse(lse_), delta(delta_), S(S_), H(H_), b(b_),
        kvh(kvh_), G(H_ / Hkv) {
    Ks = reinterpret_cast<bf16*>(smem);
    Vs = Ks + kBwdRows * LDK;
    Qs = Vs + kBwdRows * LDV;
    dOs = Qs + 2 * kBwdCols * LDK;
    Ls = reinterpret_cast<float*>(dOs + 2 * kBwdCols * LDV);
    Ds = Ls + 2 * kBwdCols;
    q_lo = causal ? k0 / kBwdCols * kBwdCols : 0;
    nq = q_lo < S ? (S - q_lo + kBwdCols - 1) / kBwdCols : 0;
    qs = static_cast<size_t>(H) * DK;
    os = static_cast<size_t>(H) * DV;
  }
  __device__ int total() const { return G * nq; }
  __device__ int q0(int n) const { return q_lo + (n % nq) * kBwdCols; }
  __device__ void issue(int n, int st) const {
    const int h = kvh * G + n / nq;
    const int r0 = q0(n);
    cp_rows<DK, NT>(Qs + st * kBwdCols * LDK,
                    q + static_cast<size_t>(b) * S * qs + h * DK, r0, S, qs);
    cp_rows<DV, NT>(dOs + st * kBwdCols * LDV,
                    dout + static_cast<size_t>(b) * S * os + h * DV, r0, S,
                    os);
    if (threadIdx.x < 2 * kBwdCols) {
      const size_t roff = (static_cast<size_t>(b) * H + h) * S;
      const int i = threadIdx.x % kBwdCols;
      const bool in = r0 + i < S;
      const float* src = threadIdx.x < kBwdCols ? lse : delta;
      float* dst = threadIdx.x < kBwdCols ? Ls : Ds;
      hopper::cp_async4(dst + st * kBwdCols + i,
                        in ? src + roff + r0 + i : src, in ? 4 : 0);
    }
  }
};

// d <= 128: each of 4 warps owns 16 keys and both of their accumulators.
template <int DK, int DV>
__global__ void __launch_bounds__(kBwdThreads)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Sk,
                int H, int Hkv, int causal, float scale) {
  constexpr int LDK = DK + 8;
  constexpr int LDV = DV + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [64][LDK]
  bf16* Vs = Ks + kBwdRows * LDK;                 // [64][LDV]
  bf16* Qs = Vs + kBwdRows * LDV;                 // [2][64][LDK]
  bf16* dOs = Qs + 2 * kBwdCols * LDK;            // [2][64][LDV]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBwdCols * LDV);   // [2][64]
  float* Ds = Ls + 2 * kBwdCols;                                    // [2][64]

  const int kvh = blockIdx.x;   // kv heads vary fastest: heavy tiles first
  const int k0 = blockIdx.y * kBwdRows;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qs = static_cast<size_t>(H) * DK;
  const size_t os = static_cast<size_t>(H) * DV;
  const size_t ks = static_cast<size_t>(Hkv) * DK;
  const size_t vs = static_cast<size_t>(Hkv) * DV;
  const size_t koff = static_cast<size_t>(b) * Sk * ks + kvh * DK;
  const size_t voff = static_cast<size_t>(b) * Sk * vs + kvh * DV;
  const int q_lo = causal ? k0 / kBwdCols * kBwdCols : 0;
  const int nq = q_lo < S ? (S - q_lo + kBwdCols - 1) / kBwdCols : 0;
  const int total = G * nq;

  // item n: query head kvh * G + n / nq, q rows q_lo + (n % nq) * 64
  auto issue = [&](int n, int st) {
    const int h = kvh * G + n / nq;
    const int q0 = q_lo + (n % nq) * kBwdCols;
    cp_rows<DK>(Qs + st * kBwdCols * LDK,
                q + static_cast<size_t>(b) * S * qs + h * DK, q0, S, qs);
    cp_rows<DV>(dOs + st * kBwdCols * LDV,
                dout + static_cast<size_t>(b) * S * os + h * DV, q0, S, os);
    const size_t roff = (static_cast<size_t>(b) * H + h) * S;
    const int i = threadIdx.x % kBwdCols;
    const bool in = q0 + i < S;
    const float* src = threadIdx.x < kBwdCols ? lse : delta;
    float* dst = threadIdx.x < kBwdCols ? Ls : Ds;
    hopper::cp_async4(dst + st * kBwdCols + i, in ? src + roff + q0 + i : src,
                      in ? 4 : 0);
  };

  cp_rows<DK>(Ks, k + koff, k0, Sk, ks);
  cp_rows<DV>(Vs, v + voff, k0, Sk, vs);
  if (total > 0) issue(0, 0);
  hopper::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float dka[DK / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = 0.0f;

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
    const bf16* Qt = Qs + st * kBwdCols * LDK;
    const bf16* dOt = dOs + st * kBwdCols * LDV;
    const float* Lt = Ls + st * kBwdCols;
    const float* Dt = Ds + st * kBwdCols;
    // s^T = k q^T: 16 keys of this warp x 64 queries; p^T in place
    float p[8][4];
    mma_rows<DK>(p, Ks, 16 * warp, Qt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * (lane % 4) + e % 2;
        const int key = k0 + 16 * warp + lane / 4 + 8 * (e / 2);
        const bool live = q0 + il < S && key < Sk && !(causal && q0 + il < key);
        p[j][e] = live ? exp2f(fmaf(p[j][e], sl2, -Lt[il] * kLog2e)) : 0.0f;
      }
    mma_acc<DV>(dva, p, dOt, lane);   // dv += p^T dO
    float ds[8][4];
    mma_rows<DV>(ds, Vs, 16 * warp, dOt, lane);   // dp^T = v dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * (lane % 4) + e % 2;
        ds[j][e] = p[j][e] * (ds[j][e] - Dt[il]) * scale;
      }
    mma_acc<DK>(dka, ds, Qt, lane);   // dk += ds^T q
    __syncthreads();   // the stage is read; the next prefetch may overwrite
  }
  hopper::cp_async_wait<0>();   // nothing in flight when the CTA leaves
  store_rows<DK>(dk + koff, ks, dka, k0 + 16 * warp, Sk, lane);
  store_rows<DV>(dv + voff, vs, dva, k0 + 16 * warp, Sk, lane);
}

// d > 128: 8 warps, two to each 16-key slice.  One
// warp of a slice (role 0) computes s^T and p^T, hands p^T to the other
// through shared memory and accumulates dv += p^T dO; the other (role 1)
// computes dp^T meanwhile, waits for p^T on a named barrier, forms ds^T
// and accumulates dk += ds^T q, a q tile in two halves of 32 queries.  A
// warp holds one accumulator (16 x dv or 16 x dk f32) beside one 16 x 32
// fragment, and no product is computed twice.  Each role runs its own
// loop (``dkdv_pair_role``), so that the two accumulators are never live
// in one thread; their CTA-wide barriers are the non-aligned
// ``barrier.sync``, legal from two places in the code.
constexpr int kPairThreads = 256;
constexpr int kPairSlices = 4;
constexpr size_t kPairXBytes = kPairSlices * 32 * 32 * sizeof(float);

template <int DK, int DV, int ROLE>
__device__ __forceinline__ void dkdv_pair_role(
    const KvRing<DK, DV, kPairThreads>& ring, float* px, bf16* dst,
    size_t stride, int Sk, int k0, int slice, int causal, float scale) {
  using Ring = KvRing<DK, DV, kPairThreads>;
  constexpr int DA = ROLE == 0 ? DV : DK;   // the width this role sums
  const int lane = threadIdx.x % 32;
  const int total = ring.total();
  const float sl2 = scale * kLog2e;
  float acc[DA / 8][4];
#pragma unroll
  for (int j = 0; j < DA / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int n = 0; n < total; ++n) {
    const int st = n % 2;
    if (n + 1 < total) {
      ring.issue(n + 1, st ^ 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::bar_sync(0, kPairThreads);
    const bf16* Qt = ring.Qs + st * kBwdCols * Ring::LDK;
    const bf16* dOt = ring.dOs + st * kBwdCols * Ring::LDV;
    // the 64 queries in two halves of 32, each handed over on a barrier
    // of its own (1 + slice, 5 + slice): the partner starts on the first
    // half while this warp computes the second
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = 32 * h;
      const bf16* Qh = Qt + c0 * Ring::LDK;
      const bf16* dOh = dOt + c0 * Ring::LDV;
      float x[4][4];
      if constexpr (ROLE == 0) {
        const int q0 = ring.q0(n);
        const float* Lt = ring.Ls + st * kBwdCols;
        mma_rows<DK, 2>(x, ring.Ks, 16 * slice, Qh, lane);   // s^T = k q^T
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = c0 + 8 * j + 2 * (lane % 4) + e % 2;
            const int key = k0 + 16 * slice + lane / 4 + 8 * (e / 2);
            const bool live =
                q0 + il < ring.S && key < Sk && !(causal && q0 + il < key);
            x[j][e] =
                live ? exp2f(fmaf(x[j][e], sl2, -Lt[il] * kLog2e)) : 0.0f;
            px[(4 * (4 * h + j) + e) * 32] = x[j][e];
          }
        hopper::bar_arrive(1 + slice + 4 * h, 64);   // p^T is there
        mma_acc<DV, 2>(acc, x, dOh, lane);            // dv += p^T dO
      } else {
        const float* Dt = ring.Ds + st * kBwdCols;
        mma_rows<DV, 2>(x, ring.Vs, 16 * slice, dOh, lane);   // dp^T
        hopper::bar_sync(1 + slice + 4 * h, 64);              // wait p^T
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = c0 + 8 * j + 2 * (lane % 4) + e % 2;
            x[j][e] = px[(4 * (4 * h + j) + e) * 32] * (x[j][e] - Dt[il]) *
                      scale;
          }
        mma_acc<DK, 2>(acc, x, Qh, lane);   // dk += ds^T q
      }
    }
    // the stage and p^T are read; the next prefetch and p^T may overwrite
    hopper::bar_sync(0, kPairThreads);
  }
  hopper::cp_async_wait<0>();   // nothing in flight when the CTA leaves
  store_rows<DA>(dst, stride, acc, k0 + 16 * slice, Sk, lane);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kPairThreads, 1)
dkdv_pair_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int Sk, int H, int Hkv,
                 int causal, float scale) {
  using Ring = KvRing<DK, DV, kPairThreads>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int kvh = blockIdx.x;   // kv heads vary fastest: heavy tiles first
  const int k0 = blockIdx.y * kBwdRows;
  const int b = blockIdx.z;
  const Ring ring(smem_raw, q, dout, lse, delta, S, H, Hkv, b, kvh, k0,
                  causal);
  // p^T of each slice, [slice][32 values][32 lanes] f32, after the ring
  float* px = reinterpret_cast<float*>(smem_raw + mma_smem<DK, DV>());
  const int warp = threadIdx.x / 32;
  // the two warps of a slice sit on different SM sub-partitions (warp w
  // runs on sub-partition w % 4), and each sub-partition holds one of
  // each role: role 0 is warps 0, 2, 5, 7
  const int slice = warp / 2;
  const int role = (warp ^ (warp >> 2)) & 1;
  const size_t ks = static_cast<size_t>(Hkv) * DK;
  const size_t vs = static_cast<size_t>(Hkv) * DV;
  const size_t koff = static_cast<size_t>(b) * Sk * ks + kvh * DK;
  const size_t voff = static_cast<size_t>(b) * Sk * vs + kvh * DV;

  cp_rows<DK, kPairThreads>(ring.Ks, k + koff, k0, Sk, ks);
  cp_rows<DV, kPairThreads>(ring.Vs, v + voff, k0, Sk, vs);
  if (ring.total() > 0) ring.issue(0, 0);
  hopper::cp_async_commit();
  px += slice * 32 * 32 + threadIdx.x % 32;
  if (role == 0)
    dkdv_pair_role<DK, DV, 0>(ring, px, dv + voff, vs, Sk, k0, slice, causal,
                              scale);
  else
    dkdv_pair_role<DK, DV, 1>(ring, px, dk + koff, ks, Sk, k0, slice, causal,
                              scale);
}

// -------------------------------------------------------------- launchers

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DK, int DV>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int S, int Sk, int H, int Hkv,
                    int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DK, DV>();
  cudaError_t err = allow_smem(fwd_kernel<DK, DV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fwd_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Sk, H,
      Hkv, causal, scale);
  return cudaGetLastError();
}

template <int DK, int DV>
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
  delta_kernel<float, DV><<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                            stream>>>(static_cast<const float*>(out), dot,
                                      delta, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<DK, DV>, dq_smem<DK, DV>());
  if (err != cudaSuccess) return err;
  dq_kernel<DK, DV><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads,
                      dq_smem<DK, DV>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), S, Sk, H, Hkv,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_kernel<DK, DV>, dkdv_smem<DK, DV>());
  if (err != cudaSuccess) return err;
  dkdv_kernel<DK, DV><<<dim3((Sk + kBKV - 1) / kBKV, Hkv, B), kKVThreads,
                        dkdv_smem<DK, DV>(), stream>>>(
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
// innermost dimension first: boxes of ``cols`` columns x 1 head x 128 rows
// x 1 batch, in the swizzle of ``cols`` * 2-byte rows (64: 128 bytes, 32:
// 64 bytes), zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int rows,
                     int heads, int D, int cols) {
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
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, kFwdRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DK, int DV>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int Sk, int H, int Hkv,
                     int causal, float scale, cudaStream_t stream) {
  using T = FwdTile<DK>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, H, DK, T::kCols);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Sk, Hkv, DK, T::kCols);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Sk, Hkv, DV, T::kCols);
  if (err != cudaSuccess) return err;
  constexpr size_t smem =
      sizeof(FwdSmem<T::NB, FwdTile<DV>::NB, T::kCols>) + 1024;   // + align
  static_assert(smem <= 232448, "the forward's tiles fit a block");
  err = allow_smem(fwd_wgmma_kernel<DK, DV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kFwdRows - 1) / kFwdRows, B);
  fwd_wgmma_kernel<DK, DV><<<grid, kFwdThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, S, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int DK, int DV>
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
  delta_kernel<bf16, DV><<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                           stream>>>(static_cast<const bf16*>(out), dot, delta,
                                     rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = mma_smem<DK, DV>();
  err = allow_smem(dq_mma_kernel<DK, DV>, smem);
  if (err != cudaSuccess) return err;
  dq_mma_kernel<DK, DV><<<dim3(H, (S + kBwdRows - 1) / kBwdRows, B),
                          kBwdThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), S, Sk, H, Hkv,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, (Sk + kBwdRows - 1) / kBwdRows, B);
  // the 4-warp dk/dv kernel up to d 128, the paired one above it
  if constexpr (DK > 128 || DV > 128) {
    constexpr size_t pair_smem = smem + kPairXBytes;
    static_assert(pair_smem <= 232448, "the paired tiles fit a block");
    err = allow_smem(dkdv_pair_kernel<DK, DV>, pair_smem);
    if (err != cudaSuccess) return err;
    dkdv_pair_kernel<DK, DV><<<grid, kPairThreads, pair_smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, Sk, H, Hkv, causal, scale);
  } else {
    err = allow_smem(dkdv_mma_kernel<DK, DV>, smem);
    if (err != cudaSuccess) return err;
    dkdv_mma_kernel<DK, DV><<<grid, kBwdThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, Sk, H, Hkv, causal, scale);
  }
  return cudaGetLastError();
}

// CALL(dk, dv) for the (q/k, v) head dims at run time: the pairs the
// kernels take, in both passes and both dtypes (MLA's 192 / 128 beside
// the equal widths).
#define FLASH_BY_PAIR(CALL)                            \
  if (DK == 32 && DV == 32) return CALL(32, 32);       \
  if (DK == 64 && DV == 64) return CALL(64, 64);       \
  if (DK == 80 && DV == 80) return CALL(80, 80);       \
  if (DK == 128 && DV == 128) return CALL(128, 128);   \
  if (DK == 160 && DV == 160) return CALL(160, 160);   \
  if (DK == 192 && DV == 128) return CALL(192, 128);   \
  return cudaErrorInvalidValue;

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor-core kernels).
// q (B, S, H, DK), k (B, Sk, Hkv, DK), v (B, Sk, Hkv, DV), out (B, S, H,
// DV), lse (B, H, S) f32; all contiguous and 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int Sk, int H,
                         int Hkv, int DK, int DV, int dtype, int causal,
                         float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, out, lse, B, S, Sk, H, Hkv, causal, scale, s
#define FWD_F32(dk, dv) fwd_f32<dk, dv>(FWD_ARGS)
#define FWD_BF16(dk, dv) fwd_bf16<dk, dv>(FWD_ARGS)
  if (dtype == 0) { FLASH_BY_PAIR(FWD_F32) }
  if (dtype == 1) { FLASH_BY_PAIR(FWD_BF16) }
  return cudaErrorInvalidValue;
}

// delta: (B, H, S) f32 scratch.  dq like q, dk like k, dv like v.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int S, int Sk, int H, int Hkv, int DK, int DV,
                         int dtype, int causal, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_ARGS \
  q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, Sk, H, Hkv, causal, scale
#define BWD_F32(dk, dv) bwd_f32<dk, dv>(BWD_ARGS, s)
#define BWD_BF16(dk, dv) bwd_bf16<dk, dv>(BWD_ARGS, s)
  if (dtype == 0) { FLASH_BY_PAIR(BWD_F32) }
  if (dtype == 1) { FLASH_BY_PAIR(BWD_BF16) }
  return cudaErrorInvalidValue;
}
