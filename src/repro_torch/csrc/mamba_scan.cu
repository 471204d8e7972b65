// Chunked SSD (Mamba-2) scan forward, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
//   repro/kernels/mamba_scan.py::ssd_pallas (_kernel)
//
// x (b, s, nh, dh), dt and ldec = dt * A (b, s, nh) f32, B and C (b, s, N)
// with any batch and row strides.  For each chunk of c steps, with seg
// the inclusive cumsum of ldec and tot = seg[c - 1]:
//   y[i, p]  = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x[j, p]
//            + exp(seg_i) (C_i . h[p, :])
//   h[p, n] <- exp(tot) h[p, n] + sum_j dt_j exp(tot - seg_j) x[j, p] B[j, n]
// y is cast to x's dtype and the D skip, D * x in f32 cast to that dtype,
// is added in that dtype, as ssd_pallas adds it after its kernel.  h starts
// at zero and its final value is written out in f32 (b, nh, dh, N).
//
// What bounds it: at the prefill shape (s = 32768, nh = 8, dh = 1024,
// N = 16, c = 256, bf16) bytes, 1.08 GB for x and y (0.32 ms at 3.35
// TB/s), ahead of the 157 GFLOP of the chunk products the Pallas kernel
// does densely (0.16 ms at the bf16 tensor-core peak).  The chunks of one
// (batch, head) form a chain, and b * nh = 8 chains would leave 124 of
// 132 SMs idle, so the design takes its parallelism from dh instead:
// every channel p depends only on x[:, p] and on the dt, B and C the
// channels share.  A CTA owns 64 channels of one (batch, head) and walks
// its chunks in order, carrying its (64, N) slice of h in shared memory
// (8 heads x 16 channel blocks = 128 CTAs at that shape).  Each chunk:
//   * stages dt, ldec, B, C and its x tile in shared memory (f32);
//   * one warp scans ldec into seg;
//   * builds the decay-weighted C B^T one 64-row block at a time, only
//     for j <= i: seg falls along the chunk (A < 0), so exp(seg_i - seg_j)
//     overflows to inf above the diagonal and is never formed there;
//   * multiplies each block into the x tile, 4 x 4 outputs a thread, adds
//     the cross-chunk term and writes y;
//   * updates its slice of h.
// The C B^T work is repeated by each of a head's channel blocks (about a
// quarter on top of the y product).  Everything runs on the scalar f32
// pipes, as the Pallas kernel keeps its products in f32; wgmma tiles and
// passing states between chunks in parallel are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 64;          // channels of dh a CTA owns
constexpr int kRB = 64;         // chunk rows per block of the decay matrix
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 16;
static_assert(kThreads == (kRB / 4) * (kP / 4), "4 x 4 outputs a thread");
static_assert(kThreads % kRB == 0 && kThreads % kP == 0, "whole rows");

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ T from_f(float v);
template <>
__device__ float from_f<float>(float v) { return v; }
template <>
__device__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int c, int N) {
  return sizeof(float) *
         (static_cast<size_t>(c) * (kP + kRB + 2 * N + 2) + kMaxN * kP);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ ldec, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dskip,
           T* __restrict__ y, float* __restrict__ h_out, int s, int nh,
           int dh, int N, int c, long long b_sb, long long b_ss,
           long long c_sb, long long c_ss) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [c][kP]
  float* mt = xs + c * kP;                       // [c][kRB]: M^T of a block
  float* bs = mt + c * kRB;                      // [c][N]
  float* cs = bs + c * N;                        // [c][N]
  float* dts = cs + c * N;                       // [c]: dt, then the weights
  float* seg = dts + c;                          // [c]: ldec, then its cumsum
  float* ht = seg + c;                           // [kMaxN][kP]: h^T

  const int p0 = blockIdx.x * kP;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % (kP / 4);                 // channels tx*4 .. +3
  const int ty = tid / (kP / 4);                 // block rows ty*4 .. +3
  const float dskip = Dskip[head];
  const size_t step = static_cast<size_t>(nh) * dh;   // x/y time stride
  const size_t xbase = static_cast<size_t>(bi) * s * step +
                       static_cast<size_t>(head) * dh;

  for (int i = tid; i < kMaxN * kP; i += kThreads) ht[i] = 0.0f;

  for (int t0 = 0; t0 < s; t0 += c) {
    __syncthreads();   // the previous chunk is done with every buffer
    for (int i = tid; i < c; i += kThreads) {
      const size_t o = (static_cast<size_t>(bi) * s + t0 + i) * nh + head;
      dts[i] = dt[o];
      seg[i] = ldec[o];
    }
    for (int i = tid; i < c * N; i += kThreads) {
      const long long j = t0 + i / N;
      const int n = i % N;
      bs[i] = to_f(Bm[bi * b_sb + j * b_ss + n]);
      cs[i] = to_f(Cm[bi * c_sb + j * c_ss + n]);
    }
    for (int i = tid; i < c * kP; i += kThreads) {
      const int j = i / kP;
      const int ch = p0 + i % kP;
      xs[i] = ch < dh ? to_f(x[xbase + (t0 + j) * step + ch]) : 0.0f;
    }
    __syncthreads();

    // seg = inclusive cumsum of ldec: each lane sums a run, the warp scans
    // the run totals
    if (tid < 32) {
      const int per = (c + 31) / 32;
      const int lo = min(tid * per, c);
      const int hi = min(lo + per, c);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run += seg[i];
        seg[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      for (int i = lo; i < hi; ++i) seg[i] += excl;
    }
    __syncthreads();
    const float tot = seg[c - 1];

    for (int r0 = 0; r0 < c; r0 += kRB) {
      const int jend = min(c, r0 + kRB);
      // mt[j][il] = (C_i . B_j) exp(seg_i - seg_j) dt_j for j <= i, else 0
      {
        const int il = tid % kRB;
        const int i = r0 + il;
        float creg[kMaxN];
        float segi = 0.0f;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n)
          creg[n] = (i < c && n < N) ? cs[i * N + n] : 0.0f;
        if (i < c) segi = seg[i];
        for (int j = tid / kRB; j < jend; j += kThreads / kRB) {
          float v = 0.0f;
          if (i < c && j <= i) {
            float cb = 0.0f;
#pragma unroll
            for (int n = 0; n < kMaxN; ++n)
              if (n < N) cb += creg[n] * bs[j * N + n];
            v = (cb * expf(segi - seg[j])) * dts[j];
          }
          mt[j * kRB + il] = v;
        }
      }
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      for (int j = 0; j < jend; ++j) {
        const float4 m =
            *reinterpret_cast<const float4*>(mt + j * kRB + ty * 4);
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + j * kP + tx * 4);
        const float mm[4] = {m.x, m.y, m.z, m.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += mm[r] * xx[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + ty * 4 + r;
        if (i >= c) break;
        float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int n = 0; n < N; ++n) {
          const float cv = cs[i * N + n];
          const float4 hv =
              *reinterpret_cast<const float4*>(ht + n * kP + tx * 4);
          cr[0] += cv * hv.x;
          cr[1] += cv * hv.y;
          cr[2] += cv * hv.z;
          cr[3] += cv * hv.w;
        }
        const float e = expf(seg[i]);
        T* yrow = y + xbase + (t0 + i) * step;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ch = p0 + tx * 4 + q;
          if (ch < dh) {
            const float yv = to_f(from_f<T>(acc[r][q] + cr[q] * e));
            const float sk = to_f(from_f<T>(dskip * xs[i * kP + tx * 4 + q]));
            yrow[ch] = from_f<T>(yv + sk);
          }
        }
      }
      __syncthreads();   // mt is rebuilt next; h is read until here
    }

    // h <- exp(tot) h + sum_j w_j x[j, p] B[j, n], w_j = dt_j exp(tot - seg_j)
    for (int j = tid; j < c; j += kThreads) dts[j] *= expf(tot - seg[j]);
    __syncthreads();
    {
      const int p = tid % kP;
      const int nb = tid / kP;
      constexpr int kNPer = kMaxN / (kThreads / kP);
      float hn[kNPer];
#pragma unroll
      for (int k = 0; k < kNPer; ++k) hn[k] = 0.0f;
      for (int j = 0; j < c; ++j) {
        const float wx = dts[j] * xs[j * kP + p];
#pragma unroll
        for (int k = 0; k < kNPer; ++k) {
          const int n = nb + k * (kThreads / kP);
          if (n < N) hn[k] += wx * bs[j * N + n];
        }
      }
      const float et = expf(tot);
#pragma unroll
      for (int k = 0; k < kNPer; ++k) {
        const int n = nb + k * (kThreads / kP);
        if (n < N) ht[n * kP + p] = ht[n * kP + p] * et + hn[k];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kP * N; i += kThreads) {
    const int p = i / N;
    const int n = i % N;
    const int ch = p0 + p;
    if (ch < dh)
      h_out[((static_cast<size_t>(bi) * nh + head) * dh + ch) * N + n] =
          ht[n * kP + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* ldec,
                   const void* B, const void* C, const float* D, void* y,
                   float* h, int b, int s, int nh, int dh, int N, int c,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, cudaStream_t stream) {
  const size_t bytes = smem_bytes(c, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((dh + kP - 1) / kP, nh, b);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, ldec, static_cast<const T*>(B),
      static_cast<const T*>(C), D, static_cast<T*>(y), h, s, nh, dh, N, c,
      b_sb, b_ss, c_sb, c_ss);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  dt, ldec: (b, s, nh)
// f32 contiguous; D: (nh,) f32; h: (b, nh, dh, N) f32 output.  B and C
// have a dense last axis and the given batch and row strides (elements).
extern "C" int ssd_scan(const void* x, const float* dt, const float* ldec,
                        const void* B, const void* C, const float* D,
                        void* y, float* h, int b, int s, int nh, int dh,
                        int N, int c, long long b_sb, long long b_ss,
                        long long c_sb, long long c_ss, int dtype,
                        void* stream) {
  if (b == 0 || nh == 0 || dh == 0) return cudaSuccess;
  if (c <= 0 || c > kMaxChunk || s % c != 0 || N <= 0 || N > kMaxN)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, ldec, B, C, D, y, h, b, s, nh, dh, N, c,
                         b_sb, b_ss, c_sb, c_ss, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, ldec, B, C, D, y, h, b, s, nh, dh,
                                 N, c, b_sb, b_ss, c_sb, c_ss, st);
  return cudaErrorInvalidValue;
}
