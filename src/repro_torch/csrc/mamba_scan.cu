// Chunked SSD (Mamba-2) scan forward, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
//   repro/kernels/mamba_scan.py::ssd_pallas (_kernel)
//
// x (b, s, nh, dh), dt and ldec = dt * A (b, s, nh) f32, B and C (b, s, N)
// with any batch and row strides.  For each chunk z of c steps, with seg
// the inclusive cumsum of ldec, tot = seg[c - 1] and h_in[z] the f32 state
// entering the chunk (zero for z = 0):
//   y[i, p]   = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x[j, p]
//             + exp(seg_i) (C_i . h_in[z][p, :])
//   states[z] = sum_j dt_j exp(tot - seg_j) x[j, p] B[j, n]     (dh, N)
//   h_in[z + 1] = exp(tot) h_in[z] + states[z]
// y is cast to x's dtype and the D skip, D * x in f32 cast to that dtype,
// is added in that dtype, as ssd_pallas adds it after its kernel; the
// state after the last chunk is written out in f32 (b, nh, dh, N).
//
// What bounds it: at the prefill shape (s = 32768, nh = 8, dh = 1024,
// N = 16, c = 256, bf16) bytes, 1.08 GB for x and y (0.32 ms at 3.35
// TB/s), ahead of the 157 GFLOP of the chunk products the Pallas kernel
// does densely (0.16 ms at the bf16 tensor-core peak).  Only the (dh, N)
// state is carried from chunk to chunk; everything else in a chunk is
// independent of the other chunks.  So bf16 runs three kernels, two of
// them parallel over (128 channels, chunk, batch x head), 8,192 CTAs at
// that shape:
//   * ssd_state_kernel: states[z] = x^T (w o B), w_j = dt_j exp(tot -
//     seg_j), as (w o B)^T x on mma.sync m16n8k16 (the 16 rows are the
//     state's N, zero-padded), x through ldmatrix.trans;
//   * ssd_pass_kernel: the only sequential part, one thread a (batch,
//     head, channel, state) element walking the chunks, h_in[z] written
//     over states[z] and the final state out;
//   * ssd_chunk_scan_kernel: C B^T on mma.sync for the tile blocks with
//     j <= i, turned in registers into M = (C B^T) exp(seg_i - seg_j) dt_j
//     (masked to 0 above the diagonal before the exp, which overflows
//     there), packed into A fragments as the flash kernels pack P, times
//     x; plus exp(seg_i) C h_in^T, the D skip, y.
// Both parallel kernels stage their x tile (c x 128 bf16, rows 272 bytes
// apart so ldmatrix meets no bank conflict) with cp.async in commit
// groups and start on their first rows while the later ones arrive; two
// CTAs fit an SM.  A CTA still loads, multiplies and stores one after the
// other, and the two on an SM start together, so the three overlap
// little: the scan kernel takes ~3x its share of the bound
// (kernels/ssd_ablation.py times each part).  seg
// comes from one function (chunk_seg: a warp scan in a fixed order) in
// both, so both see it bit for bit.  Roundings (emulated on the CPU by
// tests/test_torch_ssd.py): x, B and C are exact in bf16; w o B and M are
// f32 and enter their products as bf16 hi + lo (one rounding of w o B
// puts the final state outside its f32 bar); h_in enters the cross term
// rounded once (its lo part moves y by less than the bar can see).
// f32 keeps the scalar ssd_kernel, which holds f32's bar: one CTA per (64
// channels, head, batch) walking its chunks in order with its slice of
// the state in shared memory.  Fusing the state and scan kernels into one
// chained pass that reads x once, and wgmma or TMA for M x, are left for
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kP = 64;          // channels of dh a CTA owns
constexpr int kRB = 64;         // chunk rows per block of the decay matrix
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 16;
static_assert(kThreads == (kRB / 4) * (kP / 4), "4 x 4 outputs a thread");
static_assert(kThreads % kRB == 0 && kThreads % kP == 0, "whole rows");

__device__ inline float to_f(float v) { return v; }

template <typename T>
__device__ T from_f(float v);
template <>
__device__ float from_f<float>(float v) { return v; }

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


// ================================ bf16: chunk-parallel kernels on mma.sync

using bf16 = __nv_bfloat16;

// A CTA of the parallel kernels owns kTcP channels of dh, one warp for
// each 16; its x tile rows are kTcP + 8 elements (272 bytes) apart, so the
// 8 rows an ldmatrix reads fall in different banks.
constexpr int kTcP = 128;
constexpr int kTcThreads = 2 * kTcP;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kXLd = kTcP + 8;
constexpr int kNPad = 16;           // N zero-padded to one k16 step
constexpr int kNLd = 24;            // B / C tile row: 48 bytes
constexpr int kHalf = 128;          // the scan kernel's x rows of phase 0

__device__ __forceinline__ int pad16(int c) { return (c + 15) / 16 * 16; }

// seg[0..c) = inclusive cumsum of seg[0..c) (ldec on entry), by one warp
// in a fixed order: each lane sums a run, the warp scans the run totals;
// rows [c, cp) of the padded chunk repeat seg[c - 1].  Both parallel
// kernels call it, so both see the same seg bit for bit.
__device__ __forceinline__ void chunk_seg(float* seg, int c, int cp,
                                          int lane) {
  const int per = (c + 31) / 32;
  const int lo = min(lane * per, c);
  const int hi = min(lo + per, c);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    run += seg[i];
    seg[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  for (int i = lo; i < hi; ++i) seg[i] += excl;
  __syncwarp();
  for (int i = c + lane; i < cp; i += 32) seg[i] = seg[c - 1];
}

// Rows [r0, r1) of a chunk's x tile into xs[.][kXLd]: kTcP channels from
// ``src`` (x at the chunk's first row and the CTA's first channel),
// ``step`` elements a row; rows at or past c and channels at or past
// ``np`` arrive as zeros.  ``vec``: 16-byte cp.async (dh a multiple of 8,
// x 16-byte aligned), else plain loads.
__device__ __forceinline__ void load_x_rows(bf16* xs, const bf16* src,
                                            size_t step, int np, int c,
                                            int r0, int r1, bool vec) {
  constexpr int kChunks = kTcP / 8;
  for (int i = threadIdx.x; i < (r1 - r0) * kChunks; i += kTcThreads) {
    const int r = r0 + i / kChunks;
    const int ch = (i % kChunks) * 8;
    bf16* dst = xs + r * kXLd + ch;
    const bf16* from = src + r * step + ch;
    if (vec) {
      const bool in = r < c && ch < np;
      hopper::cp_async16(dst, in ? from : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = r < c && ch + e < np ? from[e] : __float2bfloat16(0.0f);
    }
  }
}

// The chunk's small operands go through registers, every load of a
// thread issued before its first store, so that they cost one memory
// latency and not one each.  fetch_rows: rows of B or C (``src`` at
// (batch, first row, 0)), state columns [N, 16) and rows [c, cp) zero;
// put_rows stores them as ts[cp][kNLd].
constexpr int kRowsPer = kMaxChunk * kNPad / kTcThreads;
constexpr int kHPer = kTcP * kNPad / kTcThreads;

__device__ __forceinline__ void fetch_rows(bf16 (&v)[kRowsPer],
                                           const bf16* src,
                                           long long row_stride, int N,
                                           int c) {
#pragma unroll
  for (int u = 0; u < kRowsPer; ++u) {
    const int i = threadIdx.x + u * kTcThreads;
    const int r = i / kNPad;
    const int n = i % kNPad;
    v[u] = r < c && n < N ? src[r * row_stride + n] : __float2bfloat16(0.0f);
  }
}
__device__ __forceinline__ void put_rows(bf16* ts, const bf16 (&v)[kRowsPer],
                                         int cp) {
#pragma unroll
  for (int u = 0; u < kRowsPer; ++u) {
    const int i = threadIdx.x + u * kTcThreads;
    if (i < cp * kNPad) ts[i / kNPad * kNLd + i % kNPad] = v[u];
  }
}

// dt and ldec of a chunk's rows into dts[cp] and seg[cp], zero past c.
__device__ __forceinline__ void load_dt(float* dts, float* seg,
                                        const float* dt, const float* ldec,
                                        size_t o, int nh, int c, int cp) {
  for (int i = threadIdx.x; i < cp; i += kTcThreads) {
    dts[i] = i < c ? dt[o + static_cast<size_t>(i) * nh] : 0.0f;
    seg[i] = i < c ? ldec[o + static_cast<size_t>(i) * nh] : 0.0f;
  }
}

size_t state_smem(int cp) {
  return static_cast<size_t>(cp) * (kXLd + kNLd) * sizeof(bf16) +
         2 * static_cast<size_t>(cp) * sizeof(float);
}
size_t scan_smem(int cp) {
  return static_cast<size_t>(cp) * (kXLd + 2 * kNLd) * sizeof(bf16) +
         2 * static_cast<size_t>(cp) * sizeof(float) +
         kTcP * kNPad * sizeof(float);
}

// One CTA per (kTcP channels, head, chunk) x batch: blockIdx.x = channel
// tile + tiles * (head + nh * chunk), y = batch, so the CTAs that run
// together read whole rows of x.  states (b, nc, nh, dh, N) f32; decay
// (b, nc, nh) = exp(tot), written by the first channel tile.
// Warp w owns channels [16 w, 16 w + 16): its 16 x 16 (N x channels)
// accumulator is (w o B)^T x over the chunk's rows, 64 rows per commit
// group of the x tile.
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ ldec, const bf16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ decay,
                 int s, int nh, int dh, int N, int c, long long b_sb,
                 long long b_ss, int vec) {
  extern __shared__ float4 smem4[];
  const int cp = pad16(c);
  bf16* xs = reinterpret_cast<bf16*>(smem4);     // [cp][kXLd]
  bf16* bs = xs + cp * kXLd;                     // [cp][kNLd]
  float* seg = reinterpret_cast<float*>(bs + cp * kNLd);   // [cp]
  float* wts = seg + cp;                         // [cp]: dt, then w

  const int tiles = (dh + kTcP - 1) / kTcP;
  const int p0 = blockIdx.x % tiles * kTcP;
  const int head = blockIdx.x / tiles % nh;
  const int z = blockIdx.x / tiles / nh;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t step = static_cast<size_t>(nh) * dh;
  const size_t row0 = static_cast<size_t>(bi) * s + static_cast<size_t>(z) * c;
  const bf16* xb = x + row0 * step + static_cast<size_t>(head) * dh + p0;

#pragma unroll
  for (int q = 0; q < 4; ++q) {   // 4 commit groups of 64 rows
    load_x_rows(xs, xb, step, dh - p0, c, min(64 * q, cp),
                min(64 * q + 64, cp), vec);
    hopper::cp_async_commit();
  }
  bf16 vb[kRowsPer];
  fetch_rows(vb, Bm + bi * b_sb + static_cast<long long>(z) * c * b_ss, b_ss,
             N, c);
  load_dt(wts, seg, dt, ldec, row0 * nh + head, nh, c, cp);
  put_rows(bs, vb, cp);
  __syncthreads();
  if (warp == 0) chunk_seg(seg, c, cp, lane);
  __syncthreads();
  const float tot = seg[c - 1];
  for (int j = tid; j < cp; j += kTcThreads) wts[j] *= expf(tot - seg[j]);
  if (p0 == 0 && tid == 0)
    decay[(row0 / c) * nh + head] = expf(tot);

  float acc[2][4] = {};
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q == 0) hopper::cp_async_wait<3>();
    if (q == 1) hopper::cp_async_wait<2>();
    if (q == 2) hopper::cp_async_wait<1>();
    if (q == 3) hopper::cp_async_wait<0>();
    __syncthreads();   // this group's rows (and, first, w) are in
    for (int k0 = 64 * q; k0 < min(64 * q + 64, cp); k0 += 16) {
      // A = (w o B)^T, 16 (n) x 16 (j): register r holds n = g + 8 (r % 2)
      // and j = k0 + t2 + 8 (r / 2), + 1
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = g + 8 * (r % 2);
        const int j = k0 + t2 + 8 * (r / 2);
        const bf16* bj = bs + j * kNLd + n;
        hopper::split_bf16(wts[j] * __bfloat162float(bj[0]),
                           wts[j + 1] * __bfloat162float(bj[kNLd]), hi[r],
                           lo[r]);
      }
      uint32_t b[4];
      hopper::ldsm_bt<kXLd>(b, xs, k0, 16 * warp, lane);
      hopper::mma_16816(acc[0], hi, b[0], b[1]);
      hopper::mma_16816(acc[0], lo, b[0], b[1]);
      hopper::mma_16816(acc[1], hi, b[2], b[3]);
      hopper::mma_16816(acc[1], lo, b[2], b[3]);
    }
  }
  // acc[tl][e]: n = g + 8 (e / 2), channel 16 w + 8 tl + t2 + e % 2
  float* out = states + ((row0 / c) * nh + head) * static_cast<size_t>(dh) * N;
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = g + 8 * (e / 2);
      const int p = p0 + 16 * warp + 8 * tl + t2 + e % 2;
      if (p < dh && n < N) out[static_cast<size_t>(p) * N + n] = acc[tl][e];
    }
}

// One thread a (batch, head, channel, state) element: walks the chunks in
// order, writes the state entering each chunk over that chunk's states
// and the state after the last chunk to h_out (b, nh, dh, N).  Loads run
// kUnroll chunks ahead of the chain of multiply-adds.
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                float* __restrict__ h_out, int nc, int nh, long long per_head,
                long long total) {
  constexpr int kUnroll = 8;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const long long bh = e / per_head;
  const long long pn = e % per_head;
  const long long bi = bh / nh;
  const long long head = bh % nh;
  float h = 0.0f;
  for (int z0 = 0; z0 < nc; z0 += kUnroll) {
    const int m = min(kUnroll, nc - z0);
    float st[kUnroll], dc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < m) {
        const long long zc = (bi * nc + z0 + u) * nh + head;
        st[u] = states[zc * per_head + pn];
        dc[u] = decay[zc];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < m) {
        const long long zc = (bi * nc + z0 + u) * nh + head;
        states[zc * per_head + pn] = h;
        h = h * dc[u] + st[u];
      }
    }
  }
  h_out[e] = h;
}

// sc (16 x 16 f32: rows i0.., two n8 tiles of j) = C_i . B_j over the 16
// (padded) state columns, for the 16 rows j0.. of the B tile.
__device__ __forceinline__ void cb_block(float (&sc)[2][4],
                                         const uint32_t (&ca)[4],
                                         const bf16* bs, int j0, int lane) {
  uint32_t bb[4];
  hopper::ldsm_b<kNLd>(bb, bs, j0, 0, lane);
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[tl][e] = 0.0f;
  hopper::mma_16816(sc[0], ca, bb[0], bb[1]);
  hopper::mma_16816(sc[1], ca, bb[2], bb[3]);
}

// M = sc exp(seg_i - seg_j) dt_j for j <= i, else 0 (masked before the
// exp, which overflows above the diagonal), as A fragments split into
// bf16 hi + lo; register r holds row g + 8 (r % 2), j of tile r / 2.
__device__ __forceinline__ void m_block(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        float (&sc)[2][4], const float* seg,
                                        const float* dts, int i0, int j0,
                                        int lane) {
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e / 2);
      const int j = j0 + 8 * tl + t2 + e % 2;
      sc[tl][e] = j <= i ? (sc[tl][e] * expf(seg[i] - seg[j])) * dts[j]
                         : 0.0f;
    }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    hopper::split_bf16(sc[r / 2][2 * (r % 2)], sc[r / 2][2 * (r % 2) + 1],
                       hi[r], lo[r]);
}

// Same grid as ssd_state_kernel.  The 8 warps split the chunk's 16-row
// tiles: warp w takes the tiles w and 15 - w, which balances the causal
// work; each is a 16 x 128 f32 accumulator in registers.  The x tile
// arrives in two parts: rows [0, kHalf), all that the tiles below kHalf
// read, before the CTA's one barrier, and the rest, which each warp waits
// for on an mbarrier after the cross term of its tile that needs it.
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ ldec,
                      const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                      const float* __restrict__ Dskip,
                      const float* __restrict__ h_in, bf16* __restrict__ y,
                      int s, int nh, int dh, int N, int c, long long b_sb,
                      long long b_ss, long long c_sb, long long c_ss,
                      int vec) {
  extern __shared__ float4 smem4[];
  const int cp = pad16(c);
  bf16* xs = reinterpret_cast<bf16*>(smem4);     // [cp][kXLd]
  bf16* bs = xs + cp * kXLd;                     // [cp][kNLd]
  bf16* cs = bs + cp * kNLd;                     // [cp][kNLd]
  float* seg = reinterpret_cast<float*>(cs + cp * kNLd);   // [cp]
  float* dts = seg + cp;                         // [cp]
  float* hs = dts + cp;                          // [kTcP][kNPad]: h_in

  const int tiles = (dh + kTcP - 1) / kTcP;
  const int p0 = blockIdx.x % tiles * kTcP;
  const int head = blockIdx.x / tiles % nh;
  const int z = blockIdx.x / tiles / nh;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t step = static_cast<size_t>(nh) * dh;
  const size_t row0 = static_cast<size_t>(bi) * s + static_cast<size_t>(z) * c;
  const size_t xoff = row0 * step + static_cast<size_t>(head) * dh + p0;

  __shared__ alignas(8) uint64_t x_late;   // rows [kHalf, cp) have landed
  load_x_rows(xs, x + xoff, step, dh - p0, c, 0, min(kHalf, cp), vec);
  hopper::cp_async_commit();
  if (tid == 0) {
    hopper::mbar_init(&x_late, kTcThreads);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  load_x_rows(xs, x + xoff, step, dh - p0, c, min(kHalf, cp), cp, vec);
  hopper::cp_async_commit();
  if (vec)
    hopper::cp_async_mbar_arrive(&x_late);
  else
    hopper::mbar_arrive(&x_late);
  const long long r0 = static_cast<long long>(z) * c;
  bf16 vb[kRowsPer], vc[kRowsPer];
  float vh[kHPer];
  fetch_rows(vb, Bm + bi * b_sb + r0 * b_ss, b_ss, N, c);
  fetch_rows(vc, Cm + bi * c_sb + r0 * c_ss, c_ss, N, c);
  const float* hz =
      h_in + ((row0 / c) * nh + head) * static_cast<size_t>(dh) * N;
#pragma unroll
  for (int u = 0; u < kHPer; ++u) {
    const int i = tid + u * kTcThreads;
    const int p = p0 + i / kNPad;
    const int n = i % kNPad;
    vh[u] = p < dh && n < N ? hz[static_cast<size_t>(p) * N + n] : 0.0f;
  }
  load_dt(dts, seg, dt, ldec, row0 * nh + head, nh, c, cp);
  put_rows(bs, vb, cp);
  put_rows(cs, vc, cp);
#pragma unroll
  for (int u = 0; u < kHPer; ++u) hs[tid + u * kTcThreads] = vh[u];
  hopper::cp_async_wait<1>();   // rows [0, kHalf)
  __syncthreads();
  if (warp == 0) chunk_seg(seg, c, cp, lane);
  __syncthreads();

  const float dsk = Dskip[head];
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  bool waited = false;
  for (int f = 0; f < 2; ++f) {
    const int i0 = 16 * (f == 0 ? warp : 2 * kTcWarps - 1 - warp);
    if (i0 >= cp) continue;
    // cross term: C_i . h_in[p, :] (h_in rounded once to bf16), then
    // times exp(seg_i); the B operand's column is channel 8 nt + g
    float acc[kTcP / 8][4];
    uint32_t ca[4];
    hopper::ldsm_a<kNLd>(ca, cs, i0, 0, lane);
    const float e0 = expf(seg[i0 + g]);
    const float e1 = expf(seg[i0 + g + 8]);
#pragma unroll
    for (int nt = 0; nt < kTcP / 8; ++nt) {
      const float* hp = hs + (8 * nt + g) * kNPad + t2;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      hopper::mma_16816(acc[nt], ca, hopper::pack_bf16(hp[0], hp[1]),
                        hopper::pack_bf16(hp[8], hp[9]));
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
    // the later rows: wait for every thread's copies of them, with no
    // barrier that would hold the warps to one another
    if (i0 + 16 > kHalf && !waited) {
      hopper::mbar_wait(&x_late, 0);
      waited = true;
    }
    for (int j0 = 0; j0 <= i0; j0 += 16) {
      float sc[2][4];
      uint32_t hi[4], lo[4];
      cb_block(sc, ca, bs, j0, lane);
      m_block(hi, lo, sc, seg, dts, i0, j0, lane);
#pragma unroll
      for (int nd = 0; nd < kTcP / 16; ++nd) {
        uint32_t b[4];
        hopper::ldsm_bt<kXLd>(b, xs, j0, 16 * nd, lane);
        hopper::mma_16816(acc[2 * nd], hi, b[0], b[1]);
        hopper::mma_16816(acc[2 * nd], lo, b[0], b[1]);
        hopper::mma_16816(acc[2 * nd + 1], hi, b[2], b[3]);
        hopper::mma_16816(acc[2 * nd + 1], lo, b[2], b[3]);
      }
    }
    // y = bf16(bf16(acc) + bf16(D x)), the reference's rounding
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i >= c) continue;
      bf16* yrow = y + xoff + static_cast<size_t>(i) * step;
      const bf16* xrow = xs + i * kXLd;
#pragma unroll
      for (int nt = 0; nt < kTcP / 8; ++nt) {
        const int ch = 8 * nt + t2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float yv =
              __bfloat162float(__float2bfloat16(acc[nt][2 * r + e]));
          const float sk = __bfloat162float(
              __float2bfloat16(dsk * __bfloat162float(xrow[ch + e])));
          v[e] = yv + sk;
        }
        if (vec) {
          if (p0 + ch < dh)
            *reinterpret_cast<uint32_t*>(yrow + ch) =
                hopper::pack_bf16(v[0], v[1]);
        } else {
          if (p0 + ch < dh) yrow[ch] = __float2bfloat16(v[0]);
          if (p0 + ch + 1 < dh) yrow[ch + 1] = __float2bfloat16(v[1]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();   // a warp with no late tile exits here
}

cudaError_t launch_tc(const bf16* x, const float* dt, const float* ldec,
                      const bf16* B, const bf16* C, const float* D, bf16* y,
                      float* h, float* states, float* decay, int b, int s,
                      int nh, int dh, int N, int c, long long b_sb,
                      long long b_ss, long long c_sb, long long c_ss,
                      cudaStream_t stream) {
  const int cp = (c + 15) / 16 * 16;
  const int nc = s / c;
  const int vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(nc * nh * ((dh + kTcP - 1) / kTcP), b);
  const size_t st_bytes = state_smem(cp);
  const size_t sc_bytes = scan_smem(cp);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(st_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sc_bytes));
  if (err != cudaSuccess) return err;
  ssd_state_kernel<<<grid, kTcThreads, st_bytes, stream>>>(
      x, dt, ldec, B, states, decay, s, nh, dh, N, c, b_sb, b_ss, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_head = static_cast<long long>(dh) * N;
  const long long total = static_cast<long long>(b) * nh * per_head;
  ssd_pass_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                    stream>>>(states, decay, h, nc, nh, per_head, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<<<grid, kTcThreads, sc_bytes, stream>>>(
      x, dt, ldec, B, C, D, states, y, s, nh, dh, N, c, b_sb, b_ss, c_sb,
      c_ss, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  dt, ldec: (b, s, nh)
// f32 contiguous; D: (nh,) f32; h: (b, nh, dh, N) f32 output.  B and C
// have a dense last axis and the given batch and row strides (elements).
// bf16 runs the three chunk-parallel kernels and needs scratch: states
// (b, s / c, nh, dh, N) f32 and decay (b, s / c, nh) f32; f32 runs the
// scalar kernel and ignores both.
extern "C" int ssd_scan(const void* x, const float* dt, const float* ldec,
                        const void* B, const void* C, const float* D,
                        void* y, float* h, float* states, float* decay,
                        int b, int s, int nh, int dh, int N, int c,
                        long long b_sb, long long b_ss, long long c_sb,
                        long long c_ss, int dtype, void* stream) {
  if (b == 0 || nh == 0 || dh == 0) return cudaSuccess;
  if (c <= 0 || c > kMaxChunk || s % c != 0 || N <= 0 || N > kMaxN)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, ldec, B, C, D, y, h, b, s, nh, dh, N, c,
                         b_sb, b_ss, c_sb, c_ss, st);
  if (dtype == 1)
    return launch_tc(static_cast<const bf16*>(x), dt, ldec,
                     static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                     D, static_cast<bf16*>(y), h, states, decay, b, s, nh,
                     dh, N, c, b_sb, b_ss, c_sb, c_ss, st);
  return cudaErrorInvalidValue;
}
