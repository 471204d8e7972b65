// One-token GQA flash-decoding over a dense per-slot KV cache or a paged
// pool, for sm_90a.
//
// Replaces the Pallas kernels of the JAX package
//   repro/kernels/decode_attention.py::decode_attention_pallas (_dense_kernel)
//   repro/kernels/decode_attention.py::paged_decode_attention_pallas
//     (_paged_kernel)
//
// q (B, H, dk) attends the cache k/v (B, S_max, Hkv, d), or the pages
// page_table[b, t / page] of a pool (n_pages, page, Hkv, d), at positions
// < lengths[b]; out (B, H, dv) = acc / max(l, 1e-30) from an f32 online
// softmax (m, l, acc), f32 or bf16 storage.  The two layouts differ only in
// where row t lies (struct Rows); the paged form also takes dk != dv.
//
// What bounds it: bytes.  Each cached K and V row is read once (2 * len *
// Hkv * d * bytes per slot) and used for G = H / Hkv heads: about 2 * G
// flops per byte in bf16, far below the card's ~295 flop/byte balance
// point.  The design therefore streams every byte exactly once with
// 16-byte loads and keeps everything else on chip:
//   * one CTA per (S-split, kv head, slot): the G query heads of a kv
//     head are loaded once into registers and share every K/V row; the
//     sequence is split so that B * Hkv * splits fills the 132 SMs (8
//     slots x 8 kv heads alone would occupy 64);
//   * a group of d / (16 / sizeof(T)) lanes owns one row, so a warp's
//     loads are contiguous 16-byte vectors;
//   * splits and tiles at or past lengths[b] issue no loads, so the work
//     follows the live context and not S_max; ragged S_max is masked;
//   * a second small pass merges the splits' (m, l, acc) partials.
// Tensor cores are not used: at ~2 * G flop/byte they would idle behind
// the loads anyway (wgmma/TMA are left for a later change).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // keys scored per pass through shared memory

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
  __device__ static float store(float x) { return x; }
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
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

// Where cached row t of slot b lies, in rows of (Hkv, d): a dense cache
// holds slot b's rows at b * cap + t; a paged pool holds them in page
// tbl[b, t / page].  Only rows t < lengths[b] are asked for, so a table
// entry of a page that starts at or past the length is never read.
struct Rows {
  const int32_t* tbl;   // (B, npp) page table, or nullptr for a dense cache
  int npp;
  int page;
  int cap;              // S_max, or npp * page
  __device__ size_t at(int b, int t) const {
    if (tbl == nullptr) return static_cast<size_t>(b) * cap + t;
    return static_cast<size_t>(tbl[b * npp + t / page]) * page + t % page;
  }
};

template <typename T, int DK, int DV, int GMAX>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ lengths,
             Rows rows, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int Hkv, int G, int chunk,
             int n_split, float scale) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kLanesK = DK / kVec;           // lanes that share a K row
  constexpr int kRowsK = kThreads / kLanesK;   // K rows in flight per pass
  constexpr int kLanesV = DV / kVec;
  constexpr int kRowsV = kThreads / kLanesV;
  static_assert(kLanesK <= 32 && 32 % kLanesK == 0, "row group in a warp");
  static_assert(kLanesV <= 32 && 32 % kLanesV == 0, "row group in a warp");
  static_assert(kTile % kRowsK == 0 && kTile % kRowsV == 0,
                "tile covers whole passes");

  __shared__ float scores[GMAX][kTile];
  __shared__ float red[kRowsV * GMAX * DV];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(lengths[b], rows.cap);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  if (start >= end) return;   // the combine pass reads no partial here

  const int tid = threadIdx.x;
  const int rowk = tid / kLanesK;
  const int lanek = tid % kLanesK;
  const int rowv = tid / kLanesV;
  const int lanev = tid % kLanesV;
  const int H = Hkv * G;

  float qf[GMAX][kVec];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      Io<T>::load(q + (static_cast<size_t>(b) * H + kvh * G + g) * DK +
                      lanek * kVec, qf[g]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) qf[g][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) qf[g][j] = 0.0f;
    }
  }
  float acc[GMAX][kVec];
  float m_run[GMAX], l_run[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[g][j] = 0.0f;
  }

  const T* kbase = k + static_cast<size_t>(kvh) * DK;
  const T* vbase = v + static_cast<size_t>(kvh) * DV;

  for (int t0 = start; t0 < end; t0 += kTile) {
    // scores of this tile: one row group per key, reduced across lanes
    for (int r = rowk; r < kTile; r += kRowsK) {
      const int t = t0 + r;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.0f;
      if (t < end) {
        float kf[kVec];
        Io<T>::load(kbase + rows.at(b, t) * Hkv * DK + lanek * kVec, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int j = 0; j < kVec; ++j) part[g] += qf[g][j] * kf[j];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int off = kLanesK / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lanek == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) scores[g][r] = t < end ? part[g] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax update (every thread holds the same m and l)
    float alpha[GMAX], m_new[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float mt = -INFINITY;
        for (int r = 0; r < kTile; ++r) mt = fmaxf(mt, scores[g][r]);
        m_new[g] = fmaxf(m_run[g], mt);
        alpha[g] = expf(m_run[g] - m_new[g]);
      } else {
        m_new[g] = 0.0f;
        alpha[g] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      float mg = 0.0f;
#pragma unroll
      for (int gg = 0; gg < GMAX; ++gg)
        if (gg == g) mg = m_new[gg];
      scores[g][i % kTile] = expf(scores[g][i % kTile] - mg);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float ls = 0.0f;
        for (int r = 0; r < kTile; ++r) ls += scores[g][r];
        l_run[g] = l_run[g] * alpha[g] + ls;
        m_run[g] = m_new[g];
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[g][j] *= alpha[g];
    }
    // P.V: each row group accumulates its own rows of the tile
    for (int r = rowv; r < kTile; r += kRowsV) {
      const int t = t0 + r;
      if (t >= end) break;
      float vf[kVec];
      Io<T>::load(vbase + rows.at(b, t) * Hkv * DV + lanev * kVec, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float p = scores[g][r];
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[g][j] += p * vf[j];
        }
      }
    }
    __syncthreads();
  }

  // merge the row groups' partial accumulators, write this split's part
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        red[(rowv * GMAX + g) * DV + lanev * kVec + j] = acc[g][j];
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * Hkv + kvh) * n_split + split;
  for (int i = tid; i < G * DV; i += kThreads) {
    const int g = i / DV;
    const int dd = i % DV;
    float s = 0.0f;
    for (int r = 0; r < kRowsV; ++r) s += red[(r * GMAX + g) * DV + dd];
    part_acc[(part * G + g) * DV + dd] = s;
  }
  if (tid < G) {
    float mg = 0.0f, lg = 0.0f;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g == tid) {
        mg = m_run[g];
        lg = l_run[g];
      }
    part_ml[(part * G + tid) * 2] = mg;
    part_ml[(part * G + tid) * 2 + 1] = lg;
  }
}

// merge the live splits of one (slot, head): out = acc / max(l, 1e-30)
template <typename T, int D>
__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               const int32_t* __restrict__ lengths,
                               T* __restrict__ out, int H, int Hkv,
                               int cap, int chunk, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int G = H / Hkv;
  const int kvh = h / G;
  const int g = h % G;
  const int len = min(lengths[b], cap);
  const int used = (len + chunk - 1) / chunk;
  const size_t base = (static_cast<size_t>(b) * Hkv + kvh) * n_split;
  float m_all = -INFINITY;
  for (int s = 0; s < used; ++s)
    m_all = fmaxf(m_all, part_ml[((base + s) * G + g) * 2]);
  for (int dd = threadIdx.x; dd < D; dd += blockDim.x) {
    float l_all = 0.0f, acc = 0.0f;
    for (int s = 0; s < used; ++s) {
      const size_t idx = (base + s) * G + g;
      const float w = expf(part_ml[idx * 2] - m_all);
      l_all += part_ml[idx * 2 + 1] * w;
      acc += part_acc[idx * D + dd] * w;
    }
    out[static_cast<size_t>(bh) * D + dd] = Io<T>::store(acc / fmaxf(l_all, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  Rows rows;
  void* out;
  float* part_acc;
  float* part_ml;
  int B, H, Hkv, chunk, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DK, int DV, int GMAX>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.Hkv;
  split_kernel<T, DK, DV, GMAX>
      <<<dim3(a.n_split, a.Hkv, a.B), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.lengths, a.rows, a.part_acc,
          a.part_ml, a.Hkv, G, a.chunk, a.n_split, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T, DV><<<a.B * a.H, DV < 128 ? DV : 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, a.lengths, static_cast<T*>(a.out), a.H, a.Hkv,
      a.rows.cap, a.chunk, a.n_split);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t by_group(const Args& a) {
  const int G = a.H / a.Hkv;
  if (G > 8) return cudaErrorInvalidValue;
  if constexpr (DK != DV) {
    // unequal widths (paged only) take one group size, to bound the build
    return launch<T, DK, DV, 8>(a);
  } else {
    if (G <= 1) return launch<T, DK, DV, 1>(a);
    if (G <= 2) return launch<T, DK, DV, 2>(a);
    if (G <= 4) return launch<T, DK, DV, 4>(a);
    return launch<T, DK, DV, 8>(a);
  }
}

template <typename T, int DK>
cudaError_t by_dv(int DV, const Args& a) {
  switch (DV) {
    case 32: return by_group<T, DK, 32>(a);
    case 64: return by_group<T, DK, 64>(a);
    case 128: return by_group<T, DK, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dims(int DK, int DV, const Args& a) {
  switch (DK) {
    case 32: return by_dv<T, 32>(DV, a);
    case 64: return by_dv<T, 64>(DV, a);
    case 128: return by_dv<T, 128>(DV, a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int DK, int DV, const Args& a) {
  if (a.B == 0) return cudaSuccess;
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.chunk % kTile != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) return by_dims<float>(DK, DV, a);
  if (dtype == 1) return by_dims<__nv_bfloat16>(DK, DV, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_acc holds B*Hkv*n_split*G*D and
// part_ml B*Hkv*n_split*G*2 floats of scratch.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int32_t* lengths, void* out,
                                float* part_acc, float* part_ml, int B, int H,
                                int Hkv, int S_max, int D, int dtype,
                                int chunk, int n_split, float scale,
                                void* stream) {
  const Args a{q, k, v, lengths, Rows{nullptr, 0, 0, S_max}, out, part_acc,
               part_ml, B, H, Hkv, chunk, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, D, a);
}

// The same over a paged pool: k (n_pages, page, Hkv, DK), v (n_pages,
// page, Hkv, DV), page_table (B, npp) int32.  part_acc holds
// B*Hkv*n_split*G*DV floats.
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const int32_t* page_table,
    const int32_t* lengths, void* out, float* part_acc, float* part_ml,
    int B, int H, int Hkv, int npp, int page, int DK, int DV, int dtype,
    int chunk, int n_split, float scale, void* stream) {
  if (page <= 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, Rows{page_table, npp, page, npp * page},
               out, part_acc, part_ml, B, H, Hkv, chunk, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, DK, DV, a);
}
