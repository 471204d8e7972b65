// One-token GQA flash-decoding over a dense per-slot KV cache, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
//   repro/kernels/decode_attention.py::decode_attention_pallas (_dense_kernel)
//
// q (B, H, d) attends the cache k/v (B, S_max, Hkv, d) at positions
// < lengths[b]; out (B, H, d) = acc / max(l, 1e-30) from an f32 online
// softmax (m, l, acc), f32 or bf16 storage.
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

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ lengths,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             int Hkv, int S_max, int G, int chunk, int n_split, float scale) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kLanes = D / kVec;             // lanes that share one row
  constexpr int kRows = kThreads / kLanes;     // rows in flight per pass
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "row group within a warp");
  static_assert(kTile % kRows == 0, "tile covers whole passes");

  __shared__ float scores[GMAX][kTile];
  __shared__ float red[kRows * GMAX * D];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(lengths[b], S_max);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  if (start >= end) return;   // the combine pass reads no partial here

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int H = Hkv * G;

  float qf[GMAX][kVec];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      Io<T>::load(q + (static_cast<size_t>(b) * H + kvh * G + g) * D +
                      lane * kVec, qf[g]);
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

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* kbase = k + static_cast<size_t>(b) * S_max * row_stride + kvh * D;
  const T* vbase = v + static_cast<size_t>(b) * S_max * row_stride + kvh * D;

  for (int t0 = start; t0 < end; t0 += kTile) {
    // scores of this tile: one row group per key, reduced across lanes
    for (int r = row; r < kTile; r += kRows) {
      const int t = t0 + r;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.0f;
      if (t < end) {
        float kf[kVec];
        Io<T>::load(kbase + t * row_stride + lane * kVec, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int j = 0; j < kVec; ++j) part[g] += qf[g][j] * kf[j];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane == 0) {
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
    for (int r = row; r < kTile; r += kRows) {
      const int t = t0 + r;
      if (t >= end) break;
      float vf[kVec];
      Io<T>::load(vbase + t * row_stride + lane * kVec, vf);
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
        red[(row * GMAX + g) * D + lane * kVec + j] = acc[g][j];
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * Hkv + kvh) * n_split + split;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int dd = i % D;
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += red[(r * GMAX + g) * D + dd];
    part_acc[(part * G + g) * D + dd] = s;
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
                               int S_max, int chunk, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int G = H / Hkv;
  const int kvh = h / G;
  const int g = h % G;
  const int len = min(lengths[b], S_max);
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

template <typename T, int D, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* part_acc,
                   float* part_ml, int B, int H, int Hkv, int S_max,
                   int chunk, int n_split, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  split_kernel<T, D, GMAX><<<dim3(n_split, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, Hkv, S_max, G,
      chunk, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T, D><<<B * H, D < 128 ? D : 128, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), H, Hkv, S_max, chunk,
      n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const int32_t* lengths, void* out, float* part_acc,
                     float* part_ml, int B, int H, int Hkv, int S_max,
                     int chunk, int n_split, float scale,
                     cudaStream_t stream) {
  if (G <= 1)
    return launch<T, D, 1>(q, k, v, lengths, out, part_acc, part_ml, B, H,
                           Hkv, S_max, chunk, n_split, scale, stream);
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, lengths, out, part_acc, part_ml, B, H,
                           Hkv, S_max, chunk, n_split, scale, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, lengths, out, part_acc, part_ml, B, H,
                           Hkv, S_max, chunk, n_split, scale, stream);
  if (G <= 8)
    return launch<T, D, 8>(q, k, v, lengths, out, part_acc, part_ml, B, H,
                           Hkv, S_max, chunk, n_split, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int D, int G, const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* part_acc,
                   float* part_ml, int B, int H, int Hkv, int S_max,
                   int chunk, int n_split, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return by_group<T, 32>(G, q, k, v, lengths, out, part_acc, part_ml, B,
                             H, Hkv, S_max, chunk, n_split, scale, stream);
    case 64:
      return by_group<T, 64>(G, q, k, v, lengths, out, part_acc, part_ml, B,
                             H, Hkv, S_max, chunk, n_split, scale, stream);
    case 128:
      return by_group<T, 128>(G, q, k, v, lengths, out, part_acc, part_ml, B,
                              H, Hkv, S_max, chunk, n_split, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || chunk % kTile != 0) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(D, G, q, k, v, lengths, out, part_acc, part_ml, B, H,
                         Hkv, S_max, chunk, n_split, scale, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, G, q, k, v, lengths, out, part_acc,
                                 part_ml, B, H, Hkv, S_max, chunk, n_split,
                                 scale, s);
  return cudaErrorInvalidValue;
}
