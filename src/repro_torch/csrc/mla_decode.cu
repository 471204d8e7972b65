// One-token absorbed MLA decode over a latent cache (DeepSeek-V2's
// serving step), for sm_90a.
//
// Replaces no kernel of the JAX package: its absorbed decode is lax
// (repro/models/attention.py::mla_decode), which the port ran as plain
// torch (models/attention.py), in f32 over every row of the cache.  This
// kernel takes the bf16 serving path; f32 keeps the plain version.
//
// Each query head h of slot b attends the slot's live latent rows
// t < lengths[b]:
//   s[h, t] = q_lat[b, h] . ckv[b, t] + q_rope[b, h] . krope[b, t]
//   out[b, h] = sum_t softmax_t(s[h, :]) ckv[b, t]
// with q_lat (B, H, L) already through W_UK and scaled, q_rope (B, H, R)
// scaled, both in bf16, the latent rows ckv (L = 512 numbers) and krope
// (R = 64) in bf16, out (B, H, L) bf16.  The output projection W_UV and
// W_O stay outside.
//
// What bounds it: the tensor cores, then L2.  Every head of a slot reads
// the same rows, so a row of L + R = 576 bf16 (1,152 bytes) feeds
// H * 2 * (2L + R) flops: ~240 flops a byte at H = 128, near the card's
// ~295 flop/byte balance point, so unlike GQA's decode this one is worth
// the tensor cores.  The design:
//   * a CTA per (32 query heads, slot): the 128 heads of a slot are 4
//     CTAs with neighbouring block indices, which read the same rows at
//     about the same time, so the rows come from HBM once and from L2
//     four times.  blockIdx.y ranks the slots by falling length (the
//     caller's ``order``), so the longest start first and the short ones
//     fill in.  Only the live rows are read: the work follows the
//     lengths, and S_max only bounds it.
//   * 64-row tiles of ckv and krope reach shared memory through a
//     two-stage cp.async ring (16-byte copies, rows padded by 16 bytes so
//     that ldmatrix meets no bank conflict); rows at or past the length
//     are zero-filled, not read.  Q (32 x 576) is loaded once.
//   * S = Q K^T on mma.sync m16n8k16: each of the 8 warps takes 8 keys of
//     the tile for all 32 heads (two m16 tiles), K's fragments two k16
//     steps to an ldmatrix.x4.  The online softmax runs on the fragments:
//     the tile's row maxima and sums meet through shared memory.  P is
//     rounded once to bf16 into shared memory; l sums the unrounded P.
//   * O += P V with V the same ckv tile read transposed (ldmatrix.trans):
//     each warp owns 64 of the 512 output columns of the 32 heads, so its
//     accumulator is 2 x 8 fragments (64 f32 registers a thread).
//   * one launch a call: no split of a slot's rows, no partials in device
//     memory, no scratch.
// Shared memory: Q 35 KB, two stages of (64 x 520 + 64 x 72) bf16 148 KB,
// P 4.6 KB, the row maxima and sums 2 KB: ~190 KB, one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 512;          // latent width (kv_lora_rank)
constexpr int kR = 64;           // rope width
constexpr int kHeads = 32;       // query heads a CTA
constexpr int kTile = 64;        // rows a pass
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdL = kL + 8;     // padded row of a latent tile, in bf16
constexpr int kLdR = kR + 8;
constexpr int kLdP = kTile + 8;
constexpr int kStages = 2;

constexpr int kQBytes = kHeads * (kLdL + kLdR) * 2;
constexpr int kStageBytes = kTile * (kLdL + kLdR) * 2;
constexpr int kPBytes = kHeads * kLdP * 2;
constexpr int kRedBytes = 2 * kWarps * kHeads * 4;
constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + kPBytes +
                           kRedBytes;

struct Args {
  const bf16* q_lat;     // (B, H, L)
  const bf16* q_rope;    // (B, H, R)
  const bf16* ckv;       // slot b's row t at ckv + b * ckv_slot + t * L
  const bf16* krope;     // ... krope + b * kr_slot + t * R
  const int32_t* lengths;
  const int32_t* order;  // slots by falling length
  bf16* out;             // (B, H, L)
  long long ckv_slot, kr_slot;
  int H;
};

// Rows [t0, t0 + 64) of slot b's latent and rope caches into one stage;
// rows at or past ``live`` are zero-filled from row 0's address.
__device__ __forceinline__ void load_tile(const Args& a, int b, int t0,
                                          int live, bf16* sK, bf16* sKr) {
  const bf16* ckv = a.ckv + b * a.ckv_slot;
  const bf16* kr = a.krope + b * a.kr_slot;
  constexpr int kChunksL = kL / 8;            // 16-byte chunks a row
  constexpr int kChunksR = kR / 8;
  for (int i = threadIdx.x; i < kTile * kChunksL; i += kThreads) {
    const int r = i / kChunksL, c = i % kChunksL;
    const int t = t0 + r;
    const bool in = t < live;
    hopper::cp_async16(sK + r * kLdL + c * 8,
                       ckv + (in ? (long long)t * kL : 0) + c * 8,
                       in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kTile * kChunksR; i += kThreads) {
    const int r = i / kChunksR, c = i % kChunksR;
    const int t = t0 + r;
    const bool in = t < live;
    hopper::cp_async16(sKr + r * kLdR + c * 8,
                       kr + (in ? (long long)t * kR : 0) + c * 8,
                       in ? 16 : 0);
  }
}

// Fragments of one n8 tile of keys over two k16 steps from an n-major
// [n][LD] tile: r[0], r[1] are step k's b0, b1; r[2], r[3] step k + 16's.
template <int LD>
__device__ __forceinline__ void ldsm_b2k(uint32_t (&r)[4], const bf16* tile,
                                         int n, int k, int lane) {
  hopper::ldsm_x4(r, tile + (n + lane % 8) * LD + k + 8 * (lane / 8));
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sQr = sQ + kHeads * kLdL;
  bf16* sK0 = sQr + kHeads * kLdR;
  bf16* sP = sK0 + kStages * kTile * (kLdL + kLdR);
  float* sMax = reinterpret_cast<float*>(sP + kHeads * kLdP);
  float* sSum = sMax + kWarps * kHeads;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int h0 = blockIdx.x * kHeads;
  const int b = a.order[blockIdx.y];
  const int live = a.lengths[b];
  const int n_tiles = (live + kTile - 1) / kTile;

  // Q of this CTA's heads, with the first tile
  {
    const bf16* ql = a.q_lat + ((long long)b * a.H + h0) * kL;
    const bf16* qr = a.q_rope + ((long long)b * a.H + h0) * kR;
    for (int i = threadIdx.x; i < kHeads * kL / 8; i += kThreads) {
      const int r = i / (kL / 8), c = i % (kL / 8);
      hopper::cp_async16(sQ + r * kLdL + c * 8, ql + r * kL + c * 8, 16);
    }
    for (int i = threadIdx.x; i < kHeads * kR / 8; i += kThreads) {
      const int r = i / (kR / 8), c = i % (kR / 8);
      hopper::cp_async16(sQr + r * kLdR + c * 8, qr + r * kR + c * 8, 16);
    }
  }
  auto stage_k = [&](int s) { return sK0 + s * kTile * (kLdL + kLdR); };
  auto stage_kr = [&](int s) { return stage_k(s) + kTile * kLdL; };
  if (n_tiles > 0) load_tile(a, b, 0, live, stage_k(0), stage_kr(0));
  hopper::cp_async_commit();

  // this thread's rows: m-tile i, half j -> head row 16 i + lane / 4 + 8 j
  float m_run[2][2], l_run[2][2];
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[i][j] = -INFINITY;
      l_run[i][j] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(a, b, (it + 1) * kTile, live, stage_k((it + 1) % kStages),
                stage_kr((it + 1) % kStages));
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = stage_k(it % kStages);
    const bf16* sKr = stage_kr(it % kStages);

    // S for keys [8 warp, 8 warp + 8) of the tile, 32 heads
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int n0 = 8 * warp;
#pragma unroll 4
    for (int k = 0; k < kL; k += 32) {
      uint32_t bk[4], qa[4];
      ldsm_b2k<kLdL>(bk, sK, n0, k, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        hopper::ldsm_a<kLdL>(qa, sQ, 16 * i, k, lane);
        hopper::mma_16816(s[i], qa, bk[0], bk[1]);
        hopper::ldsm_a<kLdL>(qa, sQ, 16 * i, k + 16, lane);
        hopper::mma_16816(s[i], qa, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int k = 0; k < kR; k += 32) {
      uint32_t bk[4], qa[4];
      ldsm_b2k<kLdR>(bk, sKr, n0, k, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        hopper::ldsm_a<kLdR>(qa, sQr, 16 * i, k, lane);
        hopper::mma_16816(s[i], qa, bk[0], bk[1]);
        hopper::ldsm_a<kLdR>(qa, sQr, 16 * i, k + 16, lane);
        hopper::mma_16816(s[i], qa, bk[2], bk[3]);
      }
    }
    // keys at or past the length take no weight
    const int key = it * kTile + n0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key >= live) s[i][0] = s[i][2] = -INFINITY;
      if (key + 1 >= live) s[i][1] = s[i][3] = -INFINITY;
    }
    // the tile's row maxima: this warp's 8 keys, then every warp's
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = fmaxf(s[i][2 * j], s[i][2 * j + 1]);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (lane % 4 == 0) sMax[warp * kHeads + 16 * i + lane / 4 + 8 * j] = v;
      }
    __syncthreads();
    float alpha[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 16 * i + lane / 4 + 8 * j;
        float mt = sMax[row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, sMax[w * kHeads + row]);
        // the tile's first key is live, so mt is finite
        const float m_new = fmaxf(m_run[i][j], mt);
        alpha[i][j] = __expf(m_run[i][j] - m_new);
        m_run[i][j] = m_new;
        const float p0 = __expf(s[i][2 * j] - m_new);
        const float p1 = __expf(s[i][2 * j + 1] - m_new);
        *reinterpret_cast<uint32_t*>(sP + row * kLdP + n0 + 2 * (lane % 4)) =
            hopper::pack_bf16(p0, p1);
        float sum = p0 + p1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (lane % 4 == 0) sSum[warp * kHeads + row] = sum;
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 16 * i + lane / 4 + 8 * j;
        float st = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) st += sSum[w * kHeads + row];
        l_run[i][j] = l_run[i][j] * alpha[i][j] + st;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[i][n][2 * j] *= alpha[i][j];
          acc[i][n][2 * j + 1] *= alpha[i][j];
        }
      }
    // O[:, 64 warp : 64 warp + 64] += P V
    const int c0 = 64 * warp;
#pragma unroll
    for (int k = 0; k < kTile; k += 16) {
      uint32_t pa[2][4];
      hopper::ldsm_a<kLdP>(pa[0], sP, 0, k, lane);
      hopper::ldsm_a<kLdP>(pa[1], sP, 16, k, lane);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vb[4];
        hopper::ldsm_bt<kLdL>(vb, sK, k, c0 + 8 * n, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          hopper::mma_16816(acc[i][n], pa[i], vb[0], vb[1]);
          hopper::mma_16816(acc[i][n + 1], pa[i], vb[2], vb[3]);
        }
      }
    }
    // every warp is done with this stage, sP and the maxima before the
    // next pass overwrites them
    __syncthreads();
  }
  hopper::cp_async_wait<0>();

  bf16* out = a.out + ((long long)b * a.H + h0) * kL;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = 16 * i + lane / 4 + 8 * j;
      const float inv = 1.f / fmaxf(l_run[i][j], 1e-30f);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * warp + 8 * n + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(out + row * kL + col) =
            hopper::pack_bf16(acc[i][n][2 * j] * inv,
                              acc[i][n][2 * j + 1] * inv);
      }
    }
}

}  // namespace

extern "C" int mla_decode(const void* q_lat, const void* q_rope,
                          const void* ckv, const void* krope,
                          long long ckv_slot, long long kr_slot,
                          const int32_t* lengths, const int32_t* order,
                          void* out, int B, int H, int L, int R,
                          void* stream) {
  if (B == 0) return cudaSuccess;
  if (L != kL || R != kR || H <= 0 || H % kHeads) return cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const Args a{static_cast<const bf16*>(q_lat),
               static_cast<const bf16*>(q_rope),
               static_cast<const bf16*>(ckv),
               static_cast<const bf16*>(krope),
               lengths, order, static_cast<bf16*>(out), ckv_slot, kr_slot, H};
  mla_decode_kernel<<<dim3(H / kHeads, B), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
