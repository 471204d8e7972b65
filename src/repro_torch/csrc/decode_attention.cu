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
// where row t lies; the paged form also takes dk != dv.
//
// What bounds it: bytes.  Each cached K and V row is read once (2 * len *
// Hkv * d * bytes per slot) and used for G = H / Hkv heads: about 2 * G
// flops per byte in bf16, far below the card's ~295 flop/byte balance
// point.  So the kernel must keep enough bytes in flight to cover the
// memory's latency (~25 KB an SM at 3.35 TB/s) and spend few instructions
// on the rest.  bf16, the serving path, is one launch a call
// (decode_mma_kernel):
//   * a thread-block cluster of `splits` CTAs per (kv head, slot), a
//     power of two up to 8 that the caller derives from B * Hkv, S_max and
//     the SM count (kernels/decode_attention.py::_splits: 2 at the
//     engine's 8 slots x 8 kv heads and S_max 2048, one wave of 128 CTAs;
//     8 at S_max 32768).
//     Each CTA derives from lengths[b], on the device, an equal share of
//     the slot's live 64-key tiles, so the work follows the live length
//     and S_max only bounds it; blockIdx.z ranks the slots by falling
//     length, so the longest start first and the short ones fill in.  At
//     B = 1 (8 kv heads) the 64 CTAs hold 64 of the 132 SMs: one slot's
//     read is then bounded by what 64 SMs with two tiles in flight each
//     can pull; a larger (non-portable) cluster would spread it wider.
//   * K and V tiles (64 keys x d) reach shared memory through a ring of
//     kStages 16-byte cp.async (LDGSTS) stages, rows 16 bytes longer than
//     d so that ldmatrix meets no bank conflict: two tiles (68 KB at d 128)
//     are in flight while the third is used, and two CTAs fit an SM.  At d
//     160 (pixtral-12b) the three stages take 129 KB, one CTA an SM.  Keys
//     at or past the length are zero-filled, not read.  The paged form
//     copies its CTA's page-table entries into shared memory once and
//     issues its copies from there; the entry of a page at or past the
//     length (-1) is never read.
//   * each of the 4 warps owns 16 keys of a tile.  S = Q K^T on mma.sync
//     m16n8k16, the G <= 8 query heads as the rows of the A tile (rows
//     G..15 zero; Q in registers, unscaled, so exact), K by ldmatrix; the
//     online softmax runs on the accumulator fragments (a max over the
//     four lanes of a row, no shared memory); P is rounded once to bf16
//     and packed in registers as the A operand of P V, V by
//     ldmatrix.trans; l sums the rounded P.  One rounding holds both bf16
//     bars, 2e-2 for every element and 1e-2 norm-relative for each slot,
//     with room at S up to 32768 (tests/test_torch_decode_attention.py
//     emulates the kernel's roundings: at most 2.5e-3 a slot).  At ~2 * G
//     flop per byte the tensor cores cut instructions, not time.
//   * the warps' (m, l, acc) merge through shared memory, then the
//     cluster's CTAs through distributed shared memory, each CTA merging
//     and writing a slice of the (G, dv) output from the parts of the CTAs
//     that had tiles: no second launch, no partials in device memory, no
//     scratch.  What stays is a fixed cost a call that grows with the
//     cluster (two cluster barriers, the remote loads, the CTAs' start);
//     `python -m repro_torch.kernels.decode_bench --sweep` times it.
// f32, the parity path, keeps the scalar split_kernel + combine_kernel: a
// CTA per ~256-key chunk reads its rows with 16-byte loads into registers
// (d 160, whose 40 such lanes a row would not divide a warp, with 32 lanes
// of 5 scalar loads each), and a second launch merges the chunks'
// partials from scratch that the caller allocates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kTile = 64;        // keys a CTA takes per pass
constexpr int kMaxGroup = 8;     // query heads per kv head
constexpr int kStages = 3;       // depth of the bf16 kernel's cp.async ring
constexpr int kMaxSplits = 8;    // CTAs of a cluster (the portable limit)
constexpr float kLog2e = 1.4426950408889634f;

// Where cached row t of slot b lies, in rows of (Hkv, d): a dense cache
// holds slot b's rows at b * cap + t; a paged pool holds them in page
// tbl[b, t / page].  Only rows t < lengths[b] are asked for, so a table
// entry of a page that starts at or past the length is never read.
struct Rows {
  const int32_t* tbl;   // (B, npp) page table, or nullptr for a dense cache
  int npp;
  int page;
  int cap;              // S_max, or npp * page
  // t / page as a multiply and a shift (Granlund and Montgomery; exact for
  // 0 <= t < 2^31): a division by a value known only at run time in the
  // bf16 kernel's copy loop is slow enough to bound it
  uint32_t mul;         // ceil(2^(31 + l) / page), l = ceil(log2(page))
  int shift;            // l - 1
  __device__ int page_of(int t) const {
    return page == 1 ? t
                     : static_cast<int>(__umulhi(static_cast<uint32_t>(t),
                                                 mul) >> shift);
  }
  __device__ size_t at(int b, int t) const {
    if (tbl == nullptr) return static_cast<size_t>(b) * cap + t;
    const int j = page_of(t);
    return static_cast<size_t>(tbl[b * npp + j]) * page + (t - j * page);
  }
};

Rows make_rows(const int32_t* tbl, int cap, int page) {
  Rows r{tbl, 0, page, cap, 0u, 0};
  if (tbl != nullptr) {
    int l = 0;
    while ((1ll << l) < page) ++l;
    r.npp = cap / page;
    r.mul = static_cast<uint32_t>(((1ull << (31 + l)) + page - 1) / page);
    r.shift = l - 1;
  }
  return r;
}

// ------------------------------------------------------ f32: two passes

struct Io {
  static constexpr int kVec = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};

// How a row of D f32 values spreads over the lanes of a row group: D / 4
// lanes of one 16-byte load each where that divides a warp (d 32, 64,
// 128), else all 32 lanes of a warp with D / 32 values each, lane l
// holding columns l, l + 32, ... (d 160: 5 a lane; every warp-wide load
// is still one contiguous 128-byte line).
template <int D>
struct RowLanes {
  static constexpr bool kVec4 = D / Io::kVec <= 32 && 32 % (D / Io::kVec) == 0;
  static constexpr int kLanes = kVec4 ? D / Io::kVec : 32;
  static constexpr int kVec = D / kLanes;
  static_assert(kLanes * kVec == D, "a row splits evenly over its lanes");
  __device__ static int col(int lane, int j) {
    return kVec4 ? lane * kVec + j : lane + kLanes * j;
  }
  __device__ static void load(const float* row, int lane, float* out) {
    if constexpr (kVec4) {
      Io::load(row + lane * kVec, out);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = row[lane + kLanes * j];
    }
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int32_t* __restrict__ lengths,
             Rows rows, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int Hkv, int G, int chunk,
             int n_split, float scale) {
  constexpr int GMAX = kMaxGroup;
  using LK = RowLanes<DK>;
  using LV = RowLanes<DV>;
  constexpr int kLanesK = LK::kLanes;          // lanes that share a K row
  constexpr int kRowsK = kThreads / kLanesK;   // K rows in flight per pass
  constexpr int kLanesV = LV::kLanes;
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

  float qf[GMAX][LK::kVec];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      LK::load(q + (static_cast<size_t>(b) * H + kvh * G + g) * DK, lanek,
               qf[g]);
#pragma unroll
      for (int j = 0; j < LK::kVec; ++j) qf[g][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < LK::kVec; ++j) qf[g][j] = 0.0f;
    }
  }
  float acc[GMAX][LV::kVec];
  float m_run[GMAX], l_run[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < LV::kVec; ++j) acc[g][j] = 0.0f;
  }

  const float* kbase = k + static_cast<size_t>(kvh) * DK;
  const float* vbase = v + static_cast<size_t>(kvh) * DV;

  for (int t0 = start; t0 < end; t0 += kTile) {
    // scores of this tile: one row group per key, reduced across lanes
    for (int r = rowk; r < kTile; r += kRowsK) {
      const int t = t0 + r;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.0f;
      if (t < end) {
        float kf[LK::kVec];
        LK::load(kbase + rows.at(b, t) * Hkv * DK, lanek, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int j = 0; j < LK::kVec; ++j) part[g] += qf[g][j] * kf[j];
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
      for (int j = 0; j < LV::kVec; ++j) acc[g][j] *= alpha[g];
    }
    // P.V: each row group accumulates its own rows of the tile
    for (int r = rowv; r < kTile; r += kRowsV) {
      const int t = t0 + r;
      if (t >= end) break;
      float vf[LV::kVec];
      LV::load(vbase + rows.at(b, t) * Hkv * DV, lanev, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float p = scores[g][r];
#pragma unroll
          for (int j = 0; j < LV::kVec; ++j) acc[g][j] += p * vf[j];
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
      for (int j = 0; j < LV::kVec; ++j)
        red[(rowv * GMAX + g) * DV + LV::col(lanev, j)] = acc[g][j];
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
template <int D>
__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               const int32_t* __restrict__ lengths,
                               float* __restrict__ out, int H, int Hkv,
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
    out[static_cast<size_t>(bh) * D + dd] =
        acc / fmaxf(l_all, 1e-30f);
  }
}

// ------------------------------------------- bf16: one launch, mma.sync

// Shared memory of decode_mma_kernel: the ring, then (paged) the CTA's
// page-table entries.  After the last tile the ring holds the merge: a
// part (m[8], l[8], acc[8][DV], f32) for each warp, then the CTA's own.
template <int DK, int DV>
struct MmaSmem {
  static constexpr int kLdK = DK + 8;   // bf16 a row
  static constexpr int kLdV = DV + 8;
  static constexpr int kStage = kTile * (kLdK + kLdV);
  static constexpr size_t kRing = sizeof(bf16) * kStages * kStage;
  static constexpr int kPart = kMaxGroup * (2 + DV);
  static_assert(sizeof(float) * (kThreads / 32 + 1) * kPart <= kRing,
                "the merge fits in the ring");
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  const int32_t* __restrict__ lengths, Rows rows,
                  bf16* __restrict__ out, int Hkv, int G, float c) {
  using S = MmaSmem<DK, DV>;
  constexpr int kWarps = kThreads / 32;
  constexpr int kCk = DK / 8;   // 16-byte chunks of a K row
  constexpr int kCv = DV / 8;
  static_assert(kTile * kCk % kThreads == 0 && kTile * kCv % kThreads == 0,
                "a tile is whole passes of 16-byte copies");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int32_t* pages = reinterpret_cast<int32_t*>(smem + S::kRing);

  const int split = blockIdx.x;   // the CTA's rank in its cluster
  const int splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;         // the head (row) of this lane's fragments
  const int quad = lane % 4;

  // blockIdx.z ranks the slots by falling length (ties by index): the
  // clusters of the longest slots are scheduled first, and the short ones
  // fill in behind them
  __shared__ int slot;
  const int n_slots = gridDim.z;
  for (int i = tid; i < n_slots; i += kThreads) {
    const int li = lengths[i];
    int rank = 0;
    for (int j = 0; j < n_slots; ++j) {
      const int lj = lengths[j];
      rank += lj > li || (lj == li && j < i);
    }
    if (rank == static_cast<int>(blockIdx.z)) slot = i;
  }
  __syncthreads();
  const int b = slot;
  const size_t head0 = (static_cast<size_t>(b) * Hkv + kvh) * G;

  // this CTA's share of the slot's live tiles
  const int len = min(lengths[b], rows.cap);
  const int tiles = (len + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits;
  const int first = min(split * per, tiles);
  const int n = min(per, tiles - first);
  const int t_begin = first * kTile;
  const int p0 = rows.tbl != nullptr ? rows.page_of(t_begin) : 0;
  if (rows.tbl != nullptr && n > 0) {
    const int np = rows.page_of(min(t_begin + n * kTile, len) - 1) - p0 + 1;
    for (int i = tid; i < np; i += kThreads)
      pages[i] = rows.tbl[static_cast<size_t>(b) * rows.npp + p0 + i];
    __syncthreads();
  }
  auto row_of = [&](int t) -> size_t {   // rows of (Hkv, d) before key t
    if (rows.tbl == nullptr) return static_cast<size_t>(b) * rows.cap + t;
    const int j = rows.page_of(t);
    return static_cast<size_t>(pages[j - p0]) * rows.page +
           (t - j * rows.page);
  };
  // a tile's copies: every row's place first (the paged form reads the
  // table once for K and V), then the 16-byte copies; rows at or past the
  // length are zero-filled
  auto load = [&](int i, int stage) {
    constexpr int kNk = kTile * kCk / kThreads, kNv = kTile * kCv / kThreads;
    constexpr size_t kDead = ~static_cast<size_t>(0);
    bf16* ks = ring + stage * S::kStage;
    bf16* vs = ks + kTile * S::kLdK;
    const int t0 = t_begin + i * kTile;
    size_t rk[kNk], rv[kNv];
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      const int t = t0 + (tid + j * kThreads) / kCk;
      rk[j] = t < len ? row_of(t) : kDead;
    }
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int t = t0 + (tid + j * kThreads) / kCv;
      rv[j] = t < len ? row_of(t) : kDead;
    }
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      const int e = tid + j * kThreads, ch = e % kCk;
      const bool live = rk[j] != kDead;
      hopper::cp_async16(ks + e / kCk * S::kLdK + ch * 8,
                         live ? k + (rk[j] * Hkv + kvh) * DK + ch * 8 : k,
                         live ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int e = tid + j * kThreads, ch = e % kCv;
      const bool live = rv[j] != kDead;
      hopper::cp_async16(vs + e / kCv * S::kLdV + ch * 8,
                         live ? v + (rv[j] * Hkv + kvh) * DV + ch * 8 : v,
                         live ? 16 : 0);
    }
  };

  float acc[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float m = -INFINITY;   // this row's running max, in log2 units
  float l = 0.0f;        // this lane's share of the row's sum

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, s);
    hopper::cp_async_commit();
  }

  // Q as the A fragments of S = Q K^T: row g < G, columns 2 * quad + {0,
  // 1} and + 8 of each 16-wide step; rows 8..15 (a[1], a[3]) stay zero
  uint32_t qa[DK / 16][2];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    qa[kk][0] = qa[kk][1] = 0u;
    if (g < G) {
      const bf16* qr = q + (head0 + g) * DK + 16 * kk + 2 * quad;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  for (int i = 0; i < n; ++i) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i is in, and every warp is done with i - 1
    if (i + kStages - 1 < n) load(i + kStages - 1, (i + kStages - 1) % kStages);
    hopper::cp_async_commit();
    const bf16* ks = ring + (i % kStages) * S::kStage;
    const bf16* vs = ks + kTile * S::kLdK;

    float s[2][4] = {};   // keys 16 warp + 0..7 and + 8..15
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t kb[4];
      hopper::ldsm_b<S::kLdK>(kb, ks, 16 * warp, 16 * kk, lane);
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      hopper::mma_16816(s[0], a, kb[0], kb[1]);
      hopper::mma_16816(s[1], a, kb[2], kb[3]);
    }
    // this lane's keys t + {0, 1, 8, 9}, scaled into log2 units and
    // masked at or past the length (zero-filled keys are not masked keys)
    const int t = t_begin + i * kTile + 16 * warp + 2 * quad;
    float x[4] = {s[0][0], s[0][1], s[1][0], s[1][1]};
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = t + (j & 1) + 8 * (j >> 1) < len ? x[j] * c : -INFINITY;
      mx = fmaxf(mx, x[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = exp2f(m - base);
    m = m_new;
    // P rounded once to bf16, as the A fragment of P V (rows 8..15 zero)
    const uint32_t pa[4] = {
        hopper::pack_bf16(exp2f(x[0] - base), exp2f(x[1] - base)), 0u,
        hopper::pack_bf16(exp2f(x[2] - base), exp2f(x[3] - base)), 0u};
    // the rounded values back in f32 (a bf16 is the top half of an f32)
    l = l * alpha + (__uint_as_float(pa[0] << 16) +
                     __uint_as_float(pa[0] & 0xffff0000u)) +
        (__uint_as_float(pa[2] << 16) + __uint_as_float(pa[2] & 0xffff0000u));
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      acc[nt][0] *= alpha;
      acc[nt][1] *= alpha;
    }
#pragma unroll
    for (int nd = 0; nd < DV / 16; ++nd) {
      uint32_t vb[4];
      hopper::ldsm_bt<S::kLdV>(vb, vs, 16 * warp, 16 * nd, lane);
      hopper::mma_16816(acc[2 * nd], pa, vb[0], vb[1]);
      hopper::mma_16816(acc[2 * nd + 1], pa, vb[2], vb[3]);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();   // the ring is free: the merge reuses it

  // the warps' parts, then the CTA's part merged from them
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* parts = reinterpret_cast<float*>(smem);
  if (g < G) {
    float* mine = parts + warp * S::kPart;
    if (quad == 0) {
      mine[g] = m;
      mine[kMaxGroup + g] = l;
    }
    float* arow = mine + 2 * kMaxGroup + g * DV + 2 * quad;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt)
      *reinterpret_cast<float2*>(arow + 8 * nt) =
          make_float2(acc[nt][0], acc[nt][1]);
  }
  __syncthreads();
  float* cta = parts + kWarps * S::kPart;
  for (int e = tid; e < G * DV; e += kThreads) {
    const int gg = e / DV, col = e % DV;
    float mw[kWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = parts[w * S::kPart + gg];
      mx = fmaxf(mx, mw[w]);
    }
    const float base = mx == -INFINITY ? 0.0f : mx;
    float a = 0.0f, ls = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(mw[w] - base);
      a += parts[w * S::kPart + 2 * kMaxGroup + gg * DV + col] * f;
      ls += parts[w * S::kPart + kMaxGroup + gg] * f;
    }
    cta[2 * kMaxGroup + gg * DV + col] = a;
    if (col == 0) {
      cta[gg] = mx;
      cta[kMaxGroup + gg] = ls;
    }
  }
  hopper::cluster_sync();
  // each CTA of the cluster merges the parts of the CTAs that had tiles
  // for a slice of the (G, dv) output and writes it; the remote loads are
  // all issued before the first use, so their latencies overlap
  const int active = per == 0 ? 0 : (tiles + per - 1) / per;
  for (int e = split * kThreads + tid; e < G * DV; e += splits * kThreads) {
    const int gg = e / DV, col = e % DV;
    float mr[kMaxSplits], lr[kMaxSplits], ar[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      mr[r] = -INFINITY;
      lr[r] = ar[r] = 0.0f;
      if (r < active) {
        mr[r] = hopper::ld_dsmem(cta + gg, r);
        lr[r] = hopper::ld_dsmem(cta + kMaxGroup + gg, r);
        ar[r] = hopper::ld_dsmem(cta + 2 * kMaxGroup + gg * DV + col, r);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, mr[r]);
    const float base = mx == -INFINITY ? 0.0f : mx;
    float a = 0.0f, ls = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const float f = exp2f(mr[r] - base);
      a += ar[r] * f;
      ls += lr[r] * f;
    }
    out[(head0 + gg) * DV + col] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
  }
  hopper::cluster_sync();   // no CTA leaves while another reads its part
}

// ------------------------------------------------------------- launchers

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  Rows rows;
  void* out;
  float* part_acc;
  float* part_ml;
  int B, H, Hkv, splits;
  float scale;
  cudaStream_t stream;
};

template <int DK, int DV>
cudaError_t launch_f32(const Args& a) {
  const int keys = (a.rows.cap + a.splits - 1) / a.splits;   // a CTA
  const int chunk = keys <= kTile ? kTile : (keys + kTile - 1) / kTile * kTile;
  split_kernel<DK, DV><<<dim3(a.splits, a.Hkv, a.B), kThreads, 0,
                         a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lengths, a.rows, a.part_acc,
      a.part_ml, a.Hkv, a.H / a.Hkv, chunk, a.splits, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<DV><<<a.B * a.H, DV < 128 ? DV : 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, a.lengths, static_cast<float*>(a.out), a.H,
      a.Hkv, a.rows.cap, chunk, a.splits);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_mma(const Args& a) {
  using S = MmaSmem<DK, DV>;
  if (a.splits > kMaxSplits) return cudaErrorInvalidValue;
  size_t bytes = S::kRing;
  if (a.rows.tbl != nullptr) {   // the most table entries a CTA can need
    const int per = ((a.rows.cap + kTile - 1) / kTile + a.splits - 1) /
                    a.splits;
    bytes += sizeof(int32_t) *
             ((per * kTile + a.rows.page - 1) / a.rows.page + 1);
  }
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.Hkv, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, decode_mma_kernel<DK, DV>, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      a.lengths, a.rows, static_cast<bf16*>(a.out), a.Hkv, a.H / a.Hkv,
      a.scale * kLog2e);
}

template <int DK, int DV>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<DK, DV>(a);
  if (dtype == 1) return launch_mma<DK, DV>(a);
  return cudaErrorInvalidValue;
}

template <int DK>
cudaError_t by_dv(int DV, int dtype, const Args& a) {
  switch (DV) {
    case 32: return launch<DK, 32>(dtype, a);
    case 64: return launch<DK, 64>(dtype, a);
    case 128: return launch<DK, 128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  page_table (B, cap / page) int32
// selects the paged form (k (n_pages, page, Hkv, DK), v (n_pages, page,
// Hkv, DV)); nullptr the dense one (k, v (B, cap, Hkv, D), cap = S_max).
// DK and DV in {32, 64, 128} in any pair, or both 160.
// splits: CTAs per (kv head, slot); in bf16 the cluster size, 1 to 8; in
// f32 the chunks, whose partials take part_acc B*Hkv*splits*G*DV and
// part_ml B*Hkv*splits*G*2 floats of scratch (bf16 reads neither).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int32_t* page_table,
                                const int32_t* lengths, void* out,
                                float* part_acc, float* part_ml, int B, int H,
                                int Hkv, int cap, int page, int DK, int DV,
                                int dtype, int splits, float scale,
                                void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || cap < 0 ||
      splits < 1 || (page_table != nullptr && (page <= 0 || cap % page)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, make_rows(page_table, cap, page), out,
               part_acc, part_ml, B, H, Hkv, splits, scale,
               static_cast<cudaStream_t>(stream)};
  if (DK == 160 || DV == 160)
    return DK == DV ? launch<160, 160>(dtype, a) : cudaErrorInvalidValue;
  switch (DK) {
    case 32: return by_dv<32>(DV, dtype, a);
    case 64: return by_dv<64>(DV, dtype, a);
    case 128: return by_dv<128>(DV, dtype, a);
    default: return cudaErrorInvalidValue;
  }
}
