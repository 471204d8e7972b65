// Fused in-step enforcement kernels: the hierarchical charge and the slot
// gate, for sm_90a.
//
// Replaces the Pallas kernels of the JAX package
//   repro/kernels/enforcement.py::fused_charge_batch (_charge_kernel)
//   repro/kernels/enforcement.py::fused_slot_gate    (_gate_kernel)
//
// What bounds it: neither arithmetic nor bandwidth.  One charge moves a
// few KB and decides m slots one after another, because every slot sees
// the grants of the slots before it (the memcg page-counter
// serialization, the reference's sequential grid).  The device time is
// the launch, a few dependent loads, and the serial chain of decisions;
// at the engine's 8 slots the host's issue pace outlasts all of it.
//
// Design of the charge (charge_kernel):
//   * Only what the slots touch is staged.  A slot touches its
//     self-first ancestor chain (at most kDepth domains); a dead slot
//     (dom < 0) touches domain 0, whose stall counter it rewrites.  CTA 0
//     takes the slots in chunks of at most kChunkMax, in order.  For a
//     chunk, one thread a slot walks its chain from `parent` in device
//     memory once, and inserts each domain into a hash table in shared
//     memory (open addressing, atomicCAS), whose 16-byte entries hold
//     the domain's usage, peak, throttle window and stall counter side
//     by side; the slot's static view (limits, frozen, priority, kind)
//     and its parameter row go into a per-slot record.  Shared memory
//     scales with the chunk, never with n.
//   * One thread takes the decisions in slot order (lane 0 of warp 0):
//     no barrier at all between slots.  What the order forces is short:
//     each level is one 16-byte load of its entry and one 8-byte store
//     of its usage and peak; an invalid level reads a neutral dummy
//     entry (usage 0, window INT32_MIN, limits unlimited) and writes a
//     sink entry, so the decision tests no masks; the next slot's
//     record is read while this one decides; the delay math (divisions,
//     the program's delay, the window) runs only where some level ends
//     over memory.high, since elsewhere the overage fraction is 0 and
//     nothing throttles.  A form with the levels in lanes 0-3 (vote and
//     reduction for the any, max and all, __syncwarp between slots) was
//     no faster on the card (PERF.md).  A domain that appears
//     twice in one chain is added to once per appearance, as the
//     reference's index_add does.
//   * Peak only on the charged chain.  The reference takes
//     max(peak, usage) over all n after every slot.  A domain's usage
//     changes only at granted slots whose chain holds it, so: after slot
//     0 every domain's peak is max(peak_in, usage after slot 0), which is
//     max(peak_in, usage_in) off slot 0's chain; after each later slot
//     only that slot's chain moves; m = 0 leaves peak as it came.  A
//     domain on slot 0's chain never takes usage_in into its max.
//   * The domains no slot touches are copied in -> out (peak with the
//     max above) by the grid's CTAs, 2048 domains each; CTA 0's share is
//     copied by its other warps while warp 0 decides.  Each copying CTA
//     walks the m chains itself to mark what it must skip, so the two
//     sets of writes are disjoint and need no sync between CTAs.
//   * With more slots than one chunk, CTA 0 first copies every touched
//     domain in -> out (peak by the rule above) and keeps each slot's
//     chain in a scratch buffer; each chunk then loads its working set
//     from the outputs and writes it back, in order.  No n or m is
//     refused.
//
// The shard axis.  The sharded backend keeps S independent tables (one a
// device group of the reference's mesh) as a leading axis: every state
// column is (S, n), the parameter table (S, n, P), the slots an (S, m)
// matrix of shard-local indices (-1 off the shard) over shared (m,)
// amounts.  One launch serves all shards: the charge's grid is (ranges x
// shards), blockIdx.y the shard, and each CTA works on its shard's slice
// exactly as the S = 1 kernel works on the whole table (the reference
// runs the single-device kernel per shard under shard_map); the gate
// takes a thread a (shard, slot).  S = 1 is the device table's call.
//
// The gate (gate_kernel) is one thread a slot walking its chain with
// __ldg: its device work was already a four-load walk; what this file
// shares with it is the chain code.  enforcement_empty launches an empty
// kernel through the same path, the launch floor both are measured
// against.
//
// Bit-exactness with the plain torch decision (core/controller.py and
// core/progs.py, themselves held to the JAX reference) rests on:
//   * this file being compiled with --fmad=false, so no multiply-add is
//     contracted behind our back; the two places where the reference
//     (XLA on the CPU) does compute a fused multiply-add use __fmaf_rn;
//   * i32 / i32 overage fractions divided in f32 (never f64);
//   * ceil(delay * (1 / step_ms)) with the f32 reciprocal the reference's
//     constant folding produces (passed in as inv_step);
//   * int32 sums wrapping as XLA's do (done in uint32);
//   * the stall counter saturating at INT32_MAX.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 4;
constexpr int32_t kUnlimited = 2147483647;
constexpr int32_t kInt32Max = 2147483647;
constexpr int32_t kNormal = 1;
constexpr int32_t kHigh = 2;
constexpr int kMaxParams = 16;

// program kinds, as kernels/enforcement.py::_KIND_CODES assigns them
constexpr int kKindBase = 0;         // PolicyProgram: the bare contract
// kind 1: GraduatedThrottleProgram (+ WeightedFair), the default branch
constexpr int kKindTokenBucket = 2;  // TokenBucketProgram

constexpr int kThreads = 256;        // threads of every charge CTA
constexpr int kChunkMax = 256;       // slots a chunk, at most
static_assert(kChunkMax <= kThreads, "one staging thread a slot");
constexpr int kRange = 2048;         // domains each CTA copies
constexpr int32_t kEmpty = -1;       // a free hash entry
constexpr int32_t kNoOwner = 0x7fffffff;

// SlotRec::flags
constexpr uint32_t kLive = 1u << 4;       // bits 0-3: the valid levels
constexpr uint32_t kFrozen = 1u << 5;     // a valid level is frozen
constexpr int kKindShift = 8;             // 4 bits: the program kind
constexpr int kStallShift = 20;           // 12 bits: the stall entry
constexpr int32_t kInt32Min = -2147483647 - 1;

// One slot of a chunk as the deciding thread reads it: each level's
// entry to read (the dummy where the level is invalid) and to write (the
// sink where invalid), the chain's limits (neutral where invalid), the
// f32 overage divisor max(high, 1), what a grant adds to each level (the
// amount times the level's repeats in the chain), and the slot whose copy
// of the charged domain's parameter row is the live one.  For a dead
// slot, lr[0] is the entry whose stall counter it rewrites.
struct __align__(16) SlotRec {
  int32_t lr[kDepth];
  int32_t lw[kDepth];
  int32_t high[kDepth];
  int32_t mx[kDepth];
  int32_t low[kDepth];
  float hf[kDepth];
  int32_t sa[kDepth];
  int32_t amt, prio, row;
  uint32_t flags;
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t saturating_count(int32_t counter,
                                                    int32_t inc) {
  return inc > wrap_sub(kInt32Max, counter) ? kInt32Max
                                             : wrap_add(counter, inc);
}

// self-first ancestor chain of max(d, 0), -1-padded (_ancestor_chain)
__device__ __forceinline__ void ancestor_chain(const int32_t* parent,
                                               int32_t d,
                                               int32_t chain[kDepth]) {
  chain[0] = d < 0 ? 0 : d;
#pragma unroll
  for (int k = 1; k < kDepth; ++k) {
    const int32_t prev = chain[k - 1];
    chain[k] = prev >= 0 ? __ldg(parent + prev) : -1;
  }
}

// the domains slot `d` touches: its chain if live, domain 0 if dead
__device__ __forceinline__ void touched_chain(const int32_t* parent,
                                              int32_t d,
                                              int32_t chain[kDepth]) {
  if (d >= 0) {
    ancestor_chain(parent, d, chain);
    return;
  }
  chain[0] = 0;
#pragma unroll
  for (int k = 1; k < kDepth; ++k) chain[k] = -1;
}

// Shared memory of a charge CTA, carved from one dynamic buffer: the
// hash table's keys and row owners, its entries (+ the dummy and the
// sink), the copy bitmap, slot 0's chain, the chunk's records, parameter
// rows and flags.  The host sizes the launch with the same function.
struct Layout {
  int table, shift;
  size_t keys, owner, ent, bits, chain0, recs, rows, flags, bytes;
};

__host__ __device__ inline Layout layout(int chunk, int P) {
  Layout L;
  L.table = 2 * kDepth * chunk;   // load factor at most 1/2
  int b = 0;
  while ((1 << b) < L.table) ++b;
  L.shift = 32 - b;
  const size_t e = static_cast<size_t>(L.table) * 4;
  L.keys = 0;
  L.owner = L.keys + e;
  L.ent = (L.owner + e + 15) / 16 * 16;   // + the dummy and the sink
  L.bits = L.ent + (static_cast<size_t>(L.table) + 2) * sizeof(int4);
  L.chain0 = L.bits + kRange / 8;
  L.recs = (L.chain0 + kDepth * 4 + 15) / 16 * 16;
  L.rows = L.recs + static_cast<size_t>(chunk) * sizeof(SlotRec);
  L.flags = L.rows + static_cast<size_t>(chunk) * P * 4;
  L.bytes = L.flags + static_cast<size_t>(chunk) * 2;
  return L;
}

// an entry: {usage, peak, throttle_until, mem_stall}
struct Table {
  int32_t* keys;
  int32_t* owner;
  int4* ent;
  uint32_t* bits;
  int32_t* chain0;
  SlotRec* recs;
  float* rows;
  uchar2* flags;   // each slot's granted and stalled
  int table, shift, dummy, sink;
};

// the entry of domain `d`, inserting it if new; *won tells the inserter
__device__ __forceinline__ int insert(const Table& t, int32_t d, bool* won) {
  uint32_t h = (static_cast<uint32_t>(d) * 2654435761u) >> t.shift;
  for (;;) {
    const int32_t old = atomicCAS(&t.keys[h], kEmpty, d);
    if (old == kEmpty || old == d) {
      *won = old == kEmpty;
      return static_cast<int>(h);
    }
    h = (h + 1) & static_cast<uint32_t>(t.table - 1);
  }
}

struct Inputs {
  const int32_t* dom;
  const int32_t* amt;
  const int32_t* parent;
  const int32_t* high;
  const int32_t* max;
  const int32_t* low;
  const uint8_t* frozen;
  const int32_t* priority;
  const int32_t* prog_id;
  const int32_t* usage;
  const int32_t* peak;
  const int32_t* tu;
  const float* prog;
  const int32_t* stall;
};

struct Outputs {
  int4* chains;        // (m,) the slots' chains, with more than one chunk
  int32_t* usage;
  int32_t* peak;
  int32_t* tu;
  int32_t* stall;
  float* prog;
  uint8_t* granted;
  uint8_t* stalled;
};

// Shard s's slice of the (S, n) columns, (S, n, P) rows and (S, m) slots;
// the amounts are shared by every shard.
__device__ __forceinline__ Inputs shard_inputs(Inputs in, int s, int m,
                                               int n, int P) {
  const size_t sn = static_cast<size_t>(s) * n;
  const size_t sm = static_cast<size_t>(s) * m;
  in.dom += sm;
  in.parent += sn;
  in.high += sn;
  in.max += sn;
  in.low += sn;
  in.frozen += sn;
  in.priority += sn;
  in.prog_id += sn;
  in.usage += sn;
  in.peak += sn;
  in.tu += sn;
  in.prog += sn * P;
  in.stall += sn;
  return in;
}

__device__ __forceinline__ Outputs shard_outputs(Outputs out, int s, int m,
                                                 int n, int P) {
  const size_t sn = static_cast<size_t>(s) * n;
  const size_t sm = static_cast<size_t>(s) * m;
  out.chains += sm;
  out.usage += sn;
  out.peak += sn;
  out.tu += sn;
  out.stall += sn;
  out.prog += sn * P;
  out.granted += sm;
  out.stalled += sm;
  return out;
}

// Copy every domain of [lo, hi) that no slot touches (bit clear) in ->
// out; the peak takes usage_in into its max once any slot ran.
__device__ void copy_untouched(const Inputs& in, const Outputs& out,
                               const uint32_t* bits, int lo, int hi, int P,
                               bool any_slot, int tid, int stride) {
  for (int i = lo + tid; i < hi; i += stride) {
    if ((bits[(i - lo) >> 5] >> ((i - lo) & 31)) & 1u) continue;
    const int32_t u = in.usage[i];
    const int32_t p = in.peak[i];
    out.usage[i] = u;
    out.peak[i] = any_slot && u > p ? u : p;
    out.tu[i] = in.tu[i];
    out.stall[i] = in.stall[i];
  }
  const int span = (hi - lo) * P;
  for (int j = tid; j < span; j += stride) {
    const int i = lo + j / P;
    if ((bits[(i - lo) >> 5] >> ((i - lo) & 31)) & 1u) continue;
    out.prog[static_cast<size_t>(lo) * P + j] =
        in.prog[static_cast<size_t>(lo) * P + j];
  }
}

__device__ __forceinline__ void mark(uint32_t* bits, int32_t x, int lo,
                                     int hi) {
  if (x >= lo && x < hi)
    atomicOr(&bits[(x - lo) >> 5], 1u << ((x - lo) & 31));
}

// Chunk setup, one thread a slot, in two halves around the barrier that
// clears the hash table.  First the global loads: the chain (walked, or
// read back from the scratch the first pass wrote), the chain's current
// entries and limits, the slot's record and its copy of the charged
// domain's row.
struct Staged {
  int32_t c[kDepth];
  int4 v[kDepth];
  SlotRec r;
};

__device__ void load_slot(const Table& t, const Inputs& in,
                          const Outputs& out, int z, int s, int P,
                          unsigned long long kinds, int n_kinds,
                          bool chunked, Staged& g) {
  const int32_t d = __ldg(in.dom + z);
  const bool live = d >= 0;
  int32_t* c = g.c;
  if (chunked) {
    const int4 v = out.chains[z];
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  } else {
    touched_chain(in.parent, d, c);
  }
  // the current values: the inputs, or the outputs the first pass and
  // the earlier chunks wrote
  const int32_t* usage = chunked ? out.usage : in.usage;
  const int32_t* peak = chunked ? out.peak : in.peak;
  const int32_t* tu = chunked ? out.tu : in.tu;
  const int32_t* stall = chunked ? out.stall : in.stall;
  const float* prog = chunked ? out.prog : in.prog;

  SlotRec& r = g.r;
  uint32_t flags = live ? kLive : 0u;
  bool frozen = false;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const int32_t x = c[k];
    g.v[k] = x >= 0 ? make_int4(usage[x], peak[x], tu[x], stall[x])
                    : make_int4(0, 0, 0, 0);
    const bool v = live && x >= 0;
    r.high[k] = v ? __ldg(in.high + x) : kUnlimited;
    r.mx[k] = v ? __ldg(in.max + x) : kUnlimited;
    r.low[k] = v ? __ldg(in.low + x) : 0;
    frozen |= v && __ldg(in.frozen + x) != 0;
    if (v) flags |= 1u << k;
  }
  const int32_t di = live ? d : 0;
  r.prio = __ldg(in.priority + di);
  int slot = __ldg(in.prog_id + di);
  slot = slot < 0 ? 0 : (slot > n_kinds - 1 ? n_kinds - 1 : slot);
  flags |= static_cast<uint32_t>((kinds >> (4 * slot)) & 0xF) << kKindShift;
  if (frozen) flags |= kFrozen;
  r.flags = flags;
  r.amt = __ldg(in.amt + z);
  r.row = 0;
  float* my_row = t.rows + static_cast<size_t>(s) * P;
  if (live)
    for (int j = 0; j < P; ++j)
      my_row[j] = prog[static_cast<size_t>(d) * P + j];
}

// Then, after the table is clear: the chain's domains into the hash
// table (the inserting thread writes the entry), the record's entry
// indices, and the slot's claim on the charged domain's row.
__device__ void insert_slot(const Table& t, Staged& g, int s, bool chunked,
                            int range_hi) {
  SlotRec& r = g.r;
  const int32_t* c = g.c;
  int e[kDepth];
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    e[k] = t.dummy;
    if (c[k] < 0) continue;
    bool won;
    e[k] = insert(t, c[k], &won);
    if (won) t.ent[e[k]] = g.v[k];
    if (!chunked) mark(t.bits, c[k], 0, range_hi);
  }
  const uint32_t valid = r.flags & 0xFu;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const bool v = (valid >> k) & 1u;
    r.lr[k] = v ? e[k] : t.dummy;
    r.lw[k] = v ? e[k] : t.sink;
    r.hf[k] = static_cast<float>(r.high[k] > 1 ? r.high[k] : 1);
    uint32_t reps = 0;   // a domain twice in one chain takes two adds
#pragma unroll
    for (int j = 0; j < kDepth; ++j)
      reps += (v && ((valid >> j) & 1u) && c[j] == c[k]) ? 1u : 0u;
    r.sa[k] = static_cast<int32_t>(static_cast<uint32_t>(r.amt) * reps);
  }
  r.flags |= static_cast<uint32_t>(e[0]) << kStallShift;
  r.lr[0] = e[0];   // a dead slot's stall entry; a live slot's own
  if (r.flags & kLive) atomicMin(&t.owner[e[0]], s);
  t.recs[s] = r;
}

// The decisions of one chunk, in slot order, by one thread
// (_decision_one for each slot, then the scatter up the chain, the
// chain's peak, the throttle window, the row and the stall counter);
// each slot's granted and stalled flags wait in shared memory for the
// write-back.
__device__ void decide_chunk(const Table& t, int len, int P, int32_t step,
                             float inv_step) {
  if (len == 0) return;
  // the whole record is fetched ahead into registers: read in the loop,
  // its fields would wait behind the slot's stores to shared memory
  SlotRec next = t.recs[0];
  for (int s = 0; s < len; ++s) {
    const SlotRec r = next;
    int4 e[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) e[k] = t.ent[r.lr[k]];
    if (s + 1 < len) next = t.recs[s + 1];
    const int32_t a = r.amt;
    bool grant = false, stall = false, throttle = false;
    int32_t until = e[0].z;
    if (r.flags & kLive) {
      const int kind = static_cast<int>((r.flags >> kKindShift) & 0xFu);
      float* row = t.rows + static_cast<size_t>(r.row) * P;
      // PolicyProgram.on_charge: the memcg try_charge contract
      bool bad = (r.flags & kFrozen) != 0;
#pragma unroll
      for (int k = 0; k < kDepth; ++k)
        bad |= e[k].z > step || wrap_add(e[k].x, a) > r.mx[k];
      grant = !bad;
      stall = bad;
      if (kind == kKindTokenBucket) {   // TokenBucketProgram.on_charge
        const float cap = row[6];
        const bool enabled = cap > 0.0f;
        const float step_f = static_cast<float>(step);
        const float dt = fmaxf(__fsub_rn(step_f, row[5]), 0.0f);
        const float refill = r.prio == kHigh ? row[9]
                             : (r.prio == kNormal ? row[8] : row[7]);
        float level = fminf(cap, __fmaf_rn(dt, refill, row[4]));
        const float amt_f = static_cast<float>(a);
        const bool have = level >= amt_f;
        const bool base_grant = grant;
        grant = base_grant && (!enabled || have);
        level = (grant && enabled) ? __fsub_rn(level, amt_f) : level;
        stall = stall || (base_grant && enabled && !have);
        if (enabled) {
          row[4] = level;
          row[5] = step_f;
        }
      }
      // post-charge soft-limit math, on the pre-charge parameter row
      const int32_t add = grant ? a : 0;
      int32_t over[kDepth];
      bool any_over = false;
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        over[k] = r.high[k] < kUnlimited
                      ? wrap_sub(wrap_add(e[k].x, add), r.high[k]) : 0;
        any_over |= over[k] > 0;
      }
      if (any_over) {
        // a fraction is > 0 where over > 0, so the max is > 0 and a
        // grant throttles; without it nothing throttles and the delay
        // is never read
        float over_frac = 0.0f;
        bool all_protected = true;
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          float frac = 0.0f;
          if (over[k] > 0)
            frac = __fdiv_rn(static_cast<float>(over[k]), r.hf[k]);
          over_frac = fmaxf(over_frac, frac);
          all_protected = all_protected &&
                          (wrap_add(e[k].x, add) <= r.low[k] || over[k] <= 0);
        }
        float delay = 0.0f;
        if (kind != kKindBase) {   // GraduatedThrottleProgram.delay_ms
          float dl = fminf(row[1], __fmul_rn(row[0],
                                             __fmaf_rn(row[2], over_frac,
                                                       1.0f)));
          if (r.prio == kHigh) dl = __fmul_rn(dl, row[3]);
          delay = all_protected ? 0.0f : dl;
        }
        delay = fmaxf(delay, 0.0f);   // the verdict's own delay is 0
        throttle = grant;
        const int32_t dly =
            static_cast<int32_t>(ceilf(__fmul_rn(delay, inv_step)));
        const int32_t to = wrap_add(step, dly);
        until = throttle && to > until ? to : until;
      }
      // the hierarchical scatter and the chain's peak
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int32_t nu = grant ? wrap_add(e[k].x, r.sa[k]) : e[k].x;
        *reinterpret_cast<int2*>(&t.ent[r.lw[k]]) =
            make_int2(nu, e[k].y > nu ? e[k].y : nu);
      }
      t.ent[r.lr[0]].z = until;
    }
    t.ent[r.lr[0]].w = saturating_count(e[0].w, (stall || throttle) ? 1 : 0);
    t.flags[s] = make_uchar2(grant ? 1 : 0, stall ? 1 : 0);
  }
}

__global__ void __launch_bounds__(kThreads) charge_kernel(
    Inputs all_in, Outputs all_out, int m, int n, int P, int chunk,
    int32_t step, float inv_step, unsigned long long kinds, int n_kinds) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.y is the shard: from here on, its slice is the whole table
  const Inputs in = shard_inputs(all_in, blockIdx.y, m, n, P);
  const Outputs out = shard_outputs(all_out, blockIdx.y, m, n, P);
  const Layout L = layout(chunk, P);
  const int tid = threadIdx.x;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);
  const int lo = blockIdx.x * kRange;
  const int hi = lo + kRange < n ? lo + kRange : n;
  for (int i = tid; i < kRange / 32; i += kThreads) bits[i] = 0;

  if (blockIdx.x > 0) {   // a copying CTA: skip what any slot touches
    __syncthreads();
    for (int z = tid; z < m; z += kThreads) {
      int32_t c[kDepth];
      touched_chain(in.parent, in.dom[z], c);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) mark(bits, c[k], lo, hi);
    }
    __syncthreads();
    copy_untouched(in, out, bits, lo, hi, P, m > 0, tid, kThreads);
    return;
  }

  Table t;
  t.keys = reinterpret_cast<int32_t*>(smem + L.keys);
  t.owner = reinterpret_cast<int32_t*>(smem + L.owner);
  t.ent = reinterpret_cast<int4*>(smem + L.ent);
  t.bits = bits;
  t.chain0 = reinterpret_cast<int32_t*>(smem + L.chain0);
  t.recs = reinterpret_cast<SlotRec*>(smem + L.recs);
  t.rows = reinterpret_cast<float*>(smem + L.rows);
  t.flags = reinterpret_cast<uchar2*>(smem + L.flags);
  t.table = L.table;
  t.shift = L.shift;
  t.dummy = L.table;
  t.sink = L.table + 1;
  const bool chunked = m > chunk;
  // the dummy entry, read by invalid levels and never written: no usage,
  // a window no step is below
  if (tid == 0) t.ent[t.dummy] = make_int4(0, 0, kInt32Min, 0);

  if (chunked) {
    // first pass: every slot's chain into the scratch, every touched
    // domain in -> out, its peak by the rule of the source note
    if (tid == 0) {
      int32_t c[kDepth];
      ancestor_chain(in.parent, in.dom[0], c);
      for (int k = 0; k < kDepth; ++k)
        t.chain0[k] = in.dom[0] >= 0 ? c[k] : -1;
    }
    __syncthreads();
    for (int z = tid; z < m; z += kThreads) {
      int32_t c[kDepth];
      touched_chain(in.parent, in.dom[z], c);
      out.chains[z] = make_int4(c[0], c[1], c[2], c[3]);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int32_t x = c[k];
        if (x < 0) continue;
        bool on0 = false;
        for (int j = 0; j < kDepth; ++j) on0 |= t.chain0[j] == x;
        const int32_t u = in.usage[x];
        const int32_t p = in.peak[x];
        out.usage[x] = u;
        out.peak[x] = !on0 && u > p ? u : p;
        out.tu[x] = in.tu[x];
        out.stall[x] = in.stall[x];
        for (int j = 0; j < P; ++j)
          out.prog[static_cast<size_t>(x) * P + j] =
              in.prog[static_cast<size_t>(x) * P + j];
        mark(bits, x, 0, hi);
      }
    }
    __syncthreads();
  }

  for (int c0 = 0; c0 == 0 || c0 < m; c0 += chunk) {
    const int len = m - c0 < chunk ? m - c0 : chunk;
    // one slot a thread (chunk <= kThreads): its global loads first,
    // in flight while the table is cleared
    Staged g;
    if (tid < len)
      load_slot(t, in, out, c0 + tid, tid, P, kinds, n_kinds, chunked, g);
    for (int i = tid; i < L.table; i += kThreads) {
      t.keys[i] = kEmpty;
      t.owner[i] = kNoOwner;
    }
    __syncthreads();
    if (tid < len) insert_slot(t, g, tid, chunked, hi);
    __syncthreads();
    // each live slot reads the charged domain's row from its first slot
    for (int s = tid; s < len; s += kThreads) {
      SlotRec& r = t.recs[s];
      if (r.flags & kLive)
        r.row = t.owner[static_cast<int>(r.flags >> kStallShift)];
    }
    if (!chunked && len > 0) {
      // peak rule: every entry off slot 0's chain takes usage_in first
      // (slot 0's invalid levels write the sink, no table entry)
      const int32_t* lw0 = t.recs[0].lw;
      for (int e = tid; e < L.table; e += kThreads) {
        if (t.keys[e] == kEmpty) continue;
        bool on0 = false;
        for (int k = 0; k < kDepth; ++k) on0 |= lw0[k] == e;
        int4& v = t.ent[e];
        if (!on0 && v.x > v.y) v.y = v.x;
      }
    }
    __syncthreads();
    if (tid == 0) {
      decide_chunk(t, len, P, step, inv_step);
    } else if (tid >= 32 && c0 == 0) {
      copy_untouched(in, out, bits, 0, hi, P, m > 0, tid - 32,
                     kThreads - 32);
    }
    __syncthreads();
    // write the working set back; rows from each domain's first slot
    for (int s = tid; s < len; s += kThreads) {
      out.granted[c0 + s] = t.flags[s].x;
      out.stalled[c0 + s] = t.flags[s].y;
    }
    for (int e = tid; e < L.table; e += kThreads) {
      const int32_t x = t.keys[e];
      if (x == kEmpty) continue;
      const int4 v = t.ent[e];
      out.usage[x] = v.x;
      out.peak[x] = v.y;
      out.tu[x] = v.z;
      out.stall[x] = v.w;
      const int32_t own = t.owner[e];
      const float* src = own != kNoOwner
          ? t.rows + static_cast<size_t>(own) * P
          : (chunked ? nullptr : in.prog + static_cast<size_t>(x) * P);
      if (src != nullptr)
        for (int j = 0; j < P; ++j)
          out.prog[static_cast<size_t>(x) * P + j] = src[j];
    }
    __syncthreads();
  }
}

// PolicyProgram.on_gate for every stock program: no frozen or throttled
// ancestor.  One thread a (shard, slot) walks its chain in its shard's
// slice of device memory.
__global__ void gate_kernel(const int32_t* __restrict__ dom, int m, int S,
                            int n, int32_t step,
                            const int32_t* __restrict__ parent,
                            const uint8_t* __restrict__ frozen,
                            const int32_t* __restrict__ tu,
                            uint8_t* __restrict__ out) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= S * m) return;
  const size_t sn = static_cast<size_t>(z / m) * n;
  parent += sn;
  frozen += sn;
  tu += sn;
  const int32_t d = __ldg(dom + z);
  int32_t chain[kDepth];
  ancestor_chain(parent, d, chain);
  bool blocked = false;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    if (chain[k] >= 0 && d >= 0)
      blocked |= __ldg(frozen + chain[k]) != 0 ||
                 __ldg(tu + chain[k]) > step;
  }
  out[z] = (d >= 0 && !blocked) ? 1 : 0;
}

__global__ void empty_kernel() {}

int g_smem_optin = 48 * 1024;   // dynamic shared memory allowed so far

}  // namespace

// The outputs live in one buffer `out` of int32 words, in this order
// (kernels/enforcement.py::charge_outputs cuts the same views): usage,
// peak, throttle_until, mem_stall (S n each), prog (S n P, f32), granted
// and stalled (S m bytes each), then the chunk scratch (S m int4, from
// the next 16-byte boundary).  Each is shard-major.
extern "C" int enforcement_charge(
    const int32_t* dom, const int32_t* amt, int m, int S, int32_t step,
    float inv_step, const int32_t* parent, const int32_t* high,
    const int32_t* max_, const int32_t* low, const uint8_t* frozen,
    const int32_t* priority, const int32_t* prog_id, const int32_t* usage_in,
    const int32_t* peak_in, const int32_t* tu_in, const float* prog_in,
    const int32_t* stall_in, int n, int P, unsigned long long kinds,
    int n_kinds, int32_t* out, void* stream) {
  if (P < 1 || P > kMaxParams || n_kinds < 1 || n_kinds > 16 || m < 0 ||
      n < 0 || S < 1 || S > 65535)
    return cudaErrorInvalidValue;
  if (n == 0 && m > 0) return cudaErrorInvalidValue;
  int chunk = 1;
  while (chunk < m && chunk < kChunkMax) chunk <<= 1;
  const Layout L = layout(chunk, P);
  if (static_cast<int>(L.bytes) > g_smem_optin) {
    const cudaError_t err = cudaFuncSetAttribute(
        charge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.bytes));
    if (err != cudaSuccess) return err;
    g_smem_optin = static_cast<int>(L.bytes);
  }
  Inputs in{dom, amt, parent, high, max_, low, frozen, priority, prog_id,
            usage_in, peak_in, tu_in, prog_in, stall_in};
  const size_t nn = static_cast<size_t>(S) * n;
  const size_t mm = static_cast<size_t>(S) * m;
  Outputs o;
  o.usage = out;
  o.peak = o.usage + nn;
  o.tu = o.peak + nn;
  o.stall = o.tu + nn;
  o.prog = reinterpret_cast<float*>(o.stall + nn);
  o.granted = reinterpret_cast<uint8_t*>(o.prog + nn * P);
  o.stalled = o.granted + mm;
  const size_t flags_end = 4 * (4 * nn + nn * P) + 2 * mm;
  o.chains = reinterpret_cast<int4*>(reinterpret_cast<uint8_t*>(out) +
                                     (flags_end + 15) / 16 * 16);
  const dim3 grid(n > kRange ? (n + kRange - 1) / kRange : 1, S);
  charge_kernel<<<grid, kThreads, L.bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      in, o, m, n, P, chunk, step, inv_step, kinds, n_kinds);
  return cudaGetLastError();
}

extern "C" int enforcement_gate(const int32_t* dom, int m, int S, int n,
                                int32_t step, const int32_t* parent,
                                const uint8_t* frozen, const int32_t* tu,
                                uint8_t* out, void* stream) {
  if (m < 0 || S < 1 || n < 0 || static_cast<long long>(S) * m > 2147483647)
    return cudaErrorInvalidValue;
  const int threads = 128;
  const int total = S * m;
  gate_kernel<<<total > 0 ? (total + threads - 1) / threads : 1, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(dom, m, S, n, step,
                                                     parent, frozen, tu,
                                                     out);
  return cudaGetLastError();
}

// The launch floor: an empty kernel through the same ctypes path.
extern "C" int enforcement_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
