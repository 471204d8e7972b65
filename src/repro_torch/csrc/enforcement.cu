// Fused in-step enforcement kernels: the hierarchical charge and the slot
// gate, for sm_90a.
//
// Replaces the Pallas kernels of the JAX package
//   repro/kernels/enforcement.py::fused_charge_batch (_charge_kernel)
//   repro/kernels/enforcement.py::fused_slot_gate    (_gate_kernel)
//
// What bounds it: neither arithmetic nor bandwidth.  One charge moves a
// few KB (11 int32 columns and the (n, P) f32 parameter table, n = 40 in
// the engine) and decides m = 8 slots one after another, because every
// slot sees the grants of the slots before it.  Launch latency and the
// serial dependency chain bound it.  The design keeps the whole table in
// shared memory in one CTA, lets one thread walk the slots in order (the
// memcg page-counter serialization), and spends the other threads only on
// the table copies and the elementwise peak update.
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
constexpr int kKindGraduated = 1;    // GraduatedThrottleProgram (+ WeightedFair)
constexpr int kKindTokenBucket = 2;  // TokenBucketProgram

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
  for (int k = 1; k < kDepth; ++k) {
    const int32_t prev = chain[k - 1];
    chain[k] = prev >= 0 ? parent[prev] : -1;
  }
}

struct SharedTable {
  int32_t* parent;
  int32_t* high;
  int32_t* max;
  int32_t* low;
  int32_t* frozen;
  int32_t* priority;
  int32_t* prog_id;
  int32_t* usage;
  int32_t* peak;
  int32_t* tu;
  int32_t* stall;
  float* prog;
};

// One request: the program's verdict, the post-charge soft-limit delay
// and the throttle flag (_decision_one).  `row` is the charged domain's
// parameter row; `new_row` receives the row the verdict writes back.
__device__ void decide(const SharedTable& t, int P, int32_t d, int32_t a,
                       int32_t step, int kind, const float* row,
                       float* new_row, bool* grant_out, bool* stall_out,
                       float* delay_out, bool* throttle_out) {
  int32_t chain[kDepth];
  ancestor_chain(t.parent, d, chain);
  bool valid[kDepth];
  int32_t usage[kDepth], high[kDepth], mx[kDepth], low[kDepth];
  bool frozen[kDepth];
  int32_t tu[kDepth];
  for (int k = 0; k < kDepth; ++k) {
    valid[k] = chain[k] >= 0 && d >= 0;
    const int32_t c = chain[k] < 0 ? 0 : chain[k];
    usage[k] = valid[k] ? t.usage[c] : 0;
    high[k] = valid[k] ? t.high[c] : kUnlimited;
    mx[k] = valid[k] ? t.max[c] : kUnlimited;
    low[k] = valid[k] ? t.low[c] : 0;
    frozen[k] = valid[k] && t.frozen[c] != 0;
    tu[k] = valid[k] ? t.tu[c] : 0;
  }
  const int32_t di = d < 0 ? 0 : d;
  const int32_t prio = t.priority[di];
  for (int j = 0; j < P; ++j) new_row[j] = row[j];

  // PolicyProgram.on_charge: the memcg try_charge contract
  bool any_frozen = false, throttled = false, over_max = false;
  for (int k = 0; k < kDepth; ++k) {
    any_frozen |= valid[k] && frozen[k];
    throttled |= valid[k] && tu[k] > step;
    over_max |= valid[k] && wrap_add(usage[k], a) > mx[k];
  }
  bool grant = !(any_frozen || throttled || over_max);
  bool stall = !grant;
  const float v_delay = 0.0f;

  if (kind == kKindTokenBucket) {   // TokenBucketProgram.on_charge
    const float cap = row[6];
    const bool enabled = cap > 0.0f;
    const float step_f = static_cast<float>(step);
    const float dt = fmaxf(__fsub_rn(step_f, row[5]), 0.0f);
    const float refill = prio == kHigh ? row[9]
                         : (prio == kNormal ? row[8] : row[7]);
    float level = fminf(cap, __fmaf_rn(dt, refill, row[4]));
    const float amt_f = static_cast<float>(a);
    const bool have = level >= amt_f;
    const bool base_grant = grant;
    grant = base_grant && (!enabled || have);
    level = (grant && enabled) ? __fsub_rn(level, amt_f) : level;
    stall = stall || (base_grant && enabled && !have);
    if (enabled) {
      new_row[4] = level;
      new_row[5] = step_f;
    }
  }

  // post-charge soft-limit math, on the pre-charge parameter row
  const int32_t add = grant ? a : 0;
  float over_frac = 0.0f;
  bool all_protected = true;
  for (int k = 0; k < kDepth; ++k) {
    const int32_t nu = valid[k] ? wrap_add(usage[k], add) : 0;
    const int32_t over =
        (valid[k] && high[k] < kUnlimited) ? wrap_sub(nu, high[k]) : 0;
    const bool prot = valid[k] ? nu <= low[k] : true;
    const float h = static_cast<float>(high[k] > 1 ? high[k] : 1);
    const float frac =
        over > 0 ? __fdiv_rn(static_cast<float>(over), h) : 0.0f;
    over_frac = fmaxf(over_frac, frac);
    all_protected = all_protected && (prot || over <= 0);
  }
  float delay = 0.0f;
  if (kind != kKindBase) {   // GraduatedThrottleProgram.delay_ms
    float dl = fminf(row[1],
                     __fmul_rn(row[0], __fmaf_rn(row[2], over_frac, 1.0f)));
    if (prio == kHigh) dl = __fmul_rn(dl, row[3]);
    delay = all_protected ? 0.0f : dl;
  }
  *delay_out = fmaxf(delay, v_delay);
  *throttle_out = grant && (over_frac > 0.0f || v_delay > 0.0f);
  *grant_out = grant;
  *stall_out = stall;
}

__global__ void charge_kernel(
    const int32_t* __restrict__ dom, const int32_t* __restrict__ amt, int m,
    int32_t step, float inv_step, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ high, const int32_t* __restrict__ max_,
    const int32_t* __restrict__ low, const uint8_t* __restrict__ frozen,
    const int32_t* __restrict__ priority,
    const int32_t* __restrict__ prog_id,
    const int32_t* __restrict__ usage_in, const int32_t* __restrict__ peak_in,
    const int32_t* __restrict__ tu_in, const float* __restrict__ prog_in,
    const int32_t* __restrict__ stall_in, int n, int P,
    unsigned long long kinds, int n_kinds, int32_t* __restrict__ usage_out,
    int32_t* __restrict__ peak_out, int32_t* __restrict__ tu_out,
    float* __restrict__ prog_out, int32_t* __restrict__ stall_out,
    uint8_t* __restrict__ granted, uint8_t* __restrict__ stalled) {
  extern __shared__ int32_t smem[];
  SharedTable t;
  t.parent = smem;
  t.high = t.parent + n;
  t.max = t.high + n;
  t.low = t.max + n;
  t.frozen = t.low + n;
  t.priority = t.frozen + n;
  t.prog_id = t.priority + n;
  t.usage = t.prog_id + n;
  t.peak = t.usage + n;
  t.tu = t.peak + n;
  t.stall = t.tu + n;
  t.prog = reinterpret_cast<float*>(t.stall + n);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    t.parent[i] = parent[i];
    t.high[i] = high[i];
    t.max[i] = max_[i];
    t.low[i] = low[i];
    t.frozen[i] = frozen[i];
    t.priority[i] = priority[i];
    t.prog_id[i] = prog_id[i];
    t.usage[i] = usage_in[i];
    t.peak[i] = peak_in[i];
    t.tu[i] = tu_in[i];
    t.stall[i] = stall_in[i];
  }
  for (int i = threadIdx.x; i < n * P; i += blockDim.x) t.prog[i] = prog_in[i];
  __syncthreads();

  for (int z = 0; z < m; ++z) {
    if (threadIdx.x == 0) {
      const int32_t d = dom[z];
      const int32_t a = amt[z];
      const bool live = d >= 0;
      const int32_t di = live ? d : 0;
      int slot = t.prog_id[di];
      slot = slot < 0 ? 0 : (slot > n_kinds - 1 ? n_kinds - 1 : slot);
      const int kind = static_cast<int>((kinds >> (4 * slot)) & 0xF);
      float* row = t.prog + static_cast<size_t>(di) * P;
      float new_row[kMaxParams];
      bool grant, stall, throttle;
      float delay;
      decide(t, P, d, a, step, kind, row, new_row, &grant, &stall, &delay,
             &throttle);
      grant = grant && live;
      stall = stall && live;
      if (grant) {   // hierarchical usage scatter up the chain
        int32_t chain[kDepth];
        ancestor_chain(t.parent, d, chain);
        for (int k = 0; k < kDepth; ++k)
          if (chain[k] >= 0) t.usage[chain[k]] = wrap_add(t.usage[chain[k]], a);
      }
      const int32_t dly = static_cast<int32_t>(ceilf(__fmul_rn(delay, inv_step)));
      if (live) {
        const int32_t old = t.tu[di];
        const int32_t until = wrap_add(step, dly);
        t.tu[di] = throttle ? (old > until ? old : until) : old;
        for (int j = 0; j < P; ++j) row[j] = new_row[j];
      }
      const int32_t inc = live && (stall || throttle) ? 1 : 0;
      t.stall[di] = saturating_count(t.stall[di], inc);
      granted[z] = grant ? 1 : 0;
      stalled[z] = stall ? 1 : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      t.peak[i] = t.peak[i] > t.usage[i] ? t.peak[i] : t.usage[i];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    usage_out[i] = t.usage[i];
    peak_out[i] = t.peak[i];
    tu_out[i] = t.tu[i];
    stall_out[i] = t.stall[i];
  }
  for (int i = threadIdx.x; i < n * P; i += blockDim.x) prog_out[i] = t.prog[i];
}

// PolicyProgram.on_gate for every stock program: no frozen or throttled
// ancestor.  One thread per slot walks its chain in device memory.
__global__ void gate_kernel(const int32_t* __restrict__ dom, int m,
                            int32_t step, const int32_t* __restrict__ parent,
                            const uint8_t* __restrict__ frozen,
                            const int32_t* __restrict__ tu,
                            uint8_t* __restrict__ out) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= m) return;
  const int32_t d = dom[z];
  int32_t chain[kDepth];
  ancestor_chain(parent, d, chain);
  bool blocked = false;
  for (int k = 0; k < kDepth; ++k) {
    if (chain[k] >= 0 && d >= 0)
      blocked |= frozen[chain[k]] != 0 || tu[chain[k]] > step;
  }
  out[z] = (d >= 0 && !blocked) ? 1 : 0;
}

}  // namespace

extern "C" int enforcement_charge(
    const int32_t* dom, const int32_t* amt, int m, int32_t step,
    float inv_step, const int32_t* parent, const int32_t* high,
    const int32_t* max_, const int32_t* low, const uint8_t* frozen,
    const int32_t* priority, const int32_t* prog_id, const int32_t* usage_in,
    const int32_t* peak_in, const int32_t* tu_in, const float* prog_in,
    const int32_t* stall_in, int n, int P, unsigned long long kinds,
    int n_kinds, int32_t* usage_out, int32_t* peak_out, int32_t* tu_out,
    float* prog_out, int32_t* stall_out, uint8_t* granted, uint8_t* stalled,
    void* stream) {
  if (P > kMaxParams || n_kinds < 1 || n_kinds > 16) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(n) * (11 + P) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        charge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  charge_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      dom, amt, m, step, inv_step, parent, high, max_, low, frozen, priority,
      prog_id, usage_in, peak_in, tu_in, prog_in, stall_in, n, P, kinds,
      n_kinds, usage_out, peak_out, tu_out, prog_out, stall_out, granted,
      stalled);
  return cudaGetLastError();
}

extern "C" int enforcement_gate(const int32_t* dom, int m, int32_t step,
                                const int32_t* parent, const uint8_t* frozen,
                                const int32_t* tu, uint8_t* out,
                                void* stream) {
  if (m == 0) return cudaSuccess;
  const int threads = 32;
  gate_kernel<<<(m + threads - 1) / threads, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(dom, m, step, parent,
                                                     frozen, tu, out);
  return cudaGetLastError();
}
