// HLL register scatter-max for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel zipkin_tpu/ops/pallas_hll.py:update (body
// _kernel), which keeps the whole register file resident in VMEM and applies
// the batch serially as (32, 128)-tile read-modify-writes. On the card the
// lanes run in parallel instead, each raising the registers it names.
//
// Per lane (same bit rules as zipkin_tpu/ops/hll.py:update):
//   bucket = h >> (32 - p)
//   rest   = h & ((1 << (32 - p)) - 1)
//   rho    = rest == 0 ? 33 - p : (32 - p) - floor(log2(rest))
//   regs[row, bucket] = max(regs[row, bucket], rho) for each live target
//
// Two entry points:
//   hll_update       one target: row i32 per lane, dropped outside [0, rows)
//                    (the counterpart of pallas_hll.update);
//   hll_update_step  the ingest step's four targets from one read of each
//                    lane (zipkin_tpu/tpu/ingest.py:77-82,116-122):
//                      hll[clamp(svc, 0, S-1)]          if valid & svc > 0
//                      hll[global_row]                  if valid
//                      tb[slot*R + clamp(svc, 0, S-1)]  if keep & svc > 0
//                      tb[slot*R + global_row]          if keep
//                    the time tier (tb, keep, slot) is optional; a slot at
//                    or past n_slots drops its two targets.
//
// What bounds it on the card. The bytes are few: 11 B a lane in the step
// form (u32 hash bits, i32 svc, bool valid, bool keep, u8 slot), one 4-byte
// word read per distinct register word a live target names, one written per
// word that rises -- about 1.1 MB for a 65,536-lane step on fresh files,
// ~0.33 us at 3.35 TB/s, and the register files (2 MB and 8.4 MB) sit in the
// 50 MB L2. What costs
// is latency and access count: a launch's fixed ramp and drain, every random
// register touch moving a 32-byte sector, and chains of atomics. There is no
// u8 atomic, so a raise is a CAS on the 32-bit word, and k lanes that raise
// different bytes of one word need k CAS round trips one after another. On
// the main path's lanes the eight spans of a trace share a hash, every valid
// lane names the global rows (8,192 traces on 512 words) and the busiest
// services' rows hold many of the traces: on fresh files those chains, not
// the bytes, set the time of a CAS kernel.
//
// What the design does about it:
//   - one launch per step serves all four targets, so the fixed cost is paid
//     once and each lane is read once, bucket and rho computed once; one lane
//     a thread, so many warps keep reads in flight (four lanes a thread with
//     16-byte loads kept fewer warps busy and ran slower);
//   - neighbouring lanes of a warp that name one register merge first (a
//     shuffle max over runs of equal keys): a trace's eight spans name one
//     register of each global row;
//   - the step entry raises without CAS chains: a lane first reads its
//     register (registers never decrease, so one that already holds >= rho
//     is done -- the common case once files fill; a stale read costs only
//     work), and a lane that raises does a fire-and-forget atomicMax of
//     (tag << 5 | rho) into a u32 scratch copy of the files, tagged with the
//     launch so the scratch is never cleared. After a grid barrier (a
//     cooperative launch keeps every block resident) each raising lane
//     stores the register's byte from the scratch: every lane that stores it
//     stores the same maximum, so the bytes need no atomics. Blocks with no
//     raise skip the wait, so a launch on filled files pays no barrier;
//   - the hot global rows go to the scratch like the per-service rows. A
//     block-private copy of the 1 + n_slots global rows in shared memory,
//     folded into the scratch at each round's end, was measured slower on
//     fresh and on filled files (its zero, fold and store passes cost more
//     than the contention they save) and is not kept;
//   - the grid is one wave of resident blocks walking the lanes in rounds,
//     so the launch ends as soon as its last lane does.
// The single-target entry keeps the CAS (uniform rows have short chains),
// after the same merge of neighbouring lanes.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (zipkin_tpu_torch/kernels.py). Launches on the caller's stream, does
// not synchronise, allocates nothing (the caller passes the scratch); returns
// the launch's CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTargets = 4;
constexpr unsigned kRhoBits = 5;  // rho <= 33 - p <= 31
constexpr int kScratchHeader = 32;  // u32 words ahead of the scratch files
                                    // (SCRATCH_HEADER in ops/hll_kernel.py)

struct Params {
  uint8_t* hll;          // [rows, m]: the one target file, or the step's hll
  uint8_t* tb;           // step: [n_slots * hll_rows, m], or null (tier off)
  const int32_t* rows;   // one target: row per lane; step: svc per lane
  const uint32_t* hash;  // u32 hash bits
  const uint8_t* valid;  // bool
  const uint8_t* keep;   // step with tier: bool
  const uint8_t* slot;   // step with tier: u8 slot
  unsigned int* ctr;     // step: two barrier counters, by tag parity
  unsigned int* shll;    // step: u32 scratch of hll, then of tb
  unsigned int* stb;
  int64_t n;
  int64_t n_rows;        // one target: rows of hll
  int max_services, hll_rows, global_row, n_slots;
  int p;
  unsigned int tag;      // step: this launch's scratch tag, 1 .. 2^27 - 1
};

__device__ __forceinline__ unsigned int* word_of(uint8_t* regs, int64_t off) {
  return reinterpret_cast<unsigned int*>(regs + (off & ~int64_t(3)));
}

__device__ __forceinline__ uint32_t rho_of(uint32_t h, int p) {
  const uint32_t rest = h & ((1u << (32 - p)) - 1u);
  // floor(log2(rest)) = 31 - clz(rest) for rest >= 1
  return rest == 0u ? uint32_t(33 - p) : uint32_t(32 - p) - uint32_t(31 - __clz(rest));
}

// One lane: its columns (coalesced 4-byte and 1-byte loads across the warp).
struct Lane {
  uint32_t h;
  int32_t r;  // one target: the row; step: svc
  bool v, k;
  uint32_t s;

  __device__ __forceinline__ Lane(const Params& P, bool tier, int64_t i) {
    const bool in = i < P.n;
    h = in ? P.hash[i] : 0u;
    r = in ? P.rows[i] : 0;
    v = in && P.valid[i];
    k = in && tier && P.keep[i];
    s = (in && tier) ? P.slot[i] : 0u;
  }
};

// Lanes of a warp that name one register and sit side by side (the spans
// of a trace are neighbours) merge: the first lane of each run of equal keys
// gets the run's largest rho, the rest 0. A run's other lanes only drop what
// its first lane then writes, so the result is exact whatever the keys.
// key -1 names no register (rho 0). Every lane of the warp must call it.
__device__ __forceinline__ unsigned int merge_runs(int64_t key, unsigned int rho,
                                                   unsigned int lane) {
  const int64_t prev = __shfl_up_sync(0xFFFFFFFFu, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned int heads = __ballot_sync(0xFFFFFFFFu, head);
  // this lane's run ends just before the next head
  const unsigned int later = lane == 31 ? 0u : heads & (0xFFFFFFFFu << (lane + 1));
  const unsigned int end = later ? unsigned(__ffs(later)) - 2u : 31u;
#pragma unroll
  for (unsigned int d = 1; d < 32; d <<= 1) {  // max over [lane, end]
    const unsigned int o = __shfl_down_sync(0xFFFFFFFFu, rho, d);
    if (lane + d <= end) rho = max(rho, o);
  }
  return head ? rho : 0u;
}

// ---- one target: CAS on the register's word ------------------------------

__global__ void __launch_bounds__(kThreads) hll_rows_kernel(const Params P) {
  const int64_t m = int64_t(1) << P.p;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t warp0 = int64_t(blockIdx.x) * blockDim.x + (threadIdx.x & ~31u);
  for (int64_t w0 = warp0; w0 < P.n; w0 += stride) {  // whole warps: merge_runs
    const Lane L(P, false, w0 + (threadIdx.x & 31u));
    const int64_t off = int64_t(L.r) * m + (L.h >> (32 - P.p));
    const bool live = L.v && L.r >= 0 && L.r < P.n_rows;  // else rho 0 or dropped
    const unsigned int rho = merge_runs(live ? off : int64_t(-1), live ? rho_of(L.h, P.p) : 0u,
                                        threadIdx.x & 31u);
    if (!rho) continue;
    unsigned int* word = word_of(P.hll, off);
    const unsigned int want = rho << (unsigned(off & 3) * 8u);
    // registers never decrease: a read that already shows >= rho proves the
    // lane cannot raise the word, and the atomic is skipped
    unsigned int old = *word, up = __vmaxu4(old, want);
    while (up != old) {
      const unsigned int prev = atomicCAS(word, old, up);
      if (prev == old) break;
      old = prev;  // another lane changed the word: re-test against it
      up = __vmaxu4(old, want);
    }
  }
}

// ---- the step: tagged scratch, grid barrier, plain byte stores -----------

__global__ void __launch_bounds__(kThreads) hll_step_kernel(const Params P) {
  // did this block raise anything this round (two, by round parity: thread
  // 0 clears the next round's flag while others may still read this one)
  __shared__ int raised_by_round[2];
  const int p = P.p;
  const int64_t m = int64_t(1) << p;
  const bool tier = P.tb != nullptr;
  const unsigned int tag = P.tag << kRhoBits;
  const unsigned int tag_mask = ~((1u << kRhoBits) - 1u);
  const unsigned int lane_id = threadIdx.x & 31u;
  if (blockIdx.x == 0 && threadIdx.x == 0) P.ctr[(P.tag + 1) & 1] = 0u;  // the next launch's

  const int64_t per_round = int64_t(gridDim.x) * blockDim.x;
  const int64_t rounds = (P.n + per_round - 1) / per_round;
  for (int64_t round = 0; round < rounds; ++round) {
    int& raised = raised_by_round[round & 1];
    if (threadIdx.x == 0) raised = 0;
    __syncthreads();
    const Lane L(P, tier, round * per_round + int64_t(blockIdx.x) * blockDim.x + threadIdx.x);

    // the register byte offset of each target, and rho (0: not live)
    int64_t off[kTargets];
    unsigned int rho[kTargets];
    {
      const uint32_t bucket = L.h >> (32 - p);
      const uint32_t r = rho_of(L.h, p);
      const int64_t srow = min(max(L.r, 0), P.max_services - 1);
      const bool named = L.r > 0;
      const bool in_tier = L.k && int(L.s) < P.n_slots;
      const int64_t tbase = int64_t(L.s) * P.hll_rows;
      off[0] = srow * m + bucket;                    rho[0] = L.v && named ? r : 0u;
      off[1] = int64_t(P.global_row) * m + bucket;   rho[1] = L.v ? r : 0u;
      off[2] = (tbase + srow) * m + bucket;          rho[2] = in_tier && named ? r : 0u;
      off[3] = (tbase + P.global_row) * m + bucket;  rho[3] = in_tier ? r : 0u;
    }
    // neighbouring lanes that name one register merge: the eight spans of a
    // trace name one register of each global row, and a hop's server and
    // the next hop's client one of their service's rows
#pragma unroll
    for (int t = 0; t < kTargets; ++t) rho[t] = merge_runs(rho[t] ? off[t] : int64_t(-1), rho[t], lane_id);
    // read every register first (in flight together), keep those rho raises
    unsigned int w[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) w[t] = rho[t] ? *word_of(t < 2 ? P.hll : P.tb, off[t]) : 0u;
#pragma unroll
    for (int t = 0; t < kTargets; ++t)
      if (((w[t] >> (unsigned(off[t] & 3) * 8u)) & 0xFFu) >= rho[t]) rho[t] = 0u;
    bool mine = false;
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      if (!rho[t]) continue;
      atomicMax((t < 2 ? P.shll : P.stb) + off[t], tag | rho[t]);
      mine = true;
    }
    if (mine) raised = 1;

    // grid barrier: every block arrives; a block that raised nothing need
    // not wait in the last round (nothing follows it there). After the block
    // barrier, thread 0's fence orders the whole block's atomics before its
    // arrival (a fence is cumulative); a block that wrote nothing needs none
    __syncthreads();
    const bool last = round == rounds - 1;
    if (threadIdx.x == 0) {
      unsigned int* ctr = P.ctr + (P.tag & 1);
      if (raised) __threadfence();
      atomicAdd(ctr, 1u);
      if (raised || !last) {
        const unsigned int target = unsigned(round + 1) * gridDim.x;
        // a wait is microseconds; one of a second or more means a block
        // never arrived: fail the launch rather than hang the card
        for (unsigned int spins = 0; *reinterpret_cast<volatile unsigned int*>(ctr) < target; ++spins) {
          if (spins > (1u << 25)) __trap();
          __nanosleep(32);
        }
        __threadfence();
      }
    }
    __syncthreads();
    if (!raised) continue;

    // every raised register gets the launch's maximum, read from the
    // scratch: all the thread's reads first, so they travel together (the
    // compiler cannot move a read of the scratch past a byte store)
    unsigned int top[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) top[t] = rho[t] ? __ldcg((t < 2 ? P.shll : P.stb) + off[t]) : 0u;
#pragma unroll
    for (int t = 0; t < kTargets; ++t)
      if (rho[t] && (top[t] & tag_mask) == tag) (t < 2 ? P.hll : P.tb)[off[t]] = uint8_t(top[t] & ~tag_mask);
  }
}

// ---- launchers -------------------------------------------------------------

// attributes of the current device, read once (the port drives one card)
int device_attr(cudaDeviceAttr attr, int* cache, int fallback) {
  if (!*cache) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(cache, attr, dev);
    if (*cache <= 0) *cache = fallback;
  }
  return *cache;
}

int g_sms = 0;

int sm_count() { return device_attr(cudaDevAttrMultiProcessorCount, &g_sms, 132); }

bool aligned(const void* ptr, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(ptr) % to) == 0;
}

long long blocks_for(long long n, long long cap) {
  const long long b = (n + kThreads - 1) / kThreads;  // one lane a thread
  return b < cap ? b : cap;
}

int launch_rows(const Params& P, cudaStream_t stream) {
  // every block resident at once (16 of 128 threads fill an SM), grid-stride beyond
  hll_rows_kernel<<<unsigned(blocks_for(P.n, 16LL * sm_count())), kThreads, 0, stream>>>(P);
  return int(cudaGetLastError());
}

int launch_step(Params P, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM
  cudaError_t e = cudaSuccess;
  if (!per_sm) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hll_step_kernel, kThreads, 0);
    if (e != cudaSuccess) return int(e);
  }
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  // every block resident at once (the barrier waits on all of them)
  const long long blocks = blocks_for(P.n, (long long)per_sm * sm_count());
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(hll_step_kernel),
                                  dim3(unsigned(blocks)), dim3(kThreads), args, 0, stream);
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" int hll_update(void* regs, const void* rows, const void* hashes,
                          const void* valid, long long n, long long n_rows,
                          int p, void* stream) {
  if (n <= 0) return 0;
  Params P{};
  P.hll = static_cast<uint8_t*>(regs);
  P.rows = static_cast<const int32_t*>(rows);
  P.hash = static_cast<const uint32_t*>(hashes);
  P.valid = static_cast<const uint8_t*>(valid);
  P.n = n;
  P.n_rows = n_rows;
  P.p = p;
  return launch_rows(P, static_cast<cudaStream_t>(stream));
}

// scratch: kScratchHeader u32 words (two barrier counters), then one u32 per
// register of hll, then of tb; zeroed once by the caller, then left to the
// kernel. tag: 1 .. 2^27 - 1, one more each launch on the same scratch (the
// caller zeroes the scratch again before a tag repeats).
extern "C" int hll_update_step(void* hll, void* tb, const void* hashes,
                               const void* svc, const void* valid,
                               const void* keep, const void* slot,
                               void* scratch, unsigned int tag, long long n,
                               int max_services, int hll_rows, int global_row,
                               int n_slots, int p, void* stream) {
  if (n <= 0) return 0;
  Params P{};
  P.hll = static_cast<uint8_t*>(hll);
  P.tb = static_cast<uint8_t*>(tb);
  P.rows = static_cast<const int32_t*>(svc);
  P.hash = static_cast<const uint32_t*>(hashes);
  P.valid = static_cast<const uint8_t*>(valid);
  P.keep = static_cast<const uint8_t*>(keep);
  P.slot = static_cast<const uint8_t*>(slot);
  P.ctr = static_cast<unsigned int*>(scratch);
  P.shll = P.ctr + kScratchHeader;
  P.stb = P.shll + (int64_t(hll_rows) << p);
  P.tag = tag;
  P.n = n;
  P.max_services = max_services;
  P.hll_rows = hll_rows;
  P.global_row = global_row;
  P.n_slots = tb ? n_slots : 0;
  P.p = p;
  return launch_step(P, static_cast<cudaStream_t>(stream));
}
