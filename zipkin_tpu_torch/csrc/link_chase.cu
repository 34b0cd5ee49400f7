// Pointer-doubling ancestor chase for Hopper (sm_90a), converging on the card.
//
// Replaces the XLA program of zipkin_tpu/ops/linker.py:320-379
// (chase_ancestors: a lax.while_loop at :369). Over n lanes and a sentinel n:
//   par[i]  = parent[i] >= 0 ? parent[i] : n          (par[n] = n)
//   jump[i] = kind[i] != 0 ? i : par[i]               (jump[n] = n)
//   root[i] = par[i]
//   repeat: jump = jump[jump]; root = root[root]
//     until a pass changes neither, or after ceil(log2(n+1)) passes (the cap
//     that ends malformed parent cycles)
//   anc[i]     = a = jump[par[i]], -1 if a == n or kind[a] == 0
//   root_ok[i] = root[i] == n
// Every pass runs in one launch and no pass reads a value back to the host.
//
// What bounds it on the card: not bytes (the inputs and outputs are 25 B a
// lane, 2 us at 2^18 lanes) but the latency of a pass: two dependent random
// gathers and a grid barrier, 6-19 times (6 on the path's forests, 19, the
// cap, on malformed cycles). A thread a lane over ~1,025 blocks reloads
// each lane's own pointers every pass and pays a barrier of ~1,025 arrivals
// plus a flag store and reload: ~12 us a pass at 2^18 lanes. This design
// answers each of those:
//
// - One cooperative block of 1,024 threads on each SM. A thread owns the
//   lanes first, first + stride, ... (K of them, about two at 2^18 + 1 lanes)
//   for the whole launch and keeps their jump and root in registers, so a
//   pass reads only the gathers. Pointers are int32 (the wrapper refuses n + 1
//   past 2^31 - 1); the double-buffered arrays other lanes gather from are
//   int32 [n + 1] each.
// - A thread issues every gather of the pass before it uses any result.
// - A lane whose gather returns the value it holds points at a fixed point
//   (x[x] == x), which stays fixed, so the lane never changes again: after
//   that pass's store both buffers hold its value, and from the next pass on
//   the thread skips its gathers and stores. Late passes then cost little
//   more than the barrier; cycle lanes never converge and run to the cap, as
//   the reference's loop does.
// - The first pass gathers the initial arrays' values from parent and kind
//   themselves (one gather for a kinded lane, two for a kindless one), so
//   they are never materialised and no barrier precedes it; a lane that
//   converges in it stores its value into both buffers.
// - The barrier takes one arrival a block: thread 0 adds 1 (and 1 << 16 when
//   a lane of the block changed) to an arrival word with device-scope
//   acquire/release (cuda::atomic_ref); the last block resets the word and
//   publishes the next generation with "some lane changed" in its low bit,
//   which the others poll for (relaxed loads, then one acquire fence). So a
//   pass's convergence test rides its barrier: no flag store and reload.
//   Thread 0 keeps the generation it last saw in a register (read once, at
//   the start, beside the first loads), so a barrier is the arrival's round
//   trip and the poll's. The arrival word is left at 0 by every barrier and
//   the generation only moves on, so launches need no memset and a graph
//   replays the launch as it was captured. A barrier that never completes
//   traps rather than hang the card.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (zipkin_tpu_torch/kernels.py). Launches on the caller's stream, does
// not synchronise, allocates nothing; returns the launch's CUDA error.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPasses = 64;
constexpr int kMaxOwned = 16;  // lanes a thread holds: up to 16 x 1,024 x the SMs
constexpr unsigned int kArrival = 1u, kChanged = 1u << 16;

using device_u32 = cuda::atomic_ref<unsigned int, cuda::thread_scope_device>;

struct Params {
  const int64_t* parent;  // [n], -1 for a root
  const int64_t* kind;    // [n], 0 for a kindless span
  int n;
  int max_passes;
  int* jump[2];           // [n + 1] each
  int* root[2];           // [n + 1] each
  int* passes;            // []: the passes this launch ran
  int64_t* anc;           // [n]
  uint8_t* root_ok;       // [n] bool
  unsigned int* bar;      // [2]: arrivals (+ changed blocks << 16), generation << 1 | changed
};

__device__ __forceinline__ int par_of(const Params& P, int i) {
  if (i >= P.n) return P.n;
  const int64_t p = __ldg(P.parent + i);
  return p >= 0 ? int(p) : P.n;
}

// Grid barrier over the launch's blocks carrying one bit: whether any
// thread of any block arrived with `changed` set. `seen` is thread 0's copy
// of the generation word as the last barrier left it (loaded once at the
// launch's start), so an arrival is one atomic and a wait one poll.
__device__ __forceinline__ bool grid_sync_any(unsigned int* bar, bool changed, unsigned int& seen) {
  __shared__ unsigned int s_any;
  const bool mine = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    device_u32 count(bar[0]), gen(bar[1]);
    const unsigned int add = kArrival | (mine ? kChanged : 0u);
    const unsigned int before = count.fetch_add(add, cuda::memory_order_acq_rel);
    unsigned int next;
    if ((before & (kChanged - 1)) == gridDim.x - 1) {
      const unsigned int any = ((before + add) >> 16) != 0;
      count.store(0u, cuda::memory_order_relaxed);
      next = (((seen >> 1) + 1u) << 1) | any;
      gen.store(next, cuda::memory_order_release);
    } else {
      // a wait is microseconds; one of a second or more means a block
      // never arrived: fail the launch rather than hang the card
      for (unsigned int spins = 0; (next = gen.load(cuda::memory_order_relaxed)) == seen; ++spins)
        if (spins > (1u << 25)) __trap();
      cuda::atomic_thread_fence(cuda::memory_order_acquire, cuda::thread_scope_device);
    }
    seen = next;
    s_any = next & 1u;
  }
  __syncthreads();
  return s_any != 0;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1) link_chase_kernel(const Params P) {
  const int stride = int(gridDim.x) * kThreads;
  const int first = int(blockIdx.x) * kThreads + int(threadIdx.x);
  const int lanes = P.n + 1;

  int j[K], r[K];
  unsigned int moving = 0;  // bit 2k: lane k's jump still moves, bit 2k + 1: its root
  bool changed = false;
  // the generation before this launch's first barrier (no block can move it
  // before every block has arrived there)
  unsigned int gen = threadIdx.x == 0 ? device_u32(P.bar[1]).load(cuda::memory_order_relaxed) : 0u;

  // pass 0, straight from parent and kind: a lane's initial root is its
  // parent p and its initial jump itself (kinded) or p, so the pass gathers
  // parent[p] and, for a kindless lane, kind[p] (jump0(p) = kind[p] ? p :
  // root0(p)): one or two gathers, not three
  int par[K];  // kept for the answer's gather
  {
    bool kinded[K];
    int64_t gp[K], gk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + k * stride;
      if (i < lanes) {
        par[k] = par_of(P, i);
        kinded[k] = i < P.n && __ldg(P.kind + i) != 0;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + k * stride;
      if (i < lanes) {
        const int x = par[k];
        gp[k] = x < P.n ? __ldg(P.parent + x) : -1;
        gk[k] = !kinded[k] && x < P.n ? __ldg(P.kind + x) : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + k * stride;
      if (i >= lanes) continue;
      const int x = par[k];
      const int r2 = gp[k] >= 0 ? int(gp[k]) : P.n;
      const int j2 = kinded[k] ? i : (gk[k] != 0 ? x : r2);
      j[k] = kinded[k] ? i : x;
      r[k] = x;
      if (j2 != j[k]) {
        moving |= 1u << (2 * k);
        changed = true;
      } else {
        P.jump[1][i] = j2;  // converged: both buffers hold it
      }
      if (r2 != r[k]) {
        moving |= 2u << (2 * k);
        changed = true;
      } else {
        P.root[1][i] = r2;
      }
      j[k] = j2;
      r[k] = r2;
      P.jump[0][i] = j2;
      P.root[0][i] = r2;
    }
  }
  int ran = 1, cur = 0;
  bool any = grid_sync_any(P.bar, changed, gen);

  for (; any && ran < P.max_passes; ++ran) {
    // chosen without indexing the parameter arrays (which would copy them
    // to local memory)
    const int* jc = cur ? P.jump[1] : P.jump[0];
    const int* rc = cur ? P.root[1] : P.root[0];
    int* jn = cur ? P.jump[0] : P.jump[1];
    int* rn = cur ? P.root[0] : P.root[1];
    int gj[K], gr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (moving & (1u << (2 * k))) gj[k] = __ldcg(jc + j[k]);
      if (moving & (2u << (2 * k))) gr[k] = __ldcg(rc + r[k]);
    }
    changed = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + k * stride;
      if (moving & (1u << (2 * k))) {
        if (gj[k] == j[k]) moving &= ~(1u << (2 * k));
        else changed = true;
        j[k] = gj[k];
        jn[i] = gj[k];
      }
      if (moving & (2u << (2 * k))) {
        if (gr[k] == r[k]) moving &= ~(2u << (2 * k));
        else changed = true;
        r[k] = gr[k];
        rn[i] = gr[k];
      }
    }
    cur ^= 1;
    any = grid_sync_any(P.bar, changed, gen);
  }

  // the last pass's buffer holds every lane (a lane that stopped moving
  // earlier is in both)
  const int* jf = cur ? P.jump[1] : P.jump[0];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + k * stride;
    if (i >= P.n) continue;
    const int a = __ldcg(jf + par[k]);
    P.anc[i] = (a == P.n || __ldg(P.kind + a) == 0) ? int64_t(-1) : int64_t(a);
    P.root_ok[i] = r[k] == P.n;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.passes = ran;
}

template <int K>
int launch(const Params& P, int lanes, int sms, cudaStream_t stream) {
  static int per_sm = -1;
  if (per_sm < 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, link_chase_kernel<K>, kThreads, 0);
    if (e != cudaSuccess) return int(e);
  }
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  // one block an SM, and none without lanes (the barrier waits on all)
  long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;
  Params p = P;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(link_chase_kernel<K>),
                                                    dim3(unsigned(blocks)), dim3(kThreads), args, 0, stream);
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

int g_sms = 0;

}  // namespace

// The lanes one launch can hold: kMaxOwned a thread, one 1,024-thread block
// an SM (the wrapper refuses more). 0 if the card cannot be asked.
extern "C" long long link_chase_capacity() {
  if (!g_sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
  }
  return (long long)kMaxOwned * kThreads * g_sms;
}

// scratch: 4 * (n + 1) int32 (two jump and two root buffers); passes: one
// int; bar: 2 u32 words, zero before the first launch and left ready by every
// launch.
extern "C" int link_chase(const void* parent, const void* kind, long long n, int max_passes,
                          void* scratch, void* passes, void* anc, void* root_ok, void* bar,
                          void* stream) {
  if (n <= 0) return 0;
  if (max_passes < 1 || max_passes > kMaxPasses || n + 1 > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  const long long cap = link_chase_capacity();
  if (cap == 0) return int(cudaErrorInvalidDevice);
  const long long lanes = n + 1;
  if (lanes > cap) return int(cudaErrorInvalidValue);
  Params P{};
  P.parent = static_cast<const int64_t*>(parent);
  P.kind = static_cast<const int64_t*>(kind);
  P.n = int(n);
  P.max_passes = max_passes;
  int* s = static_cast<int*>(scratch);
  P.jump[0] = s;
  P.jump[1] = s + lanes;
  P.root[0] = s + 2 * lanes;
  P.root[1] = s + 3 * lanes;
  P.passes = static_cast<int*>(passes);
  P.anc = static_cast<int64_t*>(anc);
  P.root_ok = static_cast<uint8_t*>(root_ok);
  P.bar = static_cast<unsigned int*>(bar);
  // the fewest lanes a thread that hold them all
  const long long threads = (long long)kThreads * g_sms;
  const long long owned = (lanes + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = int(lanes);
  if (owned <= 1) return launch<1>(P, L, g_sms, st);
  if (owned <= 2) return launch<2>(P, L, g_sms, st);
  if (owned <= 4) return launch<4>(P, L, g_sms, st);
  if (owned <= 8) return launch<8>(P, L, g_sms, st);
  return launch<kMaxOwned>(P, L, g_sms, st);
}
