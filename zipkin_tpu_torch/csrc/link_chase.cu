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
// The passes run in one launch: the two pointer arrays are double buffered,
// a grid barrier separates the passes, and a per-pass flag in device memory
// that any block sets when one of its lanes changed decides, after the
// barrier, whether every block stops. No pass reads a value back to the host.
//
// What bounds it on the card: bytes, and the latency of dependent gathers. A
// pass reads jump[i] and root[i] (16 B a lane, coalesced), gathers
// jump[jump[i]] and root[root[i]] (random 8-byte reads, a 32-byte sector
// each) and writes 16 B a lane: with n = 2^18 the arrays are 4 MB each and
// sit in the 50 MB L2, so a pass is bound by the gathers' sectors and the
// barrier, not by device memory. Real forests converge in 5-8 passes against
// a cap of 19 at n = 2^18.
//
// The grid barrier is a counter and a generation word in device memory that
// every barrier leaves reset (a cooperative launch keeps every block
// resident), so launches need no memset and a graph replays the launch as it
// was captured. The per-pass flags are cleared by the launch itself before
// its first barrier.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (zipkin_tpu_torch/kernels.py). Launches on the caller's stream, does
// not synchronise, allocates nothing; returns the launch's CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPasses = 64;

struct Params {
  const int64_t* parent;  // [n], -1 for a root
  const int64_t* kind;    // [n], 0 for a kindless span
  int64_t n;
  int max_passes;
  int64_t* jump[2];       // [n + 1] each
  int64_t* root[2];       // [n + 1] each
  int* flags;             // [kMaxPasses]: some lane changed in pass p
  int* passes;            // []: the passes this launch ran
  int64_t* anc;           // [n]
  uint8_t* root_ok;       // [n] bool
  unsigned int* bar;      // [2]: arrivals, generation
};

__device__ __forceinline__ int64_t par_of(const Params& P, int64_t i) {
  if (i >= P.n) return P.n;
  const int64_t p = P.parent[i];
  return p >= 0 ? p : P.n;
}

__global__ void __launch_bounds__(kThreads) link_chase_kernel(const Params P) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t lanes = P.n + 1;

  for (int64_t i = first; i < lanes; i += stride) {
    const int64_t par = par_of(P, i);
    P.jump[0][i] = (i < P.n && P.kind[i] != 0) ? i : par;
    P.root[0][i] = par;
  }
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < kMaxPasses; p += kThreads) P.flags[p] = 0;
  grid_sync(P.bar);

  int cur = 0, ran = 0;
  for (int pass = 0; pass < P.max_passes; ++pass) {
    const int64_t* jc = P.jump[cur];
    const int64_t* rc = P.root[cur];
    bool changed = false;
    for (int64_t i = first; i < lanes; i += stride) {
      const int64_t j = __ldcg(jc + i), r = __ldcg(rc + i);
      const int64_t j2 = __ldcg(jc + j), r2 = __ldcg(rc + r);
      P.jump[cur ^ 1][i] = j2;
      P.root[cur ^ 1][i] = r2;
      changed |= (j2 != j) | (r2 != r);
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) P.flags[pass] = 1;
    grid_sync(P.bar);
    cur ^= 1;
    ++ran;
    if (!__ldcg(P.flags + pass)) break;  // the same flag for every block
  }

  const int64_t* jf = P.jump[cur];
  const int64_t* rf = P.root[cur];
  for (int64_t i = first; i < P.n; i += stride) {
    const int64_t a = __ldcg(jf + par_of(P, i));
    P.anc[i] = (a == P.n || P.kind[a] == 0) ? int64_t(-1) : a;
    P.root_ok[i] = __ldcg(rf + i) == P.n;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.passes = ran;
}

int g_per_sm = 0, g_sms = 0;

}  // namespace

// scratch: 4 * (n + 1) int64 (two jump and two root buffers); flags:
// kMaxPasses ints; passes: one int; bar: 2 u32 words, zero before the first
// launch and left so by every launch.
extern "C" int link_chase(const void* parent, const void* kind, long long n, int max_passes,
                          void* scratch, void* flags, void* passes, void* anc, void* root_ok,
                          void* bar, void* stream) {
  if (n <= 0) return 0;
  if (max_passes < 1 || max_passes > kMaxPasses) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (!g_per_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_per_sm, link_chase_kernel, kThreads, 0);
    if (e != cudaSuccess) return int(e);
    if (g_per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  }
  Params P{};
  P.parent = static_cast<const int64_t*>(parent);
  P.kind = static_cast<const int64_t*>(kind);
  P.n = n;
  P.max_passes = max_passes;
  int64_t* s = static_cast<int64_t*>(scratch);
  const int64_t lanes = n + 1;
  P.jump[0] = s;
  P.jump[1] = s + lanes;
  P.root[0] = s + 2 * lanes;
  P.root[1] = s + 3 * lanes;
  P.flags = static_cast<int*>(flags);
  P.passes = static_cast<int*>(passes);
  P.anc = static_cast<int64_t*>(anc);
  P.root_ok = static_cast<uint8_t*>(root_ok);
  P.bar = static_cast<unsigned int*>(bar);
  // every block resident at once (the barrier waits on all of them)
  long long blocks = (lanes + kThreads - 1) / kThreads;
  const long long resident = (long long)g_per_sm * g_sms;
  if (blocks > resident) blocks = resident;
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(link_chase_kernel),
                                  dim3(unsigned(blocks)), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  return int(e != cudaSuccess ? e : cudaGetLastError());
}
