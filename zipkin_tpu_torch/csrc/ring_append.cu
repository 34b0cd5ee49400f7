// Retention-ring append for Hopper (sm_90a): the stable compaction of a
// batch's valid lanes into the ring, pad lanes dropped.
//
// Replaces the XLA program of zipkin_tpu/tpu/ingest.py:138-151,187-206:
//   order = argsort(~valid)                      (stable: valid lanes first)
//   live  = sum(valid)
//   pos   = lane < live ? (ring_pos + lane) % R : R
//   col   = col.at[pos].set(new[order], mode="drop")   for every ring column
// which XLA compiles to a sort and one scatter a column. Here the valid lane
// of rank k (its count of valid lanes before it) goes to (ring_pos + k) % R
// directly: the rank is an exclusive prefix count of the valid flags, so no
// sort and no index vector are materialised, and a pad lane is never written.
//
// Per column the caller gives a source [n] (or none: the column is cleared,
// as r_rolled is) and a destination [R] of the same element size (1 or 8
// bytes: the ring's bool and int64 leaves). ring_pos is read from the device.
//
// What bounds it on the card: bytes. A lane's columns are read once (about
// 92 B at the default layout) and a live lane's ring cells written once
// (about 93 B), ~24 MB for a 2^17-lane batch: ~7 us at 3.35 TB/s. The writes
// of neighbouring valid lanes land on neighbouring ring cells, so the warp's
// stores coalesce where the batch has few pads.
//
// The design: one cooperative launch of resident blocks, each owning a
// contiguous chunk of lanes. A block counts its valid lanes, a grid barrier
// publishes the counts, each block sums the counts before its own (its base
// rank) and walks its chunk a tile at a time with a block-wide exclusive scan
// of the flags (warp ballots, then the eight warp totals), writing every
// column of each valid lane. The grid barrier is a counter and a generation
// word in device memory that every barrier leaves reset, so launches need no
// memset and a graph replays the launch as it was captured.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (zipkin_tpu_torch/kernels.py). Launches on the caller's stream, does
// not synchronise, allocates nothing; returns the launch's CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;

struct Col {
  const void* src;  // [n], or null: the destination is cleared
  void* dst;        // [cap]
  int size;         // element bytes of both: 1 or 8
};

struct Params {
  const uint8_t* valid;     // [n] bool
  const int64_t* ring_pos;  // [] the cursor before the append
  int64_t n, cap;
  int64_t chunk;            // lanes a block owns (a multiple of kThreads)
  int n_cols;
  Col cols[kMaxCols];
  unsigned int* bar;        // [2]: arrivals, generation
  int* block_live;          // [gridDim.x] valid lanes of each block's chunk
};

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, d);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) ring_append_kernel(const Params P) {
  __shared__ int warp_tot[kWarps];
  const int64_t lo = int64_t(blockIdx.x) * P.chunk;
  const int64_t hi = min(P.n, lo + P.chunk);

  // 1. this block's valid lanes
  int mine = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) mine += P.valid[i] != 0;
  mine = block_sum(mine, warp_tot);
  if (threadIdx.x == 0) P.block_live[blockIdx.x] = mine;
  grid_sync(P.bar);

  // 2. the base rank: the valid lanes of every block before this one
  int before = 0;
  for (unsigned int b = threadIdx.x; b < blockIdx.x; b += kThreads) before += __ldcg(P.block_live + b);
  int64_t rank = block_sum(before, warp_tot);
  const int64_t start = *P.ring_pos;

  // 3. tile by tile: each valid lane's rank, then its columns
  const unsigned int lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  for (int64_t t0 = lo; t0 < hi; t0 += kThreads) {
    const int64_t i = t0 + threadIdx.x;
    const bool v = i < hi && P.valid[i] != 0;
    const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, v);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int warp_base = 0, tile = 0;
    for (unsigned int w = 0; w < kWarps; ++w) {
      warp_base += w < warp ? warp_tot[w] : 0;
      tile += warp_tot[w];
    }
    if (v) {
      const int64_t k = rank + warp_base + __popc(ballot & ((1u << lane) - 1u));
      const int64_t pos = (start + k) % P.cap;
      for (int c = 0; c < P.n_cols; ++c) {
        const Col& C = P.cols[c];
        if (C.size == 8) {
          static_cast<int64_t*>(C.dst)[pos] = C.src ? static_cast<const int64_t*>(C.src)[i] : 0;
        } else {
          static_cast<uint8_t*>(C.dst)[pos] = C.src ? static_cast<const uint8_t*>(C.src)[i] : 0;
        }
      }
    }
    rank += tile;
    __syncthreads();  // warp_tot is rewritten by the next tile
  }
}

int g_per_sm = 0, g_sms = 0;

}  // namespace

// Columns: srcs[c] ([n] or null), dsts[c] ([cap]), sizes[c] (1 or 8).
// bar: 2 u32 words, zero before the first launch and left so by every launch;
// block_live: one int a block, at least max_blocks.
extern "C" int ring_append(const void* valid, const void* ring_pos, long long n, long long cap,
                           int n_cols, const void* const* srcs, void* const* dsts,
                           const int* sizes, void* bar, void* block_live, int max_blocks,
                           void* stream) {
  if (n <= 0) return 0;
  if (n_cols < 1 || n_cols > kMaxCols || cap <= 0) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (!g_per_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_per_sm, ring_append_kernel, kThreads, 0);
    if (e != cudaSuccess) return int(e);
    if (g_per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  }
  Params P{};
  P.valid = static_cast<const uint8_t*>(valid);
  P.ring_pos = static_cast<const int64_t*>(ring_pos);
  P.n = n;
  P.cap = cap;
  P.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) P.cols[c] = Col{srcs[c], dsts[c], sizes[c]};
  P.bar = static_cast<unsigned int*>(bar);
  P.block_live = static_cast<int*>(block_live);
  // every block resident at once (the barrier waits on all of them)
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)g_per_sm * g_sms;
  if (blocks > resident) blocks = resident;
  if (blocks > max_blocks) blocks = max_blocks;
  const long long tiles = (n + kThreads - 1) / kThreads;
  P.chunk = ((tiles + blocks - 1) / blocks) * kThreads;
  blocks = (n + P.chunk - 1) / P.chunk;  // no block without lanes
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ring_append_kernel),
                                  dim3(unsigned(blocks)), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  return int(e != cudaSuccess ? e : cudaGetLastError());
}
