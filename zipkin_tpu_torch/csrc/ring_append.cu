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
// What bounds it on the card: bytes at the largest batches, latency at the
// rest. A lane's columns are read once (about 92 B at the default layout)
// and a live lane's ring cells written once (about 93 B): ~24 MB for a
// 2^17-lane batch, ~7 us at 3.35 TB/s, but 0.75 MB (0.23 us) for the
// 4,096-lane batches of the line-rate path, where the launch and its chain
// of memory round trips are the whole time: a cooperative launch with a
// grid barrier costs ~6 us with nothing to move. So the kernel has no grid
// barrier and no cooperative launch, and no block copies more than a few
// hundred lanes, since one SM moves only ~50-100 GB/s however many loads its
// threads issue.
//
// One block of 256 threads takes a 256-lane tile, one lane a thread, in a
// single pass with decoupled look-back. Each thread reads its flag once, and a block scan
// (warp shuffles, then the warp totals) gives its lane's rank in the tile;
// the thread writes the tile offset of its valid lane, in order, into
// shared memory. Then thread k of the block takes the tile's k-th valid lane
// and loads all its columns before it stores any, so a warp's loads come
// from neighbouring lanes and its stores go to neighbouring ring cells of
// one column. The wrap is one conditional subtract (the cursor and every
// rank are below R). A tile without a valid lane copies nothing.
//
// Block b owns tile b (blocks start in index order, so a tile waits only on
// blocks already running), publishes its tile's count in its status word,
// then walks back over its predecessors' words 32 at a time with one warp,
// adding counts until it meets an inclusive prefix, and publishes its own
// inclusive prefix. Each status word is 64 bits: the launch's epoch, a flag
// (count or prefix) and the value. The epoch is a device word that the last
// block past its look-back advances (with the count of such blocks reset to
// 0), so a word of an earlier launch reads as "not yet" and no memset enters
// a captured graph; when the epoch wraps to 0 that block clears the status
// words. Launches that share the words run one after another (one stream
// orders them). A batch of one tile (up to 256 lanes) is one block whose
// look-back is a single store, so small batches need no kernel of their own.
//
// A launch's fixed cost is its chain of memory round trips, so each is
// overlapped where it can be: the cursor and the epoch are loaded beside
// the flag, a block's column loads travel while warp 0 looks back,
// and the finish count's atomic returns while the block stores. The
// critical path is the flag, then the look-back or the column loads.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (zipkin_tpu_torch/kernels.py). Launches on the caller's stream, does
// not synchronise, allocates nothing; returns the launch's CUDA error.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                           // a block's threads
constexpr int kMaxCols = 16;
constexpr int kTileLanes = kThreads;                    // lanes of a block: one a thread
constexpr int kMaxTiles = 4096;                         // status words: batches up to 2^20 lanes
constexpr int kHeaderWords = 2;                         // u32 words before the status words
constexpr int kEpochWord = 0, kDoneWord = 1;
constexpr unsigned long long kFlagCount = 1ull << 30, kFlagPrefix = 2ull << 30;
constexpr unsigned long long kValueMask = (1ull << 30) - 1;

using device_u32 = cuda::atomic_ref<unsigned int, cuda::thread_scope_device>;
using device_u64 = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

struct Col {
  const void* src;  // [n], or null: the destination is cleared
  void* dst;        // [cap]
  int size;         // element bytes of both: 1 or 8
};

struct Params {
  const uint8_t* valid;     // [n] bool
  const int64_t* ring_pos;  // [] the cursor before the append
  int64_t n, cap;
  int n_cols;
  Col cols[kMaxCols];
  unsigned int* words;             // [kHeaderWords]: epoch, blocks past their look-back
  unsigned long long* status;      // [kMaxTiles]: epoch << 32 | flag | value
};

// Exclusive prefix of v over the block, and the block's total in *total
// (warp_tot holds kThreads / 32 + 1 ints).
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? warp_tot[lane] : 0;
    int ti = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, ti, d);
      if (lane >= d) ti += y;
    }
    if (lane < kWarps) warp_tot[lane] = ti - t;
    if (lane == 31) warp_tot[kWarps] = ti;
  }
  __syncthreads();
  const int excl = warp_tot[warp] + incl - v;
  *total = warp_tot[kWarps];
  __syncthreads();  // warp_tot is rewritten by the next scan
  return excl;
}

// The valid lanes of the tile [lane0, lane0 + kTileLanes): their offsets in
// the tile, in lane order, into sidx; returns how many. `header` runs once
// the thread's flag load is issued, so the loads it makes travel beside it
// (the block's first barrier publishes what it stores).
template <typename Header>
__device__ __forceinline__ int rank_tile(const Params& P, int64_t lane0, uint16_t* sidx, int* warp_tot,
                                         Header header) {
  const int64_t lane = lane0 + threadIdx.x;
  const bool valid = lane < P.n && P.valid[lane];
  header();
  int live = 0;
  const int k = block_scan(valid ? 1 : 0, warp_tot, &live);
  if (valid) sidx[k] = uint16_t(threadIdx.x);
  __syncthreads();
  return live;
}

// One lane's columns: every load is issued before any value is used (a
// lane's loads are one memory round trip), then its ring cells are stored.
__device__ __forceinline__ void load_lane(const Params& P, int64_t lane, uint64_t (&v)[kMaxCols]) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const Col& C = P.cols[c];
    v[c] = 0;
    if (c < P.n_cols && C.src)
      v[c] = C.size == 8 ? uint64_t(static_cast<const int64_t*>(C.src)[lane])
                         : uint64_t(static_cast<const uint8_t*>(C.src)[lane]);
  }
}

__device__ __forceinline__ void store_lane(const Params& P, int64_t pos, const uint64_t (&v)[kMaxCols]) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const Col& C = P.cols[c];
    if (c >= P.n_cols) continue;
    if (C.size == 8) static_cast<int64_t*>(C.dst)[pos] = int64_t(v[c]);
    else static_cast<uint8_t*>(C.dst)[pos] = uint8_t(v[c]);
  }
}

// The ring cell of rank `rank` past the cursor: one conditional subtract.
__device__ __forceinline__ int64_t cell(const Params& P, int64_t start, int64_t rank) {
  const int64_t pos = start + rank;
  return pos >= P.cap ? pos - P.cap : pos;
}

// The cursor in [0, R) (one % a block: the ranks need none).
__device__ __forceinline__ long long cursor(const Params& P) {
  const int64_t s = *P.ring_pos % P.cap;
  return s < 0 ? s + P.cap : s;
}

// Warp 0: publish this tile's count, look back for the valid lanes of every
// tile before it, publish the inclusive prefix; returns the exclusive one.
__device__ __forceinline__ int64_t look_back(unsigned long long* status, unsigned int tile, unsigned int epoch, int live) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  if (tile == 0) {
    if (lane == 0) device_u64(status[0]).store(tag | kFlagPrefix | live, cuda::memory_order_relaxed);
    return 0;
  }
  if (lane == 0) device_u64(status[tile]).store(tag | kFlagCount | live, cuda::memory_order_relaxed);
  int64_t before = 0;
  for (int64_t hi = int64_t(tile) - 1;; hi -= 32) {
    const int64_t j = hi - lane;  // lane 0 looks at the nearest predecessor
    unsigned long long w = kFlagPrefix;  // before tile 0: a prefix of 0
    if (j >= 0) {
      // a block of a lower index is running and publishes within
      // microseconds; a second or more means it never will
      for (unsigned int spins = 0;; ++spins) {
        w = device_u64(status[j]).load(cuda::memory_order_relaxed);
        if ((w >> 32) == epoch && (w & (kFlagCount | kFlagPrefix))) break;
        if (spins > (1u << 25)) __trap();
      }
    }
    const unsigned int prefixes = __ballot_sync(0xFFFFFFFFu, (w & kFlagPrefix) != 0);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int v = lane <= stop ? int(w & kValueMask) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    before += v;
    if (prefixes) break;
  }
  if (lane == 0)
    device_u64(status[tile]).store(tag | kFlagPrefix | (unsigned long long)(before + live),
                                   cuda::memory_order_relaxed);
  return before;
}

__global__ void __launch_bounds__(kThreads) ring_append_tiles(const Params P) {
  __shared__ uint16_t sidx[kTileLanes];
  __shared__ int warp_tot[kThreads / 32 + 1];
  __shared__ unsigned int s_epoch;
  __shared__ long long s_base, s_start;
  // blocks start in index order, so every tile a block waits on belongs to
  // a block already running
  const unsigned int tile = blockIdx.x;
  const int64_t lane0 = int64_t(tile) * kTileLanes;
  const int live = rank_tile(P, lane0, sidx, warp_tot, [&] {
    if (threadIdx.x == 0) {
      s_epoch = device_u32(P.words[kEpochWord]).load(cuda::memory_order_relaxed);
      s_start = cursor(P);
    }
  });
  // a thread's lane (the tile is one a thread): its loads travel while
  // warp 0 looks back
  const bool mine = int(threadIdx.x) < live;
  uint64_t v[kMaxCols];
  if (mine) load_lane(P, lane0 + sidx[threadIdx.x], v);
  unsigned int finished = 0;
  if (threadIdx.x < 32) {
    const int64_t base = look_back(P.status, tile, s_epoch, live);
    if (threadIdx.x == 0) {
      s_base = base;
      // this block is done with the epoch and the status words; the count
      // comes back while it copies
      finished = device_u32(P.words[kDoneWord]).fetch_add(1u, cuda::memory_order_acq_rel);
    }
  }
  __syncthreads();
  if (mine) store_lane(P, cell(P, s_start, s_base + threadIdx.x), v);

  // the last block to finish its look-back: every block has read the epoch
  // and no block reads a status word again, so the next launch gets a new
  // epoch and a zero count
  if (threadIdx.x == 0 && finished == gridDim.x - 1) {
    device_u32(P.words[kDoneWord]).store(0u, cuda::memory_order_relaxed);
    const unsigned int next = s_epoch + 1u;
    if (next == 0u)
      for (int t = 0; t < kMaxTiles; ++t) device_u64(P.status[t]).store(0ull, cuda::memory_order_relaxed);
    device_u32(P.words[kEpochWord]).store(next, cuda::memory_order_relaxed);
  }
}

}  // namespace

// Columns: srcs[c] ([n] or null), dsts[c] ([cap]), sizes[c] (1 or 8).
// words: kHeaderWords u32 words and then kMaxTiles u64 status words (8-byte
// aligned), zero before the first launch and then left to the kernel.
extern "C" int ring_append(const void* valid, const void* ring_pos, long long n, long long cap,
                           int n_cols, const void* const* srcs, void* const* dsts,
                           const int* sizes, void* words, void* stream) {
  if (n <= 0) return 0;
  if (n_cols < 1 || n_cols > kMaxCols || cap <= 0 || n > cap)
    return int(cudaErrorInvalidValue);
  Params P{};
  P.valid = static_cast<const uint8_t*>(valid);
  P.ring_pos = static_cast<const int64_t*>(ring_pos);
  P.n = n;
  P.cap = cap;
  P.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) P.cols[c] = Col{srcs[c], dsts[c], sizes[c]};
  P.words = static_cast<unsigned int*>(words);
  P.status = reinterpret_cast<unsigned long long*>(P.words + kHeaderWords);
  const long long tiles = (n + kTileLanes - 1) / kTileLanes;
  if (tiles > kMaxTiles) return int(cudaErrorInvalidValue);
  ring_append_tiles<<<unsigned(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return int(cudaGetLastError());
}
