// HLL register scatter-max for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel zipkin_tpu/ops/pallas_hll.py:update
// (body _kernel), which keeps the whole register file resident in VMEM and
// applies the batch serially as (32, 128)-tile read-modify-writes. On the
// card the lanes run in parallel instead: one thread per lane computes
// bucket and rho from the hash and raises one u8 register.
//
// Per lane (same bit rules as zipkin_tpu/ops/hll.py:update):
//   bucket = h >> (32 - p)
//   rest   = h & ((1 << (32 - p)) - 1)
//   rho    = rest == 0 ? 33 - p : (32 - p) - floor(log2(rest))
//   invalid lanes carry rho 0, which never raises a register
//   regs[row, bucket] = max(regs[row, bucket], rho)
//
// There is no u8 atomic, so the max is applied to the aligned 32-bit word
// that holds the register with an atomicCAS loop that only ever changes
// the target byte. Registers never decrease, so a plain read that already
// shows a value >= rho proves the lane cannot raise it: the lane skips the
// atomic. That skip is the common case once registers fill.
//
// What bounds it on the card: memory and atomics, not arithmetic. Each
// lane reads its row (i32, 4 B), hash (the u32 bits, 4 B) and valid flag
// (1 B) once: 9 B. A valid lane reads the 4-byte word of its register, and
// a lane that raises it adds one 4-byte read-modify-write. At 65,536 lanes
// that is under 1 MB, well under a microsecond of HBM traffic at
// 3.35 TB/s; the register files (2 MB and 8.4 MB) fit the 50 MB L2. Launch
// latency dominates.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (zipkin_tpu_torch/kernels.py). Launches on the caller's stream,
// does not synchronise, allocates nothing; returns the launch's CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void hll_update_kernel(uint8_t* __restrict__ regs,
                                  const int32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ hashes,
                                  const bool* __restrict__ valid,
                                  int64_t n, int64_t n_rows, int p) {
  const int64_t m = int64_t(1) << p;
  const uint32_t rest_mask = (p >= 32) ? 0u : ((1u << (32 - p)) - 1u);
  const int64_t stride = int64_t(blockDim.x) * gridDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;  // rho 0: inert
    const int64_t row = rows[i];
    if (row < 0 || row >= n_rows) continue;  // out of range: dropped
    const uint32_t h = hashes[i];
    const uint32_t bucket = h >> (32 - p);
    const uint32_t rest = h & rest_mask;
    // floor(log2(rest)) = 31 - clz(rest) for rest >= 1
    const uint32_t rho =
        rest == 0u ? uint32_t(33 - p) : uint32_t(32 - p) - uint32_t(31 - __clz(rest));

    const int64_t off = row * m + bucket;
    unsigned int* word =
        reinterpret_cast<unsigned int*>(regs + (off & ~int64_t(3)));
    const unsigned int shift = unsigned(off & 3) * 8u;
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (((old >> shift) & 0xFFu) < rho) {
      const unsigned int raised = (old & ~(0xFFu << shift)) | (rho << shift);
      const unsigned int prev = atomicCAS(word, old, raised);
      if (prev == old) break;
      old = prev;  // another lane changed the word: re-test against it
    }
  }
}

}  // namespace

extern "C" int hll_update(void* regs, const void* rows, const void* hashes,
                          const void* valid, long long n, long long n_rows,
                          int p, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond this
  hll_update_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(regs), static_cast<const int32_t*>(rows),
      static_cast<const uint32_t*>(hashes), static_cast<const bool*>(valid),
      static_cast<int64_t>(n), static_cast<int64_t>(n_rows), p);
  return static_cast<int>(cudaGetLastError());
}
