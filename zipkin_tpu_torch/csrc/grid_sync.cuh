// Grid barrier over the co-resident blocks of a cooperative launch, shared by
// the kernels that need one (ring_append.cu, link_chase.cu).
//
// The barrier is two words in device memory: an arrival count and a
// generation. The last block to arrive resets the count and advances the
// generation the others wait on, so every barrier leaves the words ready for
// the next one: launches need no memset, and a CUDA graph replays a launch as
// it was captured. Launches that share the words must run one after another
// (one stream orders them).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // a wait is microseconds; one of a second or more means a block
      // never arrived: fail the launch rather than hang the card
      for (unsigned int spins = 0; *gen == seen; ++spins) {
        if (spins > (1u << 25)) __trap();
        __nanosleep(32);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace
