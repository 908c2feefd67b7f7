// Per-block start and end times, for a probe build only.
//
// Compiled with -DSG_BLOCK_TIMES, a kernel that declares
// `BlockTimer timer(region);` has thread 0 write the card's %globaltimer
// (ns) to sg_times[2 * slot] when the block gets there and to
// sg_times[2 * slot + 1] when it leaves (the destructor, so an early
// return is timed too), slot = region * REGION_STRIDE + blockIdx.x; each
// kernel launch of a library has a region of its own, and a block beyond
// REGION_STRIDE is not timed. sg_set_block_times() names the buffer
// ([regions][REGION_STRIDE][2] 64-bit words), which the caller
// zero-fills: a slot that stays 0 belongs to a block that never ran.
// Without the macro the timer is an empty object and the shipped kernel
// carries none of this.
#pragma once
#include <cuda_runtime.h>

// block slots per kernel launch in the time buffer
constexpr int REGION_STRIDE = 1 << 16;

#ifdef SG_BLOCK_TIMES
static __device__ unsigned long long* sg_times = nullptr;

struct BlockTimer {
  int slot;
  static __device__ unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ explicit BlockTimer(int region) : slot(region * REGION_STRIDE + (int)blockIdx.x) {
    if (threadIdx.x != 0 || !sg_times || blockIdx.x >= REGION_STRIDE) slot = -1;
    if (slot >= 0) sg_times[2 * slot] = now();
  }
  __device__ ~BlockTimer() {
    if (slot >= 0) sg_times[2 * slot + 1] = now();
  }
};

extern "C" int sg_set_block_times(void* buffer) {
  return (int)cudaMemcpyToSymbol(sg_times, &buffer, sizeof(buffer));
}
#else
struct BlockTimer {
  __device__ explicit BlockTimer(int) {}
};
#endif
