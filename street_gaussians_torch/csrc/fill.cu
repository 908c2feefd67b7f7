// Run expansion: out[c, s] = vals[c, j] for the unique run j with
// offs[j] <= s < offs[j+1] (the last run ends at *total), and 0 for a
// slot that no run covers, at and beyond total included.
//
// Replaces street_gaussians_tpu/ops/fill.py::_kernel, a banded 0/1
// select matmul on the TPU's matrix unit. That is a TPU device and is
// not carried over.
//
// Bound on the H100: memory. The function reads vals [C, N] and offs
// [N] and writes out [C, S]. Design: the run ends and the slots
// 0..S-1 are two sorted lists, and the expansion is their merge
// (merge_path.cuh). A block of FILL_THREADS threads takes a tile of
// FILL_TILE merged items, the same work however ragged the runs are:
//  1. two warps find the tile's ends (a 32-way search over the run ends
//     each); the block stages the ends of the tile's runs in
//     shared memory, and each thread finds its own start there;
//  2. each thread walks its FILL_ITEMS items in order, writing for each
//     slot its run, or -1 for none, to shared memory;
//  3. the tile's slots are written channel row by channel row, by
//     coalesced stores of vals[c, run] (neighbouring slots mostly read
//     one run's value) or 0.
// The values are copied, never summed, so the result is exact for any
// float and deterministic.
//
// -DSG_SEARCH_ONLY (a probe build, script/search_times.py) stops once
// the partition is known, keeping the searches by one write.
#include <cuda_runtime.h>

#include <cstddef>

#include "merge_path.cuh"

#ifndef SG_FILL_ITEMS
#define SG_FILL_ITEMS 8
#endif

namespace {

constexpr int FILL_THREADS = 256;
constexpr int FILL_ITEMS = SG_FILL_ITEMS;  // merged items per thread
constexpr int FILL_TILE = FILL_THREADS * FILL_ITEMS;

__global__ void __launch_bounds__(FILL_THREADS)
    expand_runs_kernel(const float* __restrict__ vals, const int* __restrict__ offs,
                       const int* __restrict__ total_ptr, float* __restrict__ out, int C, int N,
                       int S) {
  __shared__ int end_s[FILL_TILE];  // ends of the tile's runs
  __shared__ int run_s[FILL_TILE];  // run of each of the tile's slots, -1 for none
  __shared__ int bounds[4];
  const int t = threadIdx.x;
  const int total = *total_ptr;
  auto end_of = [&](int i) { return i + 1 < N ? offs[i + 1] : total; };

  const int warp = t >> 5;
  if (warp < 2) {
    const int diag = min((int)(blockIdx.x + warp) * FILL_TILE, N + S);
    const int i = merge_path_search_warp(diag, N, S, [&](int r, int s) { return end_of(r) <= s; });
    if ((t & 31) == 0) {
      bounds[2 * warp] = i;
      bounds[2 * warp + 1] = diag - i;
    }
  }
  __syncthreads();
  const int i0 = bounds[0], j0 = bounds[1];
  const int nruns = bounds[2] - i0, nslots = bounds[3] - j0;
  for (int r = t; r < nruns; r += FILL_THREADS) end_s[r] = end_of(i0 + r);
  __syncthreads();
  const int ld = min(t * FILL_ITEMS, nruns + nslots);
  const int n_items = min(FILL_ITEMS, nruns + nslots - ld);
  int it = merge_path_search(ld, nruns, nslots, [&](int r, int s) { return end_s[r] <= j0 + s; });
  int jt = ld - it;
#ifdef SG_SEARCH_ONLY
  if (t < nslots) out[j0 + t] = (float)(it * 64 + jt);
  return;
#endif
  for (int k = 0; k < n_items; ++k) {
    if (it < nruns && (jt >= nslots || end_s[it] <= j0 + jt)) {
      ++it;
    } else {
      const int run = i0 + it;
      run_s[jt] = run < N && __ldg(offs + run) <= j0 + jt ? run : -1;
      ++jt;
    }
  }
  __syncthreads();
  for (int r = t; r < nslots; r += FILL_THREADS) {
    const int run = run_s[r];
    float* o = out + j0 + r;
    for (int c = 0; c < C; ++c) o[(size_t)c * S] = run >= 0 ? __ldg(vals + (size_t)c * N + run) : 0.0f;
  }
}

}  // namespace

// N + S < 2^31
extern "C" int expand_runs_f32(const float* vals, const int* offs, const int* total, float* out,
                               int C, int N, int S, void* stream) {
  if (S > 0) {
    const long tiles = ((long)N + S + FILL_TILE - 1) / FILL_TILE;
    expand_runs_kernel<<<(int)tiles, FILL_THREADS, 0, (cudaStream_t)stream>>>(vals, offs, total, out, C,
                                                                               N, S);
  }
  return (int)cudaGetLastError();
}
