// Run expansion, two entries on one merge:
//
// expand_runs: out[c, s] = vals[c, j] for the unique run j with
// offs[j] <= s < offs[j+1] (the last run ends at *total), and 0 for a
// slot that no run covers, at and beyond total included.
//
// expand_instances: binning's instances straight from the runs. Slot s
// of run j is the k-th tile, k = s - offs[j], of Gaussian j's rect
// (row-major over its width), so it gets tile_id[s] = ty * grid_x + tx
// and gauss_id[s] = vals[0, j], or num_tiles and -1 where it is dead:
// no run covers it, or the corner cull proves the Gaussian's alpha
// below 1/255 over the whole tile. The offset within the run comes from
// the run's own start: no scan over the slots.
//
// Replaces street_gaussians_tpu/ops/fill.py::_kernel, a banded 0/1
// select matmul on the TPU's matrix unit. That is a TPU device and is
// not carried over.
//
// Bound on the H100: memory. expand_runs reads vals [C, N] and offs
// [N] and writes out [C, S]; expand_instances reads the same and
// writes two [S] int32 arrays. Design: the run ends and the slots
// 0..S-1 are two sorted lists, and the expansion is their merge
// (merge_path.cuh). A block of FILL_THREADS threads takes a tile of
// FILL_TILE merged items, the same work however ragged the runs are:
//  1. two warps find the tile's ends (a 32-way search over the run ends
//     each); the block stages the ends of the tile's runs in
//     shared memory, and each thread finds its own start there;
//  2. each thread walks its FILL_ITEMS items in order, writing for each
//     slot its run, or -1 for none, to shared memory;
//  3. the tile's slots are written by coalesced stores (neighbouring
//     slots mostly read one run's values): expand_runs channel row by
//     channel row, vals[c, run] or 0; expand_instances the two ids.
// expand_runs copies values and never sums them, so the result is exact
// for any float and deterministic. expand_instances' cull rounds every
// product and sum on its own (built with -fmad=false), as its plain
// PyTorch version does, so the two decide every edge alike.
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

struct SlotRuns {
  int end[FILL_TILE];  // ends of the tile's runs
  int run[FILL_TILE];  // run of each of the tile's slots, -1 for none
  int bounds[4];
};

// Steps 1-2, shared by both entries: fills sh.run for the block's tile
// of the merge and returns its first slot (x) and its slot count (y).
// `probe(slot, value)` is the search-only build's one write.
template <class Probe>
__device__ __forceinline__ int2 slot_runs(SlotRuns& sh, const int* __restrict__ offs, int total, int N,
                                          int S, Probe probe) {
  const int t = threadIdx.x;
  auto end_of = [&](int i) { return i + 1 < N ? offs[i + 1] : total; };

  const int warp = t >> 5;
  if (warp < 2) {
    const int diag = min((int)(blockIdx.x + warp) * FILL_TILE, N + S);
    const int i = merge_path_search_warp(diag, N, S, [&](int r, int s) { return end_of(r) <= s; });
    if ((t & 31) == 0) {
      sh.bounds[2 * warp] = i;
      sh.bounds[2 * warp + 1] = diag - i;
    }
  }
  __syncthreads();
  const int i0 = sh.bounds[0], j0 = sh.bounds[1];
  const int nruns = sh.bounds[2] - i0, nslots = sh.bounds[3] - j0;
  for (int r = t; r < nruns; r += FILL_THREADS) sh.end[r] = end_of(i0 + r);
  __syncthreads();
  const int ld = min(t * FILL_ITEMS, nruns + nslots);
  const int n_items = min(FILL_ITEMS, nruns + nslots - ld);
  int it = merge_path_search(ld, nruns, nslots, [&](int r, int s) { return sh.end[r] <= j0 + s; });
  int jt = ld - it;
#ifdef SG_SEARCH_ONLY
  if (t < nslots) probe(j0 + t, it * 64 + jt);
  return make_int2(j0, 0);
#endif
  for (int k = 0; k < n_items; ++k) {
    if (it < nruns && (jt >= nslots || sh.end[it] <= j0 + jt)) {
      ++it;
    } else {
      const int run = i0 + it;
      sh.run[jt] = run < N && __ldg(offs + run) <= j0 + jt ? run : -1;
      ++jt;
    }
  }
  __syncthreads();
  return make_int2(j0, nslots);
}

__global__ void __launch_bounds__(FILL_THREADS)
    expand_runs_kernel(const float* __restrict__ vals, const int* __restrict__ offs,
                       const int* __restrict__ total_ptr, float* __restrict__ out, int C, int N,
                       int S) {
  __shared__ SlotRuns sh;
  const int2 tile = slot_runs(sh, offs, *total_ptr, N, S, [&](int s, int v) { out[s] = (float)v; });
  for (int r = threadIdx.x; r < tile.y; r += FILL_THREADS) {
    const int run = sh.run[r];
    float* o = out + tile.x + r;
    for (int c = 0; c < C; ++c) o[(size_t)c * S] = run >= 0 ? __ldg(vals + (size_t)c * N + run) : 0.0f;
  }
}

// vals' rows: the id, then the rect packed as x + (y << 7) + (w << 14)
// (PACKED, grids below 128 tiles a side) or as x, y, w, then with CULL
// the center's x, y and the squared radius past which alpha < 1/255
// (ops/binning.expand_inputs)
template <bool PACKED, bool CULL>
__global__ void __launch_bounds__(FILL_THREADS)
    expand_instances_kernel(const float* __restrict__ vals, const int* __restrict__ offs,
                            const int* __restrict__ total_ptr, int* __restrict__ tile_id,
                            int* __restrict__ gauss_id, int N, int S, int grid_x, int num_tiles) {
  __shared__ SlotRuns sh;
  const int2 tile = slot_runs(sh, offs, *total_ptr, N, S, [&](int s, int v) { gauss_id[s] = v; });
  constexpr int NID = PACKED ? 2 : 4;
  for (int r = threadIdx.x; r < tile.y; r += FILL_THREADS) {
    const int s = tile.x + r;
    const int run = sh.run[r];
    int t_out = num_tiles, g_out = -1;
    if (run >= 0) {
      const int k = s - __ldg(offs + run);
      int rx, ry, rw;
      if (PACKED) {
        const int pr = (int)__ldg(vals + N + run);
        rx = pr & 127;
        ry = (pr >> 7) & 127;
        rw = max(pr >> 14, 1);
      } else {
        rx = (int)__ldg(vals + N + run);
        ry = (int)__ldg(vals + 2 * N + run);
        rw = max((int)__ldg(vals + 3 * N + run), 1);
      }
      const int q = k / rw;
      const int tx = rx + (k - q * rw), ty = ry + q;
      bool live = true;
      if (CULL) {
        // distance from the center to the tile's pixel box
        // [16 tx, 16 tx + 15] x [16 ty, 16 ty + 15]; a NaN center is
        // dead, as torch.maximum's NaN fails the plain version's test
        const float mx = __ldg(vals + NID * N + run), my = __ldg(vals + (NID + 1) * N + run);
        const float r2 = __ldg(vals + (NID + 2) * N + run);
        const float px0 = (float)tx * 16.0f, py0 = (float)ty * 16.0f;
        const float dx = fminf(fmaxf(mx, px0), px0 + 15.0f) - mx;
        const float dy = fminf(fmaxf(my, py0), py0 + 15.0f) - my;
        live = dx * dx + dy * dy <= r2 && mx == mx && my == my;
      }
      if (live) {
        t_out = ty * grid_x + tx;
        g_out = (int)__ldg(vals + run);
      }
    }
    tile_id[s] = t_out;
    gauss_id[s] = g_out;
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

// N + S < 2^31; num_ids 2 (packed rect) or 4; cull: vals holds the
// three cull rows after the ids
extern "C" int expand_instances_i32(const float* vals, const int* offs, const int* total, int* tile_id,
                                    int* gauss_id, int N, int S, int num_ids, int cull, int grid_x,
                                    int num_tiles, void* stream) {
  if (S > 0) {
    const int tiles = (int)(((long)N + S + FILL_TILE - 1) / FILL_TILE);
    const cudaStream_t st = (cudaStream_t)stream;
    const bool packed = num_ids == 2;
    auto kernel = packed ? (cull ? expand_instances_kernel<true, true> : expand_instances_kernel<true, false>)
                         : (cull ? expand_instances_kernel<false, true> : expand_instances_kernel<false, false>);
    kernel<<<tiles, FILL_THREADS, 0, st>>>(vals, offs, total, tile_id, gauss_id, N, S, grid_x, num_tiles);
  }
  return (int)cudaGetLastError();
}
