// Segmented row-sum: out[c, g] = sum of d[c, j] over the rows j whose
// key falls in segment g (identity segments: key g alone; explicit
// segments: keys in [offs[g], ends[g])). Keys are ascending, so each
// segment owns one contiguous row range of the sorted array; padding
// rows carry keys >= 2^30 and fall in no segment.
//
// Replaces street_gaussians_tpu/ops/segsum.py::_kernel, a banded 0/1
// matmul on the TPU's matrix unit that walks (group, chunk) pairs of a
// sequential grid. That is a TPU device and is not carried over.
//
// Bound on the H100: memory. The function reads d [C, L] and the keys
// [L] and writes out [C, N].
//
// Identity segments (both calls of the train step) merge the segment
// ends 0..N-1 with the sorted rows (merge_path.cuh): a tile of SEG_TILE
// merged items, one block of SEG_THREADS threads, SEG_ITEMS items a
// thread, whatever the segments' lengths and however many are empty.
//  1. Two warps find the tile's ends (a 32-way search over the keys
//     each); the block stages the tile's keys in shared memory, and
//     each thread finds its own start there and marks which of its
//     items end a segment.
//  2. Per channel: the tile's rows are staged in shared memory by
//     coalesced loads (the next channel's loads are in flight during
//     the walk); each thread adds its rows in order and writes the sum
//     of each segment that ends in its items to shared memory (0 for an
//     empty one); the tile's sums leave by coalesced stores.
//  3. A segment cut by a thread boundary leaves partial sums (carries).
//     Within the block they are combined by a segmented inclusive scan
//     in a fixed order: within a warp, the Kogge-Stone steps 1, 2, 4, 8,
//     16 (shuffles); across warps, the warps' last carries left to right.
//     The thread that ends the segment adds the scan of the threads
//     before it to its own part. Each block leaves its last carry; a
//     second launch (segsum_fixup_kernel) adds to a segment that a tile
//     boundary cut the carries of the blocks before, left to right.
// No atomics: each output has one writer per launch and the order of
// every sum is fixed by the shapes and the keys, so the result repeats
// bit for bit. It is not the key-order sum of the plain version: a
// segment cut by a thread or tile boundary is summed in parts. The
// order is written out in plain PyTorch in ops/segsum.py
// (segment_rowsum_emulated), which the kernel equals bit for bit.
// Rows with keys >= N come after the last segment end and are never
// added to an output.
//
// Explicit segments have no caller on the main path and keep the first
// design: a block of 256 threads takes 256 / G consecutive segments,
// finds their row ranges by binary searches over the keys, and thread
// (segment, channel group) sums its channels in key order.
//
// -DSG_SEARCH_ONLY (a probe build, script/search_times.py) stops the
// identity kernel once its partition is known, keeping the searches by
// one write; -DSG_SEG_ITEMS sets the items per thread (the shipped 12
// was the fastest of 4, 8, 12 and 16 on the bench calls, PERF.md).
#include <cuda_runtime.h>

#include <cstddef>

#include "merge_path.cuh"

#ifndef SG_SEG_ITEMS
#define SG_SEG_ITEMS 12
#endif

namespace {

constexpr int SEG_THREADS = 256;
constexpr int SEG_ITEMS = SG_SEG_ITEMS;  // merged items per thread
constexpr int SEG_TILE = SEG_THREADS * SEG_ITEMS;
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SEG_ITEMS >= 1 && SEG_ITEMS <= 32, "item bits are one word");

__global__ void __launch_bounds__(SEG_THREADS)
    segsum_tiles_kernel(const float* __restrict__ d, const int* __restrict__ keys,
                        float* __restrict__ out, float* __restrict__ carry,
                        int* __restrict__ tile_seg, int C, int L, int N) {
  __shared__ int key_s[SEG_TILE];
  __shared__ float row_s[SEG_TILE];
  __shared__ float out_s[SEG_TILE];
  __shared__ float warp_v[SEG_WARPS];
  __shared__ int warp_s[SEG_WARPS];
  __shared__ int bounds[4];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = blockIdx.x;
  const int total = N + L;

  // 1. the tile's ends: (segment, row) where diagonals b and b + 1
  // cross the merge path, one warp each
  if (warp < 2) {
    const int diag = min((b + warp) * SEG_TILE, total);
    const int i = merge_path_search_warp(diag, N, L, [&](int s, int r) { return keys[r] > s; });
    if (lane == 0) {
      bounds[2 * warp] = i;
      bounds[2 * warp + 1] = diag - i;
    }
  }
  __syncthreads();
  const int i0 = bounds[0], j0 = bounds[1];
  const int nsegs = bounds[2] - i0, nrows = bounds[3] - j0;
  if (t == 0) {
    tile_seg[b] = i0;
    if (b == 0) tile_seg[gridDim.x] = N;
  }
  if (i0 >= N) return;  // padding rows only
  for (int r = t; r < nrows; r += SEG_THREADS) key_s[r] = keys[j0 + r];
  __syncthreads();
  const int ld = min(t * SEG_ITEMS, nsegs + nrows);
  const int n_items = min(SEG_ITEMS, nsegs + nrows - ld);
  const int it0 = merge_path_search(ld, nsegs, nrows, [&](int s, int r) { return key_s[r] > i0 + s; });
  const int jt0 = ld - it0;
  unsigned ends = 0;  // bit k: item k ends a segment (else it is a row)
  {
    int it = it0, jt = jt0;
    for (int k = 0; k < n_items; ++k) {
      if (it < nsegs && (jt >= nrows || key_s[jt] > i0 + it)) {
        ends |= 1u << k;
        ++it;
      } else {
        ++jt;
      }
    }
  }
#ifdef SG_SEARCH_ONLY
  if (t < nsegs) out[i0 + t] = (float)(it0 * 64 + __popc(ends));
  return;
#endif

  // 2. per channel: stage, walk, scan the carries, store
  float pre[SEG_ITEMS];  // the next channel's rows, in flight
  auto load = [&](int c) {
    const float* dc = d + (size_t)c * L + j0;
#pragma unroll
    for (int k = 0; k < SEG_ITEMS; ++k) {
      const int r = t + k * SEG_THREADS;
      pre[k] = r < nrows ? dc[r] : 0.0f;
    }
  };
  load(0);
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < SEG_ITEMS; ++k) {
      const int r = t + k * SEG_THREADS;
      if (r < nrows) row_s[r] = pre[k];
    }
    __syncthreads();  // rows staged; the last channel's stores are done
    if (c + 1 < C) load(c + 1);
    float acc = 0.0f, head = 0.0f;
    bool has_head = false;
    int it = it0, jt = jt0;
    for (int k = 0; k < n_items; ++k) {
      if (ends >> k & 1u) {
        if (it == it0) {
          head = acc;  // the thread's first segment: earlier threads may hold parts
          has_head = true;
        } else {
          out_s[it] = acc;
        }
        acc = 0.0f;
        ++it;
      } else {
        acc += row_s[jt++];
      }
    }
    // 3. segmented inclusive scan of the carries (acc of segment it)
    float v = acc;
    const int s = it;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float pv = __shfl_up_sync(FULL, v, off);
      const int ps = __shfl_up_sync(FULL, s, off);
      if (lane >= off && ps == s) v = pv + v;
    }
    if (lane == 31) {
      warp_v[warp] = v;
      warp_s[warp] = s;
    }
    __syncthreads();
    float f = 0.0f;  // the scan at the last lane of the warp before
    if (warp > 0) {
      f = warp_v[0];
      for (int w = 1; w < warp; ++w) f = warp_s[w] == warp_s[w - 1] ? f + warp_v[w] : warp_v[w];
      if (s == warp_s[warp - 1]) v = f + v;
    }
    float before = __shfl_up_sync(FULL, v, 1);  // the scan at thread t - 1
    if (lane == 0) before = f;
    if (has_head) out_s[it0] = t > 0 ? before + head : head;
    if (t == SEG_THREADS - 1) carry[(size_t)b * C + c] = v;
    __syncthreads();
    float* oc = out + (size_t)c * N + i0;
    for (int r = t; r < nsegs; r += SEG_THREADS) oc[r] = out_s[r];
  }
}

// Adds to the first segment that tile b ends, when it began in an
// earlier tile, the carries of the tiles before that hold parts of it,
// left to right. One thread per (tile, channel).
__global__ void segsum_fixup_kernel(const float* __restrict__ carry, const int* __restrict__ tile_seg,
                                    float* __restrict__ out, int C, int N, int tiles) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(idx / C) + 1;
  const int c = (int)(idx % C);
  if (b >= tiles) return;
  const int s = tile_seg[b];
  if (s >= N || tile_seg[b + 1] == s) return;  // no segment, or it does not end here
  int a = b - 1;  // tile a holds a part of s iff tile a + 1 starts in s
  while (a > 0 && tile_seg[a] == s) --a;
  float x = carry[(size_t)a * C + c];
  for (int k = a + 1; k < b; ++k) x = x + carry[(size_t)k * C + c];
  float* o = out + (size_t)c * N + s;
  *o = x + *o;
}

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // loads in flight per thread

// first row j with keys[j] >= key
__device__ __forceinline__ long lower_bound(const int* __restrict__ keys, long L, int key) {
  long lo = 0, hi = L;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    if (keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    segment_ranges_kernel(const float* __restrict__ d, const int* __restrict__ keys,
                          const int* __restrict__ offs, const int* __restrict__ ends,
                          float* __restrict__ out, int C, long L, int N, int groups) {
  __shared__ long bound[2][THREADS];  // row0, row1 of the block's segments
  const int t = threadIdx.x;
  const int segs = THREADS / groups;
  const int s0 = blockIdx.x * segs;
  for (int i = t; i < 2 * segs; i += THREADS) {
    const int side = i / segs;  // 0: segment start, 1: segment end
    const int g = s0 + i % segs;
    bound[side][i % segs] = g < N ? lower_bound(keys, L, side ? ends[g] : offs[g]) : 0;
  }
  __syncthreads();
  const int j = t % segs;
  const int g = s0 + j;
  if (g >= N) return;
  const long a = bound[0][j];
  const long b = bound[1][j] > a ? bound[1][j] : a;  // ends <= offs: empty
  for (int c = t / segs; c < C; c += groups) {
    const float* dc = d + (size_t)c * L;
    float s = 0.0f;
    long r = a;
    for (; r + UNROLL <= b; r += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = dc[r + u];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s += v[u];
    }
    for (; r < b; ++r) s += dc[r];
    out[(size_t)c * N + g] = s;
  }
}

}  // namespace

// merged items per tile of the identity path (the wrapper sizes the
// carry buffers by it)
extern "C" int segment_rowsum_tile_items() { return SEG_TILE; }

// offs == ends == nullptr selects identity segments; they need
// carry [tiles * C] f32 and tile_seg [tiles + 1] int32 scratch,
// tiles = ceil((N + L) / SEG_TILE), N + L < 2^31.
extern "C" int segment_rowsum_f32(const float* d, const int* keys, const int* offs,
                                  const int* ends, float* out, int C, long L, int N,
                                  float* carry, int* tile_seg, void* stream) {
  if (N > 0 && C > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (offs == nullptr) {
      const int tiles = (int)((N + L + SEG_TILE - 1) / SEG_TILE);
      segsum_tiles_kernel<<<tiles, SEG_THREADS, 0, st>>>(d, keys, out, carry, tile_seg, C, (int)L, N);
#ifndef SG_SEARCH_ONLY
      const long fix = (long)(tiles - 1) * C;
      if (fix > 0) segsum_fixup_kernel<<<(int)((fix + 255) / 256), 256, 0, st>>>(carry, tile_seg, out, C, N, tiles);
#endif
    } else {
      const int groups = L >= N ? 8 : 1;
      const int segs = THREADS / groups;
      segment_ranges_kernel<<<(N + segs - 1) / segs, THREADS, 0, st>>>(d, keys, offs, ends, out, C, L,
                                                                        N, groups);
    }
  }
  return (int)cudaGetLastError();
}
