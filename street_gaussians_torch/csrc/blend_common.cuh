// What the instance-major blend's forward (tile_blend.cu) and backward
// (tile_blend_bwd.cu) share: the constants, the work list's layout, the
// staging of a payload block, and one Gaussian's alpha at one pixel.
// Both kernels must take every pass and stop decision alike, bit for
// bit, so both evaluate alpha through eval_alpha and carry the log
// transmittance in the same grouping (see tile_blend.cu).
#pragma once
#include <cuda_runtime.h>

#include <cstddef>

#include "block_times.cuh"

namespace sgblend {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int CHUNK = 128;  // lanes per payload block
constexpr int HEADER = 6;
constexpr int BATCH = 8;  // lanes whose alpha is evaluated together
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_EPS = (float)-9.210340371976182;  // log(1e-4)

// The work list, built on the card by build_plan (below). A
// tile whose run touches more than seg_blocks payload blocks is long: it
// is cut at every seg_blocks-th block of its run into segments, each a
// work item with a slot of boundary state; every other tile is one item.
//   plan[0]  items of long tiles (= slots); they come first in the list
//   plan[1]  items in all
//   then tile_slot[num_tiles]: a long tile's first item and slot, else -1
//   then item_tile[max_items], item_seg[max_items]
struct Plan {
  const int* n;
  const int* tile_slot;
  const int* item_tile;
  const int* item_seg;
  __host__ __device__ Plan(const int* plan, int num_tiles, int max_items)
      : n(plan), tile_slot(plan + 2), item_tile(plan + 2 + num_tiles),
        item_seg(plan + 2 + num_tiles + max_items) {}
};

// ---- the work list ----

constexpr int PLAN_THREADS = 1024;

// exclusive scan of (a, b) over the block's threads; the totals in
// (ta, tb)
__device__ inline void block_scan2(int& a, int& b, int& ta, int& tb, int (*warp_sums)[2]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(FULL, ia, off), ub = __shfl_up_sync(FULL, ib, off);
    if (lane >= off) {
      ia += ua;
      ib += ub;
    }
  }
  if (lane == 31) {
    warp_sums[warp][0] = ia;
    warp_sums[warp][1] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = warp_sums[lane][0], wb = warp_sums[lane][1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ua = __shfl_up_sync(FULL, wa, off), ub = __shfl_up_sync(FULL, wb, off);
      if (lane >= off) {
        wa += ua;
        wb += ub;
      }
    }
    warp_sums[lane][0] = wa;  // inclusive
    warp_sums[lane][1] = wb;
  }
  __syncthreads();
  const int pa = warp ? warp_sums[warp - 1][0] : 0, pb = warp ? warp_sums[warp - 1][1] : 0;
  ta = warp_sums[31][0];
  tb = warp_sums[31][1];
  a = pa + ia - a;
  b = pb + ib - b;
  __syncthreads();
}

// Fills the work list `plan` (the layout of Plan) in one block of
// PLAN_THREADS threads from segs(t), tile t's number of segments (at
// least 1). Items of long tiles (more than one segment) first, in tile
// order, a tile's segments in a row; then the short tiles (an empty tile
// too: its output is written like any other).
template <class Segments>
__device__ void build_plan(const Segments& segs, int num_tiles, int max_items, int* plan) {
  __shared__ int warp_sums[32][2];
  int* tile_slot = plan + 2;
  int* item_tile = tile_slot + num_tiles;
  int* item_seg = item_tile + max_items;

  // items of long tiles in all: the short tiles' items start there
  int mine = 0, none = 0, n_long, n_none;
  for (int t = threadIdx.x; t < num_tiles; t += PLAN_THREADS) {
    const int ns = segs(t);
    if (ns > 1) mine += ns;
  }
  block_scan2(mine, none, n_long, n_none, warp_sums);

  int long_base = 0, short_base = n_long;
  for (int t0 = 0; t0 < num_tiles; t0 += PLAN_THREADS) {
    const int t = t0 + threadIdx.x;
    const int ns = t < num_tiles ? segs(t) : 0;
    int a = ns > 1 ? ns : 0, b = ns == 1 ? 1 : 0, ta, tb;
    block_scan2(a, b, ta, tb, warp_sums);
    if (ns > 1) {
      tile_slot[t] = long_base + a;
      for (int k = 0; k < ns; ++k) {
        item_tile[long_base + a + k] = t;
        item_seg[long_base + a + k] = k;
      }
    } else if (ns == 1) {
      tile_slot[t] = -1;
      item_tile[short_base + b] = t;
      item_seg[short_base + b] = 0;
    }
    long_base += ta;
    short_base += tb;
  }
  if (threadIdx.x == 0) {
    plan[0] = n_long;
    plan[1] = short_base;
  }
}

// payload blocks a run touches
__host__ __device__ inline int run_blocks(int start, int count) {
  return count > 0 ? (start % CHUNK + count + CHUNK - 1) / CHUNK : 0;
}

// One work item: segment `seg` of tile `tile`.
struct Item {
  int tile, seg, slot0;  // slot0 < 0: a short tile, its own only item
  int start, end;        // the tile's run
  int b0;                // the run's first payload block
  int b_first, b_stop;   // the item's payload blocks [b_first, b_stop)
  bool last;             // holds the run's end
  __device__ Item(const Plan& plan, int i, const int* tile_start,
                  const int* tile_count, int seg_blocks) {
    tile = plan.item_tile[i];
    seg = plan.item_seg[i];
    slot0 = plan.tile_slot[tile];
    start = tile_start[tile];
    const int count = tile_count[tile];
    end = start + count;
    b0 = start / CHUNK;
    const int b_end = b0 + run_blocks(start, count);
    b_first = b0 + seg * seg_blocks;
    b_stop = min(b_first + seg_blocks, b_end);
    last = b_stop == b_end;
  }
};

// Shared-memory copy of a payload block, lane-major: lane l's 6 + F rows
// at sm[l * RP ...], RP a multiple of 4 so that a lane's header is two
// float4 reads (all pixels of a warp read the same lane: a broadcast).
template <int F>
struct Rows {
  static constexpr int ROWS = HEADER + F;
  static constexpr int RP = (ROWS + 3) / 4 * 4;
  static constexpr int FLOATS = CHUNK * RP;
};

template <int F>
__device__ inline void stage_block(float* sm, const float* __restrict__ blk) {
  for (int i = threadIdx.x; i < Rows<F>::ROWS * CHUNK; i += PIX) {
    sm[(i % CHUNK) * Rows<F>::RP + i / CHUNK] = blk[i];
  }
}

struct Gauss {
  float mx, my, ca, cb, cc, op;
};

template <int F>
__device__ inline Gauss load_gauss(const float* sm, int l) {
  const float4 a = *reinterpret_cast<const float4*>(sm + l * Rows<F>::RP);
  const float2 b = *reinterpret_cast<const float2*>(sm + l * Rows<F>::RP + 4);
  return {a.x, a.y, a.z, a.w, b.x, b.y};
}

// ---- feature counts above the instantiated ones ----
// The kernels are instantiated for F = 1..MAX_FIXED_F; a wider F (up to
// MAX_F) takes kernels with F a runtime count, whose per-feature state
// lives in shared memory instead of registers (tile_blend.cu,
// tile_blend_bwd.cu). The same layout as Rows<F>, with the row pitch
// computed at run time.
constexpr int MAX_FIXED_F = 8;
constexpr int MAX_F = 64;

__host__ __device__ inline int wide_rp(int F) { return (HEADER + F + 3) / 4 * 4; }

__device__ inline void stage_block_wide(float* sm, const float* __restrict__ blk, int F) {
  const int rows = HEADER + F, rp = wide_rp(F);
  for (int i = threadIdx.x; i < rows * CHUNK; i += PIX) sm[(i % CHUNK) * rp + i / CHUNK] = blk[i];
}

__device__ inline Gauss load_gauss_wide(const float* sm, int l, int rp) {
  const float4 a = *reinterpret_cast<const float4*>(sm + l * rp);
  const float2 b = *reinterpret_cast<const float2*>(sm + l * rp + 4);
  return {a.x, a.y, a.z, a.w, b.x, b.y};
}

struct Alpha {
  float dx, dy, apow, alpha_raw, alpha;
  bool pass;
};

// alpha = min(0.99, op * exp(min(power, 0))); the pair passes when
// power <= 0 and alpha >= 1/255
__device__ inline Alpha eval_alpha(const Gauss& g, float px, float py) {
  Alpha a;
  a.dx = g.mx - px;
  a.dy = g.my - py;
  const float power =
      -0.5f * (g.ca * a.dx * a.dx + g.cc * a.dy * a.dy) - g.cb * a.dx * a.dy;
  a.apow = expf(fminf(power, 0.0f));
  a.alpha_raw = g.op * a.apow;
  a.alpha = fminf(ALPHA_MAX, a.alpha_raw);
  a.pass = power <= 0.0f && a.alpha >= ALPHA_MIN;
  return a;
}

// Log transmittance entering the segment that starts at payload block
// b_first of a run that starts in block b0: the sum, in segment order,
// of the earlier segments' log-sums, each the sum in block order of its
// blocks' sums blocklog[block, p] (the grouping of a walk's `segcum`).
__device__ inline float entering_log_t(const float* blocklog, int b0, int b_first,
                                       int seg_blocks, int p) {
  float base = 0.0f;
  for (int b = b0; b < b_first; b += seg_blocks) {
    float segcum = 0.0f;
    for (int i = 0; i < seg_blocks; ++i) segcum += blocklog[(size_t)(b + i) * PIX + p];
    base += segcum;
  }
  return base;
}

}  // namespace sgblend
