// Forward tile blend over instance-major payload blocks.
//
// Replaces street_gaussians_tpu/ops/tile_raster2.py::_fwd_kernel. Each
// 16x16 tile owns the ragged run [tile_start, tile_start + tile_count)
// of the depth-sorted instance array; lane i of the run lives at
// payload[i / 128, row, i % 128], rows mean x, mean y, conic a/b/c,
// opacity, then F features. Per pixel, front to back:
//   alpha = min(0.99, op * exp(min(power, 0))), skipped when power > 0
//   or alpha < 1/255; the pixel stops once T would fall below 1e-4, and
//   the Gaussian that triggers the stop is not blended.
// Output [num_tiles, 256, F + 1]: the F blended features, then final T.
//
// Bound on the H100: the per-pixel exp/log1p and arithmetic (256 pixels
// times the instances each pixel reaches before it stops), far above the
// bytes. What held the one-block-per-tile kernel at 2% of that bound was
// neither: a run is walked lane after lane, and on a street scene a
// dozen tiles hold 10,000 lanes and more while the median holds 50, so
// the launch lasted as long as its longest tile's block (3.66 of 3.67 ms
// on the bench frame; the same blocks spread evenly would take 0.63 ms).
//
// Design.
// 1. Long runs are split. plan_kernel cuts a run that touches more than
//    seg_blocks payload blocks into segments of seg_blocks blocks; each
//    segment is a work item with its own block of 256 threads (one per
//    pixel), long tiles' items first; a short tile is one item. The
//    transmittance is carried in log space, as in the JAX kernel, and
//    that makes segments independent: a first pass (block_sums_kernel,
//    one thread block per 128-lane payload block of the long tiles)
//    gives each block's per-pixel sum of log1p(-alpha) over its passing
//    lanes; a pixel enters segment k with base = the sum of the earlier
//    segments' sums, and since the sums only fall it had stopped before
//    k exactly when base < log(1e-4). Each segment then blends its lanes
//    from `base` into a partial [256, F] accumulator and writes the
//    final T where it holds the stop or the run's end (0 elsewhere), and
//    combine_kernel adds a tile's partials in segment order. The sums
//    and partials stay on the card as the backward's boundary state.
//    No atomics; the order of every sum is fixed.
// 2. The per-lane chain is short. alpha and the pass test do not depend
//    on T: they are evaluated for BATCH lanes at once from float4 reads
//    of a lane-major shared copy of the payload block, a warp skips a
//    batch none of its pixels passes, and only cum += log1p(-alpha), the
//    stop test and the blend run in lane order.
// The stop test is base + (segcum + cum) >= log(1e-4): segcum sums the
// earlier 128-lane blocks of the segment, cum restarts at each block, as
// the JAX kernel's prefix does. With base = 0 (every short tile) this is
// the one-block kernel's grouping bit for bit; and because the first
// pass adds the same numbers in the same order, a pixel that walks a
// segment without stopping leaves it with exactly the value the next
// segment enters with (entering_log_t groups the blocks' sums as the
// walk does), so the segments agree on where a pixel stopped.
// 3. F up to 8 is instantiated (accumulators in registers); F from 9 to
//    MAX_F (semantics and normals: 27 at 20 classes) runs
//    blend_items_wide_kernel and combine_wide_kernel, F a runtime count
//    (see there).
// Compiled with -fmad=false so each product and sum rounds on its own.
#include "blend_common.cuh"

namespace {

using namespace sgblend;

constexpr int PLAN_THREADS = 1024;
// blocks of the blend an SM should hold (bounds its registers)
#ifndef SG_FWD_MIN_BLOCKS
#define SG_FWD_MIN_BLOCKS 4
#endif

// ---- the work list ----

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

__device__ inline int tile_segments(const int* tile_start, const int* tile_count, int t,
                                    int seg_blocks) {
  const int nb = run_blocks(tile_start[t], tile_count[t]);
  return max(1, (nb + seg_blocks - 1) / seg_blocks);
}

// One block. Items of long tiles first, in tile order, a tile's segments
// in a row; then the short tiles (an empty tile too: its output is
// written like any other).
__global__ void __launch_bounds__(PLAN_THREADS)
    plan_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                int num_tiles, int seg_blocks, int max_items, int* __restrict__ plan) {
  BlockTimer timer(0);
  __shared__ int warp_sums[32][2];
  int* tile_slot = plan + 2;
  int* item_tile = tile_slot + num_tiles;
  int* item_seg = item_tile + max_items;

  // items of long tiles in all: the short tiles' items start there
  int mine = 0, none = 0, n_long, n_none;
  for (int t = threadIdx.x; t < num_tiles; t += PLAN_THREADS) {
    const int ns = tile_segments(tile_start, tile_count, t, seg_blocks);
    if (ns > 1) mine += ns;
  }
  block_scan2(mine, none, n_long, n_none, warp_sums);

  int long_base = 0, short_base = n_long;
  for (int t0 = 0; t0 < num_tiles; t0 += PLAN_THREADS) {
    const int t = t0 + threadIdx.x;
    const int ns = t < num_tiles ? tile_segments(tile_start, tile_count, t, seg_blocks) : 0;
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

// ---- the first pass ----

// One thread block per (item of a long tile, payload block of its
// segment): blocklog[b, p] = the sum of log1p(-alpha) over the lanes of
// payload block b that pixel p passes, in lane order. A tile's last
// segment is left out (nothing enters with its sum), so a payload block
// is written by at most one tile: a boundary block's other tiles end in
// it.
template <int F>
__global__ void __launch_bounds__(PIX, SG_FWD_MIN_BLOCKS)
    block_sums_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                      int num_tiles, int max_items, int seg_blocks, float* __restrict__ blocklog,
                      int grid_x, int c_pad) {
  __shared__ __align__(16) float sm[Rows<F>::FLOATS];

  const Plan plan(plan_data, num_tiles, max_items);
  const int i = blockIdx.x / seg_blocks;
  if (i >= plan.n[0]) return;
  const Item it(plan, i, tile_start, tile_count, seg_blocks);
  if (it.last) return;
  BlockTimer timer(1);
  const int b = it.b_first + blockIdx.x % seg_blocks;
  const int p = threadIdx.x;
  const float px = (float)((it.tile % grid_x) * TILE + p % TILE);
  const float py = (float)((it.tile / grid_x) * TILE + p / TILE);
  stage_block<F>(sm, payload + (size_t)b * c_pad * CHUNK);
  __syncthreads();
  const int lo = max(it.start - b * CHUNK, 0);
  float cum = 0.0f;
  for (int l0 = lo & ~(BATCH - 1); l0 < CHUNK; l0 += BATCH) {
    float alpha[BATCH];
    unsigned pass = 0;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const Alpha a = eval_alpha(load_gauss<F>(sm, l0 + j), px, py);
      alpha[j] = a.alpha;
      if (a.pass && l0 + j >= lo) pass |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (pass >> j & 1) cum += log1pf(-alpha[j]);
    }
  }
  blocklog[(size_t)b * PIX + p] = cum;
}

// ---- a segment's walk ----

// The blend of items [0, plan[1]) (all) or, when `out` is null, [0,
// plan[0]) (the long tiles' only: the boundary state alone).
template <int F>
__global__ void __launch_bounds__(PIX, SG_FWD_MIN_BLOCKS)
    blend_items_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                       int num_tiles, int max_items, int seg_blocks,
                       const float* __restrict__ blocklog, float* __restrict__ part,
                       float* __restrict__ out, int grid_x, int c_pad) {
  constexpr int RP = Rows<F>::RP;
  __shared__ __align__(16) float sm[Rows<F>::FLOATS];

  const Plan plan(plan_data, num_tiles, max_items);
  if ((int)blockIdx.x >= plan.n[out == nullptr ? 0 : 1]) return;
  const Item it(plan, blockIdx.x, tile_start, tile_count, seg_blocks);
  BlockTimer timer(2);
  const int p = threadIdx.x;
  // integer pixel coordinates, as tile_raster2._pixel_coords
  const float px = (float)((it.tile % grid_x) * TILE + p % TILE);
  const float py = (float)((it.tile / grid_x) * TILE + p / TILE);

  const float base =
      it.slot0 >= 0 ? entering_log_t(blocklog, it.b0, it.b_first, seg_blocks, p) : 0.0f;
  const bool entered = base >= LOG_T_EPS;
  bool done = !entered;
  float accum[F];
#pragma unroll
  for (int f = 0; f < F; ++f) accum[f] = 0.0f;
  float segcum = 0.0f;  // log-sum of the segment's earlier blocks

  if (__syncthreads_count(done) < PIX) {
    for (int b = it.b_first; b < it.b_stop; ++b) {
      stage_block<F>(sm, payload + (size_t)b * c_pad * CHUNK);
      __syncthreads();
      if (!__all_sync(FULL, done)) {
        const int lo = max(it.start - b * CHUNK, 0);
        const int hi = min(it.end - b * CHUNK, CHUNK);
        float cum = 0.0f;      // in-block prefix of log(1 - alpha)
        float blended = 0.0f;  // the same over the lanes that blended
        for (int l0 = lo & ~(BATCH - 1); l0 < hi; l0 += BATCH) {
          float alpha[BATCH];
          unsigned pass = 0;
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            const Alpha a = eval_alpha(load_gauss<F>(sm, l0 + j), px, py);
            alpha[j] = a.alpha;
            if (a.pass && l0 + j >= lo && l0 + j < hi) pass |= 1u << j;
          }
          if (done) pass = 0;
          if (!__any_sync(FULL, pass != 0)) continue;
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            if (pass >> j & 1) {
              const float lg = log1pf(-alpha[j]);
              cum += lg;
              const float v = base + (segcum + cum);
              if (!(v >= LOG_T_EPS)) {
                done = true;
                pass = 0;
              } else {
                const float w = alpha[j] * expf(v - lg);
                const float* feat = sm + (l0 + j) * RP + HEADER;
#pragma unroll
                for (int f = 0; f < F; ++f) accum[f] += w * feat[f];
                blended += lg;
              }
            }
          }
        }
        segcum += blended;
      }
      // also the barrier before the next block overwrites `sm`
      if (__syncthreads_count(done) == PIX) break;
    }
  }

  // the pixel's final T is here if it stopped here or the run ends here
  const float t_final = (entered && (done || it.last)) ? expf(base + segcum) : 0.0f;
  float* o = it.slot0 >= 0 ? part + ((size_t)(it.slot0 + it.seg) * PIX + p) * (F + 1)
                           : out + ((size_t)it.tile * PIX + p) * (F + 1);
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = accum[f];
  o[F] = t_final;
}

// out[t] of a long tile: its segments' partials added in segment order
// (exactly one segment holds a pixel's final T, the others 0)
template <int F>
__global__ void __launch_bounds__(PIX)
    combine_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                   const int* __restrict__ plan_data, int num_tiles, int max_items,
                   int seg_blocks, const float* __restrict__ part, float* __restrict__ out) {
  const Plan plan(plan_data, num_tiles, max_items);
  const int t = blockIdx.x, p = threadIdx.x;
  const int slot0 = plan.tile_slot[t];
  if (slot0 < 0) return;
  BlockTimer timer(3);
  const int nseg = (run_blocks(tile_start[t], tile_count[t]) + seg_blocks - 1) / seg_blocks;
  float acc[F + 1];
#pragma unroll
  for (int c = 0; c <= F; ++c) acc[c] = 0.0f;
  for (int k = 0; k < nseg; ++k) {
    const float* q = part + ((size_t)(slot0 + k) * PIX + p) * (F + 1);
#pragma unroll
    for (int c = 0; c <= F; ++c) acc[c] += q[c];
  }
  float* o = out + ((size_t)t * PIX + p) * (F + 1);
#pragma unroll
  for (int c = 0; c <= F; ++c) o[c] = acc[c];
}

// ---- F above MAX_FIXED_F: the same walk, F a runtime count ----
//
// The register accumulators of blend_items_kernel grow with F (27 for
// semantics at 20 classes with normals, up to MAX_F), past what a thread
// of a block that several share an SM can hold. Here they live in
// dynamic shared memory, feature-major ([F][256], each pixel its own
// column: no bank conflict, no barrier), after the staged payload block
// ([128][wide_rp(F)]). The lane walk is the same, and alpha and T still
// do not depend on F, so the run is walked once: the walk keeps the
// batch's BATCH weights in registers, and after the batch each feature
// adds them in lane order, accum[f] += w_j * feat_j[f] for j = 0..7:
// every accumulator sees the sums of the instantiated kernel in the same
// order. The first pass reads the header alone and is the instantiated
// block_sums_kernel (its staging rows beyond the header are never read).
__global__ void __launch_bounds__(PIX, 2)
    blend_items_wide_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                            const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                            int num_tiles, int max_items, int seg_blocks,
                            const float* __restrict__ blocklog, float* __restrict__ part,
                            float* __restrict__ out, int grid_x, int c_pad, int F) {
  extern __shared__ __align__(16) float wsm[];
  const int rp = wide_rp(F);
  float* sm = wsm;                 // [128][rp] the payload block, lane-major
  float* accum = wsm + CHUNK * rp;  // [F][256]

  const Plan plan(plan_data, num_tiles, max_items);
  if ((int)blockIdx.x >= plan.n[out == nullptr ? 0 : 1]) return;
  const Item it(plan, blockIdx.x, tile_start, tile_count, seg_blocks);
  BlockTimer timer(2);
  const int p = threadIdx.x;
  const float px = (float)((it.tile % grid_x) * TILE + p % TILE);
  const float py = (float)((it.tile / grid_x) * TILE + p / TILE);

  const float base =
      it.slot0 >= 0 ? entering_log_t(blocklog, it.b0, it.b_first, seg_blocks, p) : 0.0f;
  const bool entered = base >= LOG_T_EPS;
  bool done = !entered;
  for (int f = 0; f < F; ++f) accum[f * PIX + p] = 0.0f;
  float segcum = 0.0f;

  if (__syncthreads_count(done) < PIX) {
    for (int b = it.b_first; b < it.b_stop; ++b) {
      stage_block_wide(sm, payload + (size_t)b * c_pad * CHUNK, F);
      __syncthreads();
      if (!__all_sync(FULL, done)) {
        const int lo = max(it.start - b * CHUNK, 0);
        const int hi = min(it.end - b * CHUNK, CHUNK);
        float cum = 0.0f;
        float blended = 0.0f;
        for (int l0 = lo & ~(BATCH - 1); l0 < hi; l0 += BATCH) {
          float alpha[BATCH];
          unsigned pass = 0;
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            const Alpha a = eval_alpha(load_gauss_wide(sm, l0 + j, rp), px, py);
            alpha[j] = a.alpha;
            if (a.pass && l0 + j >= lo && l0 + j < hi) pass |= 1u << j;
          }
          if (done) pass = 0;
          if (!__any_sync(FULL, pass != 0)) continue;
          float w[BATCH];
          unsigned blend = 0;
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            w[j] = 0.0f;
            if (pass >> j & 1) {
              const float lg = log1pf(-alpha[j]);
              cum += lg;
              const float v = base + (segcum + cum);
              if (!(v >= LOG_T_EPS)) {
                done = true;
                pass = 0;
              } else {
                w[j] = alpha[j] * expf(v - lg);
                blend |= 1u << j;
                blended += lg;
              }
            }
          }
          if (blend) {
            const float* feat = sm + l0 * rp + HEADER;
            for (int f = 0; f < F; ++f) {
              float a = accum[f * PIX + p];
#pragma unroll
              for (int j = 0; j < BATCH; ++j) {
                if (blend >> j & 1) a += w[j] * feat[j * rp + f];
              }
              accum[f * PIX + p] = a;
            }
          }
        }
        segcum += blended;
      }
      if (__syncthreads_count(done) == PIX) break;
    }
  }

  const float t_final = (entered && (done || it.last)) ? expf(base + segcum) : 0.0f;
  float* o = it.slot0 >= 0 ? part + ((size_t)(it.slot0 + it.seg) * PIX + p) * (F + 1)
                           : out + ((size_t)it.tile * PIX + p) * (F + 1);
  for (int f = 0; f < F; ++f) o[f] = accum[f * PIX + p];
  o[F] = t_final;
}

// combine_kernel with F a runtime count: each channel's partials added in
// segment order, as there
__global__ void __launch_bounds__(PIX)
    combine_wide_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                        const int* __restrict__ plan_data, int num_tiles, int max_items,
                        int seg_blocks, const float* __restrict__ part, float* __restrict__ out,
                        int F) {
  const Plan plan(plan_data, num_tiles, max_items);
  const int t = blockIdx.x, p = threadIdx.x;
  const int slot0 = plan.tile_slot[t];
  if (slot0 < 0) return;
  BlockTimer timer(3);
  const int nseg = (run_blocks(tile_start[t], tile_count[t]) + seg_blocks - 1) / seg_blocks;
  float* o = out + ((size_t)t * PIX + p) * (F + 1);
  for (int c = 0; c <= F; ++c) {
    float acc = 0.0f;
    for (int k = 0; k < nseg; ++k) acc += part[((size_t)(slot0 + k) * PIX + p) * (F + 1) + c];
    o[c] = acc;
  }
}

size_t wide_fwd_smem(int F) { return (size_t)(CHUNK * wide_rp(F) + F * PIX) * sizeof(float); }

int launch_wide(const float* payload, const int* tile_start, const int* tile_count, int* plan,
                float* blocklog, float* part, float* out, int num_tiles, int grid_x, int c_pad,
                int F, int seg_blocks, int max_long, int max_items, cudaStream_t stream) {
  plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(tile_start, tile_count, num_tiles, seg_blocks,
                                              max_items, plan);
  if (max_long > 0) {
    // the header alone: any instantiation's first pass gives these sums
    block_sums_kernel<2><<<max_long * seg_blocks, PIX, 0, stream>>>(
        payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog,
        grid_x, c_pad);
  }
  if (out || max_long > 0) {
    const size_t bytes = wide_fwd_smem(F);
    cudaError_t err = cudaFuncSetAttribute(
        blend_items_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    blend_items_wide_kernel<<<out ? max_items : max_long, PIX, bytes, stream>>>(
        payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog, part,
        out, grid_x, c_pad, F);
  }
  if (out && max_long > 0) {
    combine_wide_kernel<<<num_tiles, PIX, 0, stream>>>(tile_start, tile_count, plan, num_tiles,
                                                       max_items, seg_blocks, part, out, F);
  }
  return (int)cudaGetLastError();
}

template <int F>
int launch(const float* payload, const int* tile_start, const int* tile_count, int* plan,
           float* blocklog, float* part, float* out, int num_tiles, int grid_x, int c_pad,
           int seg_blocks, int max_long, int max_items, cudaStream_t stream) {
  plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(tile_start, tile_count, num_tiles, seg_blocks,
                                              max_items, plan);
  // max_long == 0: no run of these shapes can be long
  if (max_long > 0) {
    block_sums_kernel<F><<<max_long * seg_blocks, PIX, 0, stream>>>(
        payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog,
        grid_x, c_pad);
  }
  if (out || max_long > 0) {
    blend_items_kernel<F><<<out ? max_items : max_long, PIX, 0, stream>>>(
        payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog, part,
        out, grid_x, c_pad);
  }
  if (out && max_long > 0) {
    combine_kernel<F><<<num_tiles, PIX, 0, stream>>>(tile_start, tile_count, plan, num_tiles,
                                                     max_items, seg_blocks, part, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// F = 1..MAX_F blend features (1..8 instantiated, wider counts through
// launch_wide); the wrapper rejects other counts. Writes the
// work list `plan` (2 + num_tiles + 2 * max_items ints), the long tiles'
// boundary state `blocklog` [payload blocks, 256] (only the blocks of
// their segments but the last are written) and `part` [max_long, 256,
// F + 1], and `out`; with out == NULL the boundary state alone (the long
// tiles' items only). max_long and max_items are upper bounds that the
// wrapper computes from the shapes: the launch needs no count from the
// card.
extern "C" int tile_blend_fwd(const float* payload, const int* tile_start,
                              const int* tile_count, int* plan, float* blocklog, float* part,
                              float* out, int num_tiles, int grid_x, int c_pad,
                              int num_features, int seg_blocks, int max_long, int max_items,
                              void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_CASE(N)                                                                        \
  case N:                                                                                 \
    return launch<N>(payload, tile_start, tile_count, plan, blocklog, part, out, num_tiles, \
                     grid_x, c_pad, seg_blocks, max_long, max_items, s);
  switch (num_features) {
    SG_CASE(1)
    SG_CASE(2)
    SG_CASE(3)
    SG_CASE(4)
    SG_CASE(5)
    SG_CASE(6)
    SG_CASE(7)
    SG_CASE(8)
    default:
      if (num_features > MAX_FIXED_F && num_features <= MAX_F) {
        return launch_wide(payload, tile_start, tile_count, plan, blocklog, part, out, num_tiles,
                           grid_x, c_pad, num_features, seg_blocks, max_long, max_items, s);
      }
      return (int)cudaErrorInvalidValue;
  }
#undef SG_CASE
}

// the work list alone, for the checks that hold it against its plain
// version
extern "C" int tile_blend_plan(const int* tile_start, const int* tile_count, int* plan,
                               int num_tiles, int seg_blocks, int max_items, void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  plan_kernel<<<1, PLAN_THREADS, 0, (cudaStream_t)stream>>>(tile_start, tile_count, num_tiles,
                                                            seg_blocks, max_items, plan);
  return (int)cudaGetLastError();
}

#ifdef SG_BLOCK_TIMES
namespace {
template <int F>
int fixed_blocks_per_sm(int region) {
  int n = 0;
  switch (region) {
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, block_sums_kernel<F>, PIX, 0); break;
    case 2: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, blend_items_kernel<F>, PIX, 0); break;
    case 3: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, combine_kernel<F>, PIX, 0); break;
    default: return -1;
  }
  return n;
}
}  // namespace

// blocks of each launch ("region" of the time buffer) an SM holds at once
// at num_features features
extern "C" int sg_blocks_per_sm(int region, int num_features) {
  int n = 0;
  if (num_features < 1 || num_features > MAX_F) return -1;
  if (region == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, plan_kernel, PLAN_THREADS, 0);
    return n;
  }
  if (num_features > MAX_FIXED_F) {
    switch (region) {
      case 1: return fixed_blocks_per_sm<2>(1);
      case 2: {
        const size_t bytes = wide_fwd_smem(num_features);
        cudaFuncSetAttribute(blend_items_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, blend_items_wide_kernel, PIX, bytes);
        return n;
      }
      case 3: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, combine_wide_kernel, PIX, 0); return n;
      default: return -1;
    }
  }
  switch (num_features) {
    case 1: return fixed_blocks_per_sm<1>(region);
    case 2: return fixed_blocks_per_sm<2>(region);
    case 3: return fixed_blocks_per_sm<3>(region);
    case 4: return fixed_blocks_per_sm<4>(region);
    case 5: return fixed_blocks_per_sm<5>(region);
    case 6: return fixed_blocks_per_sm<6>(region);
    case 7: return fixed_blocks_per_sm<7>(region);
    default: return fixed_blocks_per_sm<8>(region);
  }
}
#endif
