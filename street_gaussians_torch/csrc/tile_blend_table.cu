// Forward tile blend over a dense per-tile table.
//
// Replaces street_gaussians_tpu/ops/tile_raster.py::_fwd_kernel. Tile t
// owns payload[t], a [c_pad, K] table of its depth-ordered Gaussians:
// rows mean x, mean y, conic a/b/c, opacity, then F features; opacity 0
// marks an empty slot. The tile's count only sets how many 128-lane
// chunks are read, min(cdiv(count, 128), K / 128): no lane is masked by
// the count. Per pixel, front to back:
//   alpha = min(0.99, op * exp(min(power, 0))), skipped when power > 0
//   or alpha < 1/255; with T the transmittance before the chunk and cp
//   the running product of (1 - alpha) inside it, the pixel stops at the
//   first Gaussian with T * cp * (1 - alpha) < 1e-4, which is not
//   blended; a blended Gaussian weighs alpha * T * cp; after the chunk
//   T *= cp.
// Output [num_tiles, 256, F + 1]: the F blended features, then final T.
//
// Bound on the H100: the per-pixel exp and arithmetic (256 pixels times
// the slots each pixel reaches before it stops), far above the bytes of
// the live chunks. What held the one-block-per-tile kernel at 3% of that
// bound: a tile's chunks were walked in turn by one block, and on the
// bench frame a median tile holds ~50 Gaussians where the largest holds
// ~17,000 (139 chunks), so the launch lasted as long as its longest
// tile; each lane was one dependent chain; and each chunk was copied
// before, not while, the previous one was walked.
//
// Design.
// 1. Long tiles are cut. plan_kernel (build_plan, blend_common.cuh)
//    lists the work: a tile of more than seg_chunks chunks is long and
//    cut into segments of seg_chunks chunks, each a work item with its
//    own block of 256 threads (one per pixel), long tiles' items first;
//    every other tile is one item.
// 2. Segments agree exactly with the unsplit walk, in product form. A
//    first pass (chunk_prod_kernel, one block per chunk of a long tile's
//    segments but its last) gives every pixel's product P_c of (1 -
//    alpha) over its passing lanes of chunk c, multiplied in lane order
//    from 1.0f with no stop: exactly the walk's cp after a chunk in which
//    the pixel does not stop. Segment k enters with T_k = the products
//    of the tile's earlier chunks folded in chunk order (T = T * P_c,
//    the walk's grouping), so while a pixel has not stopped T_k is the
//    walk's T bit for bit. It had stopped before k exactly when T_k <
//    1e-4: the walk stops in chunk c at the first lane where T_c *
//    cp_incl < 1e-4; cp_incl only falls along a chunk and rounding is
//    monotone, so T_c * P_c <= T_c * cp_incl < 1e-4 exactly when the
//    chunk stops the pixel, and a later T is smaller still. Each
//    segment blends from that state into a partial [256, F] accumulator
//    and writes the final T where it holds the pixel's stop or the
//    tile's end (0 elsewhere); combine_kernel adds a tile's partials in
//    segment order. A tile of one segment is the unsplit walk, bit for
//    bit. The products and the partials stay on the card as the
//    backward's entering state. The block still leaves a segment once
//    all 256 pixels have stopped (the JAX kernel's chunk skip).
// 3. The per-lane chain is short. alpha and the pass test do not depend
//    on T: they are evaluated for BATCH lanes at once from float4 reads
//    of a lane-major shared copy of the chunk, a warp skips a batch none
//    of its pixels passes, and only the product, the stop test and the
//    blend run in lane order. The next chunk's 6 + F rows are copied
//    with cp.async into a second buffer while the current one is walked
//    (table_common.cuh; one buffer in the runtime-count kernel).
// 4. F up to 8 is instantiated (accumulators in registers); F from 9 to
//    MAX_F runs blend_items_wide_kernel and combine_wide_kernel, F a
//    runtime count (see there).
// Compiled with -fmad=false so that every product and sum rounds on its
// own, as in the plain PyTorch version.
#include "table_common.cuh"

namespace {

using namespace sgtable;

// blocks of the blend an SM should hold (bounds its registers), and of
// the runtime-count blend
#ifndef SG_TABLE_MIN_BLOCKS
#define SG_TABLE_MIN_BLOCKS 4
#endif
#ifndef SG_TABLE_WIDE_MIN_BLOCKS
#define SG_TABLE_WIDE_MIN_BLOCKS 4
#endif

__global__ void __launch_bounds__(PLAN_THREADS)
    plan_kernel(const int* __restrict__ tile_count, int num_tiles, int K, int seg_chunks,
                int max_items, int* __restrict__ plan) {
  BlockTimer timer(0);
  build_plan(TableSegments{tile_count, K, seg_chunks}, num_tiles, max_items, plan);
}

// ---- the first pass ----

// One block per (item of a long tile, chunk of its segment), the last
// segment left out (nothing enters after it): prod[(slot * seg_chunks +
// j) * 256 + p], slot the item's, j the chunk's place in the segment =
// the product of (1 - alpha) over the chunk's lanes that pixel p passes,
// in lane order. Reads the header rows only.
__global__ void __launch_bounds__(PIX, SG_TABLE_MIN_BLOCKS)
    chunk_prod_kernel(const float* __restrict__ payload, const int* __restrict__ tile_count,
                      const int* __restrict__ plan_data, int num_tiles, int max_items,
                      int seg_chunks, float* __restrict__ prod, int grid_x, int c_pad, int K) {
  using R = Rows<2>;  // the six header rows, lane-major
  __shared__ __align__(16) float sm[R::FLOATS];

  const Plan plan(plan_data, num_tiles, max_items);
  const int i = blockIdx.x / seg_chunks;
  const TableItem it(plan, i, tile_count, K, seg_chunks);
  if (it.last) return;
  BlockTimer timer(1);
  const int j = blockIdx.x % seg_chunks;
  const int p = threadIdx.x;
  const float px = (float)((it.tile % grid_x) * TILE + p % TILE);
  const float py = (float)((it.tile / grid_x) * TILE + p / TILE);
  const float* src = payload + (size_t)it.tile * c_pad * K + (size_t)(it.c_first + j) * CHUNK;
  for (int k = p; k < HEADER * CHUNK; k += PIX) {
    sm[(k % CHUNK) * R::RP + k / CHUNK] = src[(size_t)(k / CHUNK) * K + k % CHUNK];
  }
  __syncthreads();
  float P = 1.0f;
  for (int l0 = 0; l0 < CHUNK; l0 += BATCH) {
    float alpha[BATCH];
    unsigned pass = 0;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const Alpha a = eval_alpha(load_gauss<2>(sm, l0 + b), px, py);
      alpha[b] = a.alpha;
      if (a.pass) pass |= 1u << b;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (pass >> b & 1) P = P * (1.0f - alpha[b]);
    }
  }
  prod[((size_t)i * seg_chunks + j) * PIX + p] = P;
}

// ---- a segment's walk ----

// The blend of items [0, n) (all, or with `out` null the long tiles'
// only: the boundary state alone).
template <int F>
__global__ void __launch_bounds__(PIX, SG_TABLE_MIN_BLOCKS)
    blend_items_kernel(const float* __restrict__ payload, const int* __restrict__ tile_count,
                       const int* __restrict__ plan_data, int num_tiles, int max_items,
                       int seg_chunks, const float* __restrict__ prod, float* __restrict__ part,
                       float* __restrict__ out, int grid_x, int c_pad, int K) {
  using R = Rows<F>;
  __shared__ __align__(16) float sm[2 * R::FLOATS];

  const Plan plan(plan_data, num_tiles, max_items);
  const TableItem it(plan, blockIdx.x, tile_count, K, seg_chunks);
  BlockTimer timer(2);
  const ChunkStager st{sm, R::FLOATS, 2, R::ROWS, R::RP, K, it.c_first, it.c_stop,
                       payload + (size_t)it.tile * c_pad * K};
  st.start();
  const int p = threadIdx.x;
  // integer pixel coordinates, as tile_raster2._pixel_coords
  const float px = (float)((it.tile % grid_x) * TILE + p % TILE);
  const float py = (float)((it.tile / grid_x) * TILE + p / TILE);

  float T = it.slot0 >= 0 ? entering_t(prod, it.slot0, it.seg, seg_chunks, p) : 1.0f;
  const bool entered = T >= T_EPS;
  bool done = !entered;
  float accum[F];
#pragma unroll
  for (int f = 0; f < F; ++f) accum[f] = 0.0f;

  if (__syncthreads_count(done) < PIX) {
    for (int c = it.c_first; c < it.c_stop; ++c) {
      const float* s = st.get(c);
      float cp = 1.0f;  // product of (1 - alpha) over the chunk's blended lanes
      if (!__all_sync(FULL, done)) {
        for (int l0 = 0; l0 < CHUNK; l0 += BATCH) {
          float alpha[BATCH];
          unsigned pass = 0;
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            const Alpha a = eval_alpha(load_gauss<F>(s, l0 + b), px, py);
            alpha[b] = a.alpha;
            if (a.pass) pass |= 1u << b;
          }
          if (done) pass = 0;
          if (!__any_sync(FULL, pass != 0)) continue;
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (pass >> b & 1) {
              const float cp_incl = cp * (1.0f - alpha[b]);
              if (T * cp_incl < T_EPS) {
                done = true;
                pass = 0;
              } else {
                const float w = alpha[b] * T * cp;
                const float* feat = s + (l0 + b) * R::RP + HEADER;
#pragma unroll
                for (int f = 0; f < F; ++f) accum[f] += w * feat[f];
                cp = cp_incl;
              }
            }
          }
        }
      }
      T = T * cp;  // cp stays 1 for a pixel that had stopped
      // also the barrier before the chunk's buffer is refilled
      if (__syncthreads_count(done) == PIX) break;
    }
  }
  st.finish();

  // the pixel's final T is here if it stopped here or the tile ends here
  const float t_final = (entered && (done || it.last)) ? T : 0.0f;
  float* o = it.slot0 >= 0 ? part + ((size_t)(it.slot0 + it.seg) * PIX + p) * (F + 1)
                           : out + ((size_t)it.tile * PIX + p) * (F + 1);
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = accum[f];
  o[F] = t_final;
}

// out[t] of a long tile, from the block of its first item: its segments'
// partials added in segment order (exactly one segment holds a pixel's
// final T, the others 0)
template <int F>
__global__ void __launch_bounds__(PIX)
    combine_kernel(const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                   int num_tiles, int max_items, int seg_chunks, int K,
                   const float* __restrict__ part, float* __restrict__ out) {
  const Plan plan(plan_data, num_tiles, max_items);
  if (plan.item_seg[blockIdx.x] != 0) return;
  BlockTimer timer(3);
  const int t = plan.item_tile[blockIdx.x], p = threadIdx.x;
  const int slot0 = blockIdx.x;
  const int nseg = table_segments(table_chunks(tile_count[t], K), seg_chunks);
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
// The accumulators live in dynamic shared memory, feature-major ([F][256],
// each pixel its own column: no bank conflict, no barrier), after one
// staging buffer ([128][wide_rp(F)]): a second one would cost a block an
// SM (at F = 27 3 instead of 4, 8% slower on the bench table on an H100
// at 700 W, script.block_times --table --features 27). A blended lane
// adds its features as it is walked, accum[f] += w * feat[f], so every
// accumulator sees the sums of the instantiated kernel in the same order
// and a lane that does not blend costs no feature work. The first pass
// reads the header alone and is the same kernel.
size_t wide_fwd_smem(int F) { return (size_t)(CHUNK * wide_rp(F) + F * PIX) * sizeof(float); }

__global__ void __launch_bounds__(PIX, SG_TABLE_WIDE_MIN_BLOCKS)
    blend_items_wide_kernel(const float* __restrict__ payload, const int* __restrict__ tile_count,
                            const int* __restrict__ plan_data, int num_tiles, int max_items,
                            int seg_chunks, const float* __restrict__ prod,
                            float* __restrict__ part, float* __restrict__ out, int grid_x,
                            int c_pad, int K, int F) {
  extern __shared__ __align__(16) float wsm[];
  const int rp = wide_rp(F);
  float* accum = wsm + CHUNK * rp;  // [F][256]

  const Plan plan(plan_data, num_tiles, max_items);
  const TableItem it(plan, blockIdx.x, tile_count, K, seg_chunks);
  BlockTimer timer(2);
  const ChunkStager st{wsm, CHUNK * rp, 1, HEADER + F, rp, K, it.c_first, it.c_stop,
                       payload + (size_t)it.tile * c_pad * K};
  st.start();
  const int p = threadIdx.x;
  const float px = (float)((it.tile % grid_x) * TILE + p % TILE);
  const float py = (float)((it.tile / grid_x) * TILE + p / TILE);

  float T = it.slot0 >= 0 ? entering_t(prod, it.slot0, it.seg, seg_chunks, p) : 1.0f;
  const bool entered = T >= T_EPS;
  bool done = !entered;
  for (int f = 0; f < F; ++f) accum[f * PIX + p] = 0.0f;

  if (__syncthreads_count(done) < PIX) {
    for (int c = it.c_first; c < it.c_stop; ++c) {
      const float* s = st.get(c);
      float cp = 1.0f;
      if (!__all_sync(FULL, done)) {
        for (int l0 = 0; l0 < CHUNK; l0 += BATCH) {
          float alpha[BATCH];
          unsigned pass = 0;
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            const Alpha a = eval_alpha(load_gauss_wide(s, l0 + b, rp), px, py);
            alpha[b] = a.alpha;
            if (a.pass) pass |= 1u << b;
          }
          if (done) pass = 0;
          if (!__any_sync(FULL, pass != 0)) continue;
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            if (pass >> b & 1) {
              const float cp_incl = cp * (1.0f - alpha[b]);
              if (T * cp_incl < T_EPS) {
                done = true;
                pass = 0;
              } else {
                const float w = alpha[b] * T * cp;
                const float* feat = s + (l0 + b) * rp + HEADER;
                for (int f = 0; f < F; ++f) accum[f * PIX + p] += w * feat[f];
                cp = cp_incl;
              }
            }
          }
        }
      }
      T = T * cp;
      if (__syncthreads_count(done) == PIX) break;
    }
  }
  st.finish();

  const float t_final = (entered && (done || it.last)) ? T : 0.0f;
  float* o = it.slot0 >= 0 ? part + ((size_t)(it.slot0 + it.seg) * PIX + p) * (F + 1)
                           : out + ((size_t)it.tile * PIX + p) * (F + 1);
  for (int f = 0; f < F; ++f) o[f] = accum[f * PIX + p];
  o[F] = t_final;
}

// combine_kernel with F a runtime count: each channel's partials added in
// segment order, as there
__global__ void __launch_bounds__(PIX)
    combine_wide_kernel(const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                        int num_tiles, int max_items, int seg_chunks, int K,
                        const float* __restrict__ part, float* __restrict__ out, int F) {
  const Plan plan(plan_data, num_tiles, max_items);
  if (plan.item_seg[blockIdx.x] != 0) return;
  BlockTimer timer(3);
  const int t = plan.item_tile[blockIdx.x], p = threadIdx.x;
  const int slot0 = blockIdx.x;
  const int nseg = table_segments(table_chunks(tile_count[t], K), seg_chunks);
  float* o = out + ((size_t)t * PIX + p) * (F + 1);
  for (int c = 0; c <= F; ++c) {
    float acc = 0.0f;
    for (int k = 0; k < nseg; ++k) acc += part[((size_t)(slot0 + k) * PIX + p) * (F + 1) + c];
    o[c] = acc;
  }
}

struct Launch {
  const float* payload;
  const int* tile_count;
  const int* plan;
  float* prod;
  float* part;
  float* out;
  int num_tiles, grid_x, c_pad, K, F, seg_chunks, n_long, n_items, max_items;
  cudaStream_t stream;
};

// the first pass, the blend and the combine of a plan that is already on
// the card; F = 0 for the runtime-count kernels (a.F)
template <int F>
int launch(const Launch& a) {
  if (a.n_long > 0) {
    chunk_prod_kernel<<<a.n_long * a.seg_chunks, PIX, 0, a.stream>>>(
        a.payload, a.tile_count, a.plan, a.num_tiles, a.max_items, a.seg_chunks, a.prod, a.grid_x,
        a.c_pad, a.K);
  }
  const int items = a.out ? a.n_items : a.n_long;
  if (items > 0) {
    if constexpr (F > 0) {
      blend_items_kernel<F><<<items, PIX, 0, a.stream>>>(
          a.payload, a.tile_count, a.plan, a.num_tiles, a.max_items, a.seg_chunks, a.prod, a.part,
          a.out, a.grid_x, a.c_pad, a.K);
    } else {
      const size_t bytes = wide_fwd_smem(a.F);
      cudaError_t err = cudaFuncSetAttribute(
          blend_items_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      blend_items_wide_kernel<<<items, PIX, bytes, a.stream>>>(
          a.payload, a.tile_count, a.plan, a.num_tiles, a.max_items, a.seg_chunks, a.prod, a.part,
          a.out, a.grid_x, a.c_pad, a.K, a.F);
    }
  }
  if (a.out && a.n_long > 0) {
    if constexpr (F > 0) {
      combine_kernel<F><<<a.n_long, PIX, 0, a.stream>>>(a.tile_count, a.plan, a.num_tiles,
                                                        a.max_items, a.seg_chunks, a.K, a.part,
                                                        a.out);
    } else {
      combine_wide_kernel<<<a.n_long, PIX, 0, a.stream>>>(a.tile_count, a.plan, a.num_tiles,
                                                          a.max_items, a.seg_chunks, a.K, a.part,
                                                          a.out, a.F);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The work list (2 + num_tiles + 2 * max_items ints, blend_common.cuh's
// layout): the wrapper reads its two counts back before tile_blend_table_fwd.
extern "C" int tile_blend_table_plan(const int* tile_count, int* plan, int num_tiles, int K,
                                     int seg_chunks, int max_items, void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  plan_kernel<<<1, PLAN_THREADS, 0, (cudaStream_t)stream>>>(tile_count, num_tiles, K, seg_chunks,
                                                            max_items, plan);
  return (int)cudaGetLastError();
}

// F = 1..MAX_F blend features (1..8 instantiated, wider counts through the
// runtime-count kernels) and K a multiple of 128; the wrapper rejects
// anything else. With the work list `plan` and its counts n_long and
// n_items, writes the long tiles' boundary state, `prod` [n_long *
// seg_chunks, 256] (the chunks of their segments but the last) and
// `part` [n_long, 256, F + 1], and `out`; with out == NULL the boundary
// state alone.
extern "C" int tile_blend_table_fwd(const float* payload, const int* tile_count, const int* plan,
                                    float* prod, float* part, float* out, int num_tiles,
                                    int grid_x, int c_pad, int K, int num_features,
                                    int seg_chunks, int n_long, int n_items, int max_items,
                                    void* stream) {
  const Launch a{payload, tile_count, plan, prod, part, out, num_tiles, grid_x, c_pad, K,
                 num_features, seg_chunks, n_long, n_items, max_items, (cudaStream_t)stream};
  switch (num_features) {
    case 1: return launch<1>(a);
    case 2: return launch<2>(a);
    case 3: return launch<3>(a);
    case 4: return launch<4>(a);
    case 5: return launch<5>(a);
    case 6: return launch<6>(a);
    case 7: return launch<7>(a);
    case 8: return launch<8>(a);
    default:
      if (num_features > MAX_FIXED_F && num_features <= MAX_F) return launch<0>(a);
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef SG_BLOCK_TIMES
namespace {
template <int F>
int fixed_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, blend_items_kernel<F>, PIX, 0);
  return n;
}
}  // namespace

// blocks of each launch ("region" of the time buffer) an SM holds at once
// at num_features features
extern "C" int sg_blocks_per_sm(int region, int num_features) {
  int n = 0;
  if (num_features < 1 || num_features > MAX_F) return -1;
  switch (region) {
    case 0: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, plan_kernel, PLAN_THREADS, 0); return n;
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, chunk_prod_kernel, PIX, 0); return n;
    case 3: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, combine_kernel<1>, PIX, 0); return n;
    case 2: break;
    default: return -1;
  }
  if (num_features > MAX_FIXED_F) {
    const size_t bytes = wide_fwd_smem(num_features);
    cudaFuncSetAttribute(blend_items_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, blend_items_wide_kernel, PIX, bytes);
    return n;
  }
  switch (num_features) {
    case 1: return fixed_blocks_per_sm<1>();
    case 2: return fixed_blocks_per_sm<2>();
    case 3: return fixed_blocks_per_sm<3>();
    case 4: return fixed_blocks_per_sm<4>();
    case 5: return fixed_blocks_per_sm<5>();
    case 6: return fixed_blocks_per_sm<6>();
    case 7: return fixed_blocks_per_sm<7>();
    default: return fixed_blocks_per_sm<8>();
  }
}
#endif
