// Two ablation kernels of the instance-major tile blend
// (csrc/tile_blend.cu, kernel 2.1), for
// street_gaussians_torch/script/probe_kernel.py. Both walk kernel 2.1's
// own work list, so that they measure what 2.1 pays at its own
// decomposition.
//
// Replaces script/probe_kernel.py::_floor_kernel and ::_mxu_kernel (both
// launched by its call_variant). Inputs as csrc/tile_blend.cu: payload
// [NB + 1, c_pad, 128], each tile's ragged run [tile_start, tile_start +
// tile_count); output [num_tiles, 256, F + 1].
//
// The work list (plan_kernel, build_plan of blend_common.cuh, as
// tile_blend.cu builds it): a run that touches more than seg_blocks
// payload blocks is cut every seg_blocks blocks into segments, one work
// item and one block of 256 threads each, long tiles' items first; a
// short tile is one item. Every launch is sized by the shapes' bounds
// (tile_raster2.plan_bounds) and its blocks beyond the list's count
// return at once, so no count comes back to the host. What held both
// kernels when they ran one block per tile was the street scene's
// longest tile (16,842 lanes beside a median of 50): the launch lasted
// as long as its block (0.114 of 0.127 ms and 7.58 of 8.14 ms on the
// bench frame).
//
// probe_floor: what reading the payload and walking the list cost with
// no blend arithmetic. Bound by bytes. An item's 256 threads each issue
// one 16-byte read of rows 0..7 of each of its blocks (8 rows x 128
// lanes = 256 float4), the reads of up to 8 blocks issued before any
// sum, add them in block order, and reduce once (one barrier an item).
// A short tile writes its [256, F + 1] output, every float of it by
// threads striding linearly over the tile (float4 stores); a long tile's
// item leaves its sum in `part`, and floor_combine_kernel adds a tile's
// sums in segment order. An empty tile reads nothing: 0 and T = 1.
// Cost (bench frame, NVIDIA H100 80GB HBM3 at 700 W): 0.052-0.056 ms of
// device time against a 0.024 ms byte bound. The work list takes 0.011
// ms, and the items' launch 0.036 (0.022 spread evenly): most items read
// one 4 KB block after a chain of dependent reads of the list, so the
// SMs wait on latency more than on bandwidth. Kernel 2.1 pays the same.
//
// probe_blend_mma: the blend's own function, its in-block prefix sums of
// log1p(-alpha) taken on the tensor cores as products with the 0/1
// matrix L[i, j] = (i <= j), the prefix kept in registers.
// Layout. Warp w owns pixel rows 2w and 2w + 1 of the tile: two m-tiles
// of 16 pixels. A block of 128 lanes is walked in slabs of 8 lanes; for
// each (m-tile, slab), mma.sync m16n8k8 (TF32 in, f32 accumulators)
// gives thread (g = lane / 4, q = lane % 4) the prefix at pixels g and
// g + 8 and lanes 2q and 2q + 1 of the slab. The thread evaluates alpha
// at exactly those four (pixel, lane) pairs, once, and feeds their logs
// to the product as its A fragment: the A layout holds column k at
// thread k % 4, so column k of A is taken to be lane pi(k) = 2k (k < 4),
// 2(k - 4) + 1 (k >= 4), and L's rows are permuted alike (B[k][n] =
// (pi(k) <= n)): the accumulator then lands on the lanes the thread
// already holds, and no shuffle or shared memory lies between alpha, the
// prefix, the stop test and the weight. L's fragments are two registers.
// Prefix. loc = (the slab's logs) x B, its inclusive prefix within the
// slab, and tot = (the slab's logs) x ones, its total in every column
// (the two products meet in column 7, which is all ones in both: the
// same bits), both from zero. The block's prefix before the slab, R, is
// carried in f32 registers: S = R + loc, then R += tot. The log operand
// is split into three TF32 terms (hi + mid + lo carry all 24 bits, L is
// exact), so each product is the slab's f32 sum; the carry rounds once a
// slab.
// Stop. v = logT + S; a pixel stops at the first passing lane with v <
// log(1e-4) (the lane is not blended): each thread marks its lanes, and
// only in a slab where some pixel of the warp stops do the four threads
// of a pixel take the minimum of their first marks (two shuffles) and
// the T it stopped with (one more). Blended lanes weigh alpha * exp(v -
// log1p(-alpha)); each thread adds the features of its own lanes, and
// the four partial sums of a pixel are added once, at the item's end.
// A slab of an m-tile in which no pixel passes any lane adds nothing and
// is skipped, slabs outside the run's [lo, hi) are never visited, and a
// warp whose 32 pixels have all stopped skips its products.
// Segments. The first pass (mma_block_sums_kernel: one thread block per
// payload block of a long tile's segments but its last) gives
// blocklog[b, p] = R after the block's last slab: the same products, in
// the same slab order, as the walk's. The walk folds logT += R at the
// end of every block a pixel crosses unstopped, and a segment enters
// with entering_log_t over single blocks, the same fold from 0; so a
// pixel enters a segment with exactly the logT that the walk without
// cuts would carry there, and stops at the same lane whatever the cuts
// (script.probe_kernel.probe_blend_mma_split_plain repeats this
// algebra). Partials are added in segment order (mma_combine_kernel).
// No atomics; every sum has a fixed order.
// Cost (bench frame, NVIDIA H100 80GB HBM3 at 700 W): 1.50 ms against
// kernel 2.1's 0.86, at 3 blocks an SM (SG_PROBE_MIN_BLOCKS). Both spend
// their time evaluating alpha (an exp a pair) and, where a pair passes,
// log1p and the weight's exp; the products and the split add ~10
// instructions a pair, and a warp instruction here covers 4 lanes x 8
// pixels where 2.1's covers 1 lane x 32, so its log1p and exp are skipped
// less often. The chain they replace was not what bounds 2.1.
// Bound as csrc/tile_blend.cu (operations); compiled with -fmad=false.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "blend_common.cuh"

namespace {

using namespace sgblend;

constexpr int WARPS = PIX / 32;
constexpr int FLOOR_ROWS = 8;  // rows 0..7 of a payload block: 256 float4, one a thread
constexpr int FLOOR_BATCH = 8;  // payload blocks whose reads are issued together
constexpr int SLABS = CHUNK / 8;

// blocks of the tensor-core walk an SM should hold (bounds its registers)
// (3: 80 registers and a few spilled words, 1.50 ms on the bench frame
// against 1.72 at 2, its 116 registers unspilled; 4 no faster)
#ifndef SG_PROBE_MIN_BLOCKS
#define SG_PROBE_MIN_BLOCKS 3
#endif

// ---- the work list (tile_blend.cu's) ----

struct RunSegs {
  const int* tile_start;
  const int* tile_count;
  int seg_blocks;
  __device__ int operator()(int t) const {
    const int nb = run_blocks(tile_start[t], tile_count[t]);
    return max(1, (nb + seg_blocks - 1) / seg_blocks);
  }
};

__global__ void __launch_bounds__(PLAN_THREADS)
    probe_plan_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                      int num_tiles, int seg_blocks, int max_items, int* __restrict__ plan) {
  BlockTimer timer(0);
  build_plan(RunSegs{tile_start, tile_count, seg_blocks}, num_tiles, max_items, plan);
}

// ---- probe_floor ----

// the tile's [256, F + 1] output: `v` in every feature, T = 1; the
// block's threads stride linearly over its floats, 16 bytes a store
template <int F>
__device__ inline void write_floor_tile(float* __restrict__ o, float v) {
  constexpr int N4 = PIX * (F + 1) / 4;
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int j = threadIdx.x; j < N4; j += PIX) {
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = (4 * j + c) % (F + 1) == F ? 1.0f : v;
    o4[j] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// (8 blocks an SM, 32 registers: 0.052 ms on the bench frame replayed from
// a CUDA graph, against 0.069 and 0.063 with 128 and 64 threads a block)
template <int F>
__global__ void __launch_bounds__(PIX, 8)
    floor_items_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                       int num_tiles, int max_items, int seg_blocks, float* __restrict__ part,
                       float* __restrict__ out, int c_pad) {
  __shared__ float warp_sum[WARPS];
  const Plan plan(plan_data, num_tiles, max_items);
  if ((int)blockIdx.x >= plan.n[1]) return;
  const Item it(plan, blockIdx.x, tile_start, tile_count, seg_blocks);
  BlockTimer timer(1);
  const int p = threadIdx.x;
  const int nb = it.b_stop - it.b_first;
  const size_t stride = (size_t)c_pad * CHUNK / 4;  // float4s a payload block
  const float4* base = reinterpret_cast<const float4*>(payload) + (size_t)it.b_first * stride + p;
  float s = 0.0f;
  for (int i0 = 0; i0 < nb; i0 += FLOOR_BATCH) {
    float4 v[FLOOR_BATCH];
#pragma unroll
    for (int j = 0; j < FLOOR_BATCH; ++j) {
      v[j] = i0 + j < nb ? __ldg(base + (size_t)(i0 + j) * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < FLOOR_BATCH; ++j) {
      if (i0 + j < nb) s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if (p % 32 == 0) warp_sum[p / 32] = s;
  __syncthreads();
  float total = warp_sum[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) total += warp_sum[w];
  if (it.slot0 >= 0) {
    if (p == 0) part[it.slot0 + it.seg] = total;
    return;
  }
  write_floor_tile<F>(out + (size_t)it.tile * PIX * (F + 1), total);
}

// out[t] of a long tile: its items' sums added in segment order
template <int F>
__global__ void __launch_bounds__(PIX)
    floor_combine_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                         const int* __restrict__ plan_data, int num_tiles, int max_items,
                         int seg_blocks, const float* __restrict__ part, float* __restrict__ out) {
  const Plan plan(plan_data, num_tiles, max_items);
  const int t = blockIdx.x;
  const int slot0 = plan.tile_slot[t];
  if (slot0 < 0) return;
  BlockTimer timer(2);
  const int nseg = (run_blocks(tile_start[t], tile_count[t]) + seg_blocks - 1) / seg_blocks;
  float total = 0.0f;
  for (int k = 0; k < nseg; ++k) total += part[slot0 + k];
  write_floor_tile<F>(out + (size_t)t * PIX * (F + 1), total);
}

// ---- probe_blend_mma: the tensor-core products ----

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d = a x b + d, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four logs a thread holds, x[e] at pixel g + 8 (e >> 1) and lane
// 2q + (e & 1) of the slab (the accumulator's layout), as an A fragment
// in three TF32 terms, and the two products from zero: loc = x B (the
// inclusive prefix within the slab, B the row-permuted L) and tot = x
// ones (the slab's total, in every column). Small terms first.
struct SlabProducts {
  float loc[4], tot[4];
  __device__ SlabProducts(const float (&x)[4], uint32_t bl0, uint32_t bl1) {
    // A: a0 (g, k = q) = lane 2q, a1 (g + 8, q), a2 (g, q + 4) = lane
    // 2q + 1, a3 (g + 8, q + 4)
    const float a[4] = {x[0], x[2], x[1], x[3]};
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = to_tf32(a[e]);
      const float r = a[e] - __uint_as_float(hi[e]);
      mid[e] = to_tf32(r);
      lo[e] = to_tf32(r - __uint_as_float(mid[e]));
    }
    const uint32_t one = __float_as_uint(1.0f);
#pragma unroll
    for (int e = 0; e < 4; ++e) loc[e] = tot[e] = 0.0f;
    mma_tf32(loc, lo, bl0, bl1);
    mma_tf32(loc, mid, bl0, bl1);
    mma_tf32(loc, hi, bl0, bl1);
    mma_tf32(tot, lo, one, one);
    mma_tf32(tot, mid, one, one);
    mma_tf32(tot, hi, one, one);
  }
};

// B = L with its rows permuted as A's columns: thread (g, q) holds
// B[q][g] = (2q <= g) and B[q + 4][g] = (2q + 1 <= g)
__device__ inline void l_fragment(uint32_t& b0, uint32_t& b1) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  b0 = __float_as_uint(2 * q <= g ? 1.0f : 0.0f);
  b1 = __float_as_uint(2 * q + 1 <= g ? 1.0f : 0.0f);
}

// pixel of m-tile mt, half h (row g or g + 8) of this thread's warp
__device__ inline int pixel_of(int mt, int h) {
  const int lane = threadIdx.x % 32;
  return (threadIdx.x / 32) * 32 + mt * 16 + lane / 4 + 8 * h;
}

// the thread's four pixels have all stopped
__device__ inline bool all_done(const bool (&done)[2][2]) {
  return done[0][0] && done[0][1] && done[1][0] && done[1][1];
}

// ---- probe_blend_mma: the first pass ----

// One thread block per (item of a long tile, payload block of its
// segment): blocklog[b, p] = R after the block's last slab, over the
// lanes of the run that pixel p passes (no stop). A tile's last segment
// is left out (nothing enters with its sums).
__global__ void __launch_bounds__(PIX, 4)
    mma_block_sums_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                          int num_tiles, int max_items, int seg_blocks,
                          float* __restrict__ blocklog, int grid_x, int c_pad) {
  __shared__ __align__(16) float sm[Rows<0>::FLOATS];  // the header rows alone
  const Plan plan(plan_data, num_tiles, max_items);
  const int i = blockIdx.x / seg_blocks;
  if (i >= plan.n[0]) return;
  const Item it(plan, i, tile_start, tile_count, seg_blocks);
  if (it.last) return;
  BlockTimer timer(3);
  const int b = it.b_first + blockIdx.x % seg_blocks;
  const int q = threadIdx.x % 4;
  uint32_t bl0, bl1;
  l_fragment(bl0, bl1);
  float px[2], py[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) py[mt] = (float)((it.tile / grid_x) * TILE + pixel_of(mt, 0) / TILE);
#pragma unroll
  for (int h = 0; h < 2; ++h) px[h] = (float)((it.tile % grid_x) * TILE + pixel_of(0, h) % TILE);
  stage_block<0>(sm, payload + (size_t)b * c_pad * CHUNK);
  __syncthreads();
  const int lo = max(it.start - b * CHUNK, 0);
  float R[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int n = lo / 8; n < SLABS; ++n) {
    const int l0 = 8 * n + 2 * q;
    const Gauss gs[2] = {load_gauss<0>(sm, l0), load_gauss<0>(sm, l0 + 1)};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float alpha[4];
      unsigned act = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Alpha a = eval_alpha(gs[e & 1], px[e >> 1], py[mt]);
        alpha[e] = a.alpha;
        if (a.pass && l0 + (e & 1) >= lo) act |= 1u << e;
      }
      if (!__any_sync(FULL, act != 0)) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = 0.0f;
        if (act >> e & 1) x[e] = log1pf(-alpha[e]);
      }
      const SlabProducts sp(x, bl0, bl1);
      R[mt][0] += sp.tot[0];
      R[mt][1] += sp.tot[2];
    }
  }
  // thread q writes pixel (mt = q / 2, h = q % 2)
  const float mine = q == 0 ? R[0][0] : q == 1 ? R[0][1] : q == 2 ? R[1][0] : R[1][1];
  blocklog[(size_t)b * PIX + pixel_of(q / 2, q % 2)] = mine;
}

// ---- probe_blend_mma: a segment's walk ----

template <int F>
__global__ void __launch_bounds__(PIX, SG_PROBE_MIN_BLOCKS)
    mma_blend_items_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                           const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                           int num_tiles, int max_items, int seg_blocks,
                           const float* __restrict__ blocklog, float* __restrict__ part,
                           float* __restrict__ out, int grid_x, int c_pad) {
  constexpr int RP = Rows<F>::RP;
  __shared__ __align__(16) float sm[Rows<F>::FLOATS];
  __shared__ float base_sm[PIX];

  const Plan plan(plan_data, num_tiles, max_items);
  if ((int)blockIdx.x >= plan.n[1]) return;
  const Item it(plan, blockIdx.x, tile_start, tile_count, seg_blocks);
  BlockTimer timer(4);
  const int lane = threadIdx.x % 32, q = lane % 4;
  uint32_t bl0, bl1;
  l_fragment(bl0, bl1);
  float px[2], py[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) py[mt] = (float)((it.tile / grid_x) * TILE + pixel_of(mt, 0) / TILE);
#pragma unroll
  for (int h = 0; h < 2; ++h) px[h] = (float)((it.tile % grid_x) * TILE + pixel_of(0, h) % TILE);

  // the fold of the earlier blocks' sums, one pixel a thread
  base_sm[threadIdx.x] =
      it.slot0 >= 0 ? entering_log_t(blocklog, it.b0, it.b_first, 1, threadIdx.x) : 0.0f;
  __syncthreads();
  float logT[2][2], accum[2][2][F];
  bool entered[2][2], done[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      logT[mt][h] = base_sm[pixel_of(mt, h)];
      entered[mt][h] = logT[mt][h] >= LOG_T_EPS;
      done[mt][h] = !entered[mt][h];
#pragma unroll
      for (int f = 0; f < F; ++f) accum[mt][h][f] = 0.0f;
    }
  }

  if (__syncthreads_count(all_done(done)) < PIX) {
    for (int b = it.b_first; b < it.b_stop; ++b) {
      stage_block<F>(sm, payload + (size_t)b * c_pad * CHUNK);
      __syncthreads();
      if (!__all_sync(FULL, all_done(done))) {
        const int lo = max(it.start - b * CHUNK, 0);
        const int hi = min(it.end - b * CHUNK, CHUNK);
        float R[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        for (int n = lo / 8; n * 8 < hi; ++n) {
          const int l0 = 8 * n + 2 * q;
          const Gauss gs[2] = {load_gauss<F>(sm, l0), load_gauss<F>(sm, l0 + 1)};
          float alpha[2][4];
          unsigned act[2] = {0u, 0u};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int l = l0 + (e & 1);
              const Alpha a = eval_alpha(gs[e & 1], px[e >> 1], py[mt]);
              alpha[mt][e] = a.alpha;
              if (a.pass && l >= lo && l < hi && !done[mt][e >> 1]) act[mt] |= 1u << e;
            }
          }
          if (!__any_sync(FULL, (act[0] | act[1]) != 0)) continue;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (!__any_sync(FULL, act[mt] != 0)) continue;
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              x[e] = 0.0f;
              if (act[mt] >> e & 1) x[e] = log1pf(-alpha[mt][e]);
            }
            const SlabProducts sp(x, bl0, bl1);
            float v[4];
            unsigned flag = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[e] = logT[mt][e >> 1] + (R[mt][e >> 1] + sp.loc[e]);
              if ((act[mt] >> e & 1) && !(v[e] >= LOG_T_EPS)) flag |= 1u << e;
            }
            // the first stopping lane of each pixel (8: none in this slab)
            int stop[2] = {8, 8};
            float t_stop[2] = {0.0f, 0.0f};
            if (__any_sync(FULL, flag != 0)) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                int m = (flag >> (2 * h) & 1) ? 2 * q : (flag >> (2 * h + 1) & 1) ? 2 * q + 1 : 8;
                m = min(m, __shfl_xor_sync(FULL, m, 1));
                m = min(m, __shfl_xor_sync(FULL, m, 2));
                const float mine = (m & 1) ? v[2 * h + 1] - x[2 * h + 1] : v[2 * h] - x[2 * h];
                t_stop[h] = __shfl_sync(FULL, mine, (lane & ~3) | (m >> 1));
                stop[h] = m;
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              if ((act[mt] >> e & 1) && 2 * q + (e & 1) < stop[h]) {
                const float w = alpha[mt][e] * expf(v[e] - x[e]);
                const float* feat = sm + (l0 + (e & 1)) * RP + HEADER;
#pragma unroll
                for (int f = 0; f < F; ++f) accum[mt][h][f] += w * feat[f];
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (stop[h] < 8) {
                done[mt][h] = true;
                logT[mt][h] = t_stop[h];
              }
              R[mt][h] += sp.tot[2 * h];
            }
          }
          if (__all_sync(FULL, all_done(done))) break;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!done[mt][h]) logT[mt][h] += R[mt][h];
          }
        }
      }
      // also the barrier before the next block overwrites `sm`
      if (__syncthreads_count(all_done(done)) == PIX) break;
    }
  }

  // a pixel's four partial sums, then thread q writes pixel (q / 2, q % 2)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float a = accum[mt][h][f];
        a += __shfl_xor_sync(FULL, a, 1);
        a += __shfl_xor_sync(FULL, a, 2);
        accum[mt][h][f] = a;
      }
    }
  }
  // (indices known at compile time keep the arrays in registers)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q != 2 * mt + h) continue;
      const int p = pixel_of(mt, h);
      // the pixel's final T is here if it stopped here or the run ends here
      const float t_final =
          (entered[mt][h] && (done[mt][h] || it.last)) ? expf(logT[mt][h]) : 0.0f;
      float* o = it.slot0 >= 0 ? part + ((size_t)(it.slot0 + it.seg) * PIX + p) * (F + 1)
                               : out + ((size_t)it.tile * PIX + p) * (F + 1);
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = accum[mt][h][f];
      o[F] = t_final;
    }
  }
}

// out[t] of a long tile: its segments' partials added in segment order
// (exactly one segment holds a pixel's final T, the others 0)
template <int F>
__global__ void __launch_bounds__(PIX)
    mma_combine_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                       const int* __restrict__ plan_data, int num_tiles, int max_items,
                       int seg_blocks, const float* __restrict__ part, float* __restrict__ out) {
  const Plan plan(plan_data, num_tiles, max_items);
  const int t = blockIdx.x, p = threadIdx.x;
  const int slot0 = plan.tile_slot[t];
  if (slot0 < 0) return;
  BlockTimer timer(5);
  const int nseg = (run_blocks(tile_start[t], tile_count[t]) + seg_blocks - 1) / seg_blocks;
  float acc[F + 1];
#pragma unroll
  for (int c = 0; c <= F; ++c) acc[c] = 0.0f;
  for (int k = 0; k < nseg; ++k) {
    const float* src = part + ((size_t)(slot0 + k) * PIX + p) * (F + 1);
#pragma unroll
    for (int c = 0; c <= F; ++c) acc[c] += src[c];
  }
  float* o = out + ((size_t)t * PIX + p) * (F + 1);
#pragma unroll
  for (int c = 0; c <= F; ++c) o[c] = acc[c];
}

template <int F>
int launch_floor(const float* payload, const int* tile_start, const int* tile_count, int* plan,
                 float* part, float* out, int num_tiles, int c_pad, int seg_blocks, int max_long,
                 int max_items, cudaStream_t stream) {
  probe_plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(tile_start, tile_count, num_tiles, seg_blocks,
                                                    max_items, plan);
  floor_items_kernel<F><<<max_items, PIX, 0, stream>>>(
      payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, part, out, c_pad);
  if (max_long > 0) {
    floor_combine_kernel<F><<<num_tiles, PIX, 0, stream>>>(tile_start, tile_count, plan, num_tiles,
                                                           max_items, seg_blocks, part, out);
  }
  return (int)cudaGetLastError();
}

template <int F>
int launch_mma(const float* payload, const int* tile_start, const int* tile_count, int* plan,
               float* blocklog, float* part, float* out, int num_tiles, int grid_x, int c_pad,
               int seg_blocks, int max_long, int max_items, cudaStream_t stream) {
  probe_plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(tile_start, tile_count, num_tiles, seg_blocks,
                                                    max_items, plan);
  // max_long == 0: no run of these shapes can be long
  if (max_long > 0) {
    mma_block_sums_kernel<<<max_long * seg_blocks, PIX, 0, stream>>>(
        payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog, grid_x,
        c_pad);
  }
  mma_blend_items_kernel<F><<<max_items, PIX, 0, stream>>>(
      payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog, part, out,
      grid_x, c_pad);
  if (max_long > 0) {
    mma_combine_kernel<F><<<num_tiles, PIX, 0, stream>>>(tile_start, tile_count, plan, num_tiles,
                                                         max_items, seg_blocks, part, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define SG_SWITCH(CALL)              \
  switch (num_features) {            \
    case 1: return CALL(1);          \
    case 2: return CALL(2);          \
    case 3: return CALL(3);          \
    case 4: return CALL(4);          \
    case 5: return CALL(5);          \
    case 6: return CALL(6);          \
    case 7: return CALL(7);          \
    case 8: return CALL(8);          \
    default: return (int)cudaErrorInvalidValue; \
  }

// F = 1..8 blend features; the wrappers reject other counts. The payload
// needs at least 8 rows (c_pad is a multiple of 8). Both write the work
// list `plan` (2 + num_tiles + 2 * max_items ints) for seg_blocks
// payload blocks a segment; max_long and max_items are the bounds
// tile_raster2.plan_bounds computes from the shapes. The floor leaves a
// long tile's item sums in `part` [max_long]; the tensor-core blend its
// first pass's sums in `blocklog` [payload blocks, 256] (the blocks of
// the long tiles' segments but their last) and its partials in `part`
// [max_long, 256, F + 1].
extern "C" int probe_floor(const float* payload, const int* tile_start, const int* tile_count,
                           int* plan, float* part, float* out, int num_tiles, int c_pad,
                           int num_features, int seg_blocks, int max_long, int max_items,
                           void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_FLOOR(N) \
  launch_floor<N>(payload, tile_start, tile_count, plan, part, out, num_tiles, c_pad, seg_blocks, \
                  max_long, max_items, s)
  SG_SWITCH(SG_FLOOR)
#undef SG_FLOOR
}

extern "C" int probe_blend_mma(const float* payload, const int* tile_start, const int* tile_count,
                               int* plan, float* blocklog, float* part, float* out, int num_tiles,
                               int grid_x, int c_pad, int num_features, int seg_blocks,
                               int max_long, int max_items, void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_MMA(N)                                                                                 \
  launch_mma<N>(payload, tile_start, tile_count, plan, blocklog, part, out, num_tiles, grid_x,  \
                c_pad, seg_blocks, max_long, max_items, s)
  SG_SWITCH(SG_MMA)
#undef SG_MMA
}

#ifdef SG_BLOCK_TIMES
namespace {
template <int F>
int blocks_per_sm(int region) {
  int n = 0;
  switch (region) {
    case 0: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, probe_plan_kernel, PLAN_THREADS, 0); break;
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, floor_items_kernel<F>, PIX, 0); break;
    case 2: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, floor_combine_kernel<F>, PIX, 0); break;
    case 3: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mma_block_sums_kernel, PIX, 0); break;
    case 4: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mma_blend_items_kernel<F>, PIX, 0); break;
    case 5: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mma_combine_kernel<F>, PIX, 0); break;
    default: return -1;
  }
  return n;
}
}  // namespace

// blocks of each launch ("region" of the time buffer) an SM holds at once
extern "C" int sg_blocks_per_sm(int region, int num_features) {
#define SG_OCC(N) blocks_per_sm<N>(region)
  SG_SWITCH(SG_OCC)
#undef SG_OCC
}
#endif
