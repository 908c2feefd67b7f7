// Backward of the instance-major tile blend (csrc/tile_blend.cu).
//
// Replaces street_gaussians_tpu/ops/tile_raster2.py::_bwd_kernel. Each
// work item of the forward's list (a short tile's run, or one segment of
// a long tile's) is re-walked in forward order with the forward's stop
// rule and grouping (blend_common.cuh, tile_blend.cu). For every blended
// (pixel, instance) pair, with w = alpha * T_before, phi = g . features,
// u = w * phi:
//   suffix = S_total - (prefix of u through this instance), where
//            S_total = g . out_features (as the JAX kernel, so both
//            round the same way);
//   da     = T_before * phi - (suffix + gT * T_final) / (1 - alpha);
//   da_eff = da where op * exp(power) <= 0.99, else 0 (the clamp);
//   dpow   = op * exp(power) * da_eff.
// Per instance lane it writes c_pad gradient rows: d mean x/y, d conic
// a/b/c, d opacity (exp(power) * da_eff), d features (sum of g * w), and
// the two AbsGS rows (per-pixel |d mean x|, |d mean y| summed).
//
// Bound on the H100: the per-pair exp/log1p and arithmetic of the
// re-walk plus the gradient terms, far above the bytes. The
// one-block-per-tile kernel reached 2% of it for two reasons: its launch
// lasted as long as its longest tile's block (8.43 of 8.47 ms on the
// bench step; 2.0 ms if the same blocks spread evenly), and per lane all
// eight warps ran a five-level shuffle tree over every gradient row (60
// shuffles a lane and warp).
//
// Design.
// 1. Segments are independent blocks. A pixel enters segment k of a long
//    tile with the log transmittance the forward's first pass gives (the
//    sum of the earlier segments' log-sums) and with the prefix of u
//    equal to g . (the forward's accumulator before the segment), the
//    sum of the earlier segments' partials: both are the boundary state
//    the forward leaves on the card. Every instance slot belongs to one
//    tile and one segment, so a block writes only its own lanes into the
//    zero-initialised d_payload: no atomics.
// 2. The walk evaluates alpha for BATCH lanes at once, as the forward.
// 3. No shuffle tree. All 8 + F gradient rows of a pair follow from three
//    scalars (dpow, exp(power) * da_eff, w) and the pixel's dx, dy, g. A
//    pixel's thread stores those three for LB lanes in shared memory
//    ([3][256][LB + 1]); then the block turns lane-parallel: thread
//    (lane, q) forms the rows' per-pixel products for pixels q, q + NQ,
//    ... (NQ = 256 / LB) and adds them in that order, and the NQ partial
//    sums of a (row, lane) are added in q order. The order is fixed, so
//    a repeat is bit-equal; a pair that did not blend (w = 0) is skipped,
//    and a batch of lanes that no pixel blends skips the reduction.
// 4. F up to 8 is instantiated; F from 9 to MAX_F runs
//    tile_blend_bwd_wide_kernel, F a runtime count (see there).
// Compiled with -fmad=false, like the forward, so each product and sum
// rounds as in the plain version.
#include "blend_common.cuh"

// lanes per batch of the reduction, and the blocks an SM should hold
#ifndef SG_BWD_LB
#define SG_BWD_LB 16
#endif
#ifndef SG_BWD_MIN_BLOCKS
#define SG_BWD_MIN_BLOCKS 3
#endif

namespace {

using namespace sgblend;

template <int F, int LB>
struct Smem {
  static constexpr int NG = HEADER + F + 2;  // gradient rows written
  static constexpr int NQ = PIX / LB;        // pixel groups of the reduction
  static constexpr int GP = (F + 3) / 4 * 4;
  static constexpr int SCS = LB + 1;  // a pixel's stride in a scalar plane
  // a pixel group's stride in the partials, padded so that the groups of
  // one warp fall on different banks
  static constexpr int QS = NG * LB + (LB < 32 ? (LB - (NG * LB) % 32 + 32) % 32 : 0);
  static constexpr int ROWS_AT = 0;
  static constexpr int G_AT = ROWS_AT + Rows<F>::FLOATS;
  static constexpr int SC_AT = G_AT + PIX * GP;
  static constexpr int PART_AT = SC_AT + 3 * PIX * SCS;
  static constexpr int FLOATS = PART_AT + NQ * QS;
  static_assert(PIX % LB == 0 && LB % BATCH == 0 && CHUNK % LB == 0, "lane batch");
  static_assert(NG * LB <= 2 * PIX, "row sums per batch");
};

template <int F, int LB>
__global__ void __launch_bounds__(PIX, SG_BWD_MIN_BLOCKS)
    tile_blend_bwd_kernel(const float* __restrict__ payload, const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count, const int* __restrict__ plan_data,
                          int num_tiles, int max_items, int seg_blocks,
                          const float* __restrict__ blocklog, const float* __restrict__ part,
                          const float* __restrict__ out, const float* __restrict__ gout,
                          float* __restrict__ d_payload, int grid_x, int c_pad) {
  using S = Smem<F, LB>;
  constexpr int RP = Rows<F>::RP, NG = S::NG, NQ = S::NQ, SCS = S::SCS;
  extern __shared__ __align__(16) float smem[];
  float* sm = smem + S::ROWS_AT;      // the payload block, lane-major
  float* gs = smem + S::G_AT;         // [256][GP] the pixels' feature cotangents
  float* sc_dpow = smem + S::SC_AT;   // [256][SCS] per (pixel, lane of the batch)
  float* sc_dop = sc_dpow + PIX * SCS;
  float* sc_w = sc_dop + PIX * SCS;
  float* partial = smem + S::PART_AT;  // [NQ][NG][LB]

  const Plan plan(plan_data, num_tiles, max_items);
  if ((int)blockIdx.x >= plan.n[1]) return;
  BlockTimer timer(0);
  const Item it(plan, blockIdx.x, tile_start, tile_count, seg_blocks);
  const int p = threadIdx.x;
  const int x0 = (it.tile % grid_x) * TILE, y0 = (it.tile / grid_x) * TILE;
  const float px = (float)(x0 + p % TILE);
  const float py = (float)(y0 + p / TILE);

  const float* o = out + ((size_t)it.tile * PIX + p) * (F + 1);
  const float* go = gout + ((size_t)it.tile * PIX + p) * (F + 1);
  float g[F];
  float s_total = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    g[f] = go[f];
    gs[p * S::GP + f] = g[f];
    s_total += g[f] * o[f];
  }
  const float gt_tfin = go[F] * o[F];

  // the state entering the segment
  float base = 0.0f;
  float u_prev = 0.0f;  // sum of u over the earlier segments and blocks
  if (it.slot0 >= 0) {
    base = entering_log_t(blocklog, it.b0, it.b_first, seg_blocks, p);
    float before[F];
#pragma unroll
    for (int f = 0; f < F; ++f) before[f] = 0.0f;
    for (int j = 0; j < it.seg; ++j) {
      const float* q = part + ((size_t)(it.slot0 + j) * PIX + p) * (F + 1);
#pragma unroll
      for (int f = 0; f < F; ++f) before[f] += q[f];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) u_prev += g[f] * before[f];
  }
  bool done = !(base >= LOG_T_EPS);
  // also the barrier that publishes `gs`
  if (__syncthreads_count(done) == PIX) return;

  float segcum = 0.0f;  // log-sum of the segment's earlier blocks
  const int rl = p % LB, rq = p / LB;  // this thread's lane and pixel group in the reduction

  for (int b = it.b_first; b < it.b_stop; ++b) {
    stage_block<F>(sm, payload + (size_t)b * c_pad * CHUNK);
    __syncthreads();
    const int lo = max(it.start - b * CHUNK, 0);
    const int hi = min(it.end - b * CHUNK, CHUNK);
    float cum = 0.0f;      // in-block prefix of log(1 - alpha)
    float blended = 0.0f;  // the same over the lanes that blended
    float cu = 0.0f;       // in-block prefix of u
    for (int l0 = lo & ~(LB - 1); l0 < hi; l0 += LB) {
      // ---- the walk: this pixel's three scalars for lanes l0 .. l0 + LB ----
      bool hit = false;
#pragma unroll 1
      for (int s0 = 0; s0 < LB; s0 += BATCH) {
        float raw[BATCH], apow[BATCH];
        unsigned pass = 0;
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int l = l0 + s0 + j;
          const Alpha a = eval_alpha(load_gauss<F>(sm, l), px, py);
          raw[j] = a.alpha_raw;
          apow[j] = a.apow;
          if (a.pass && l >= lo && l < hi) pass |= 1u << j;
        }
        if (done) pass = 0;
        const bool any = __any_sync(FULL, pass != 0);
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          float w = 0.0f;
          if (any && (pass >> j & 1)) {
            const int l = l0 + s0 + j;
            const float alpha = fminf(ALPHA_MAX, raw[j]);
            const float lg = log1pf(-alpha);
            cum += lg;
            const float v = base + (segcum + cum);
            if (!(v >= LOG_T_EPS)) {
              done = true;
              pass = 0;
            } else {
              const float tprefix = expf(v - lg);
              w = alpha * tprefix;
              const float* feat = sm + l * RP + HEADER;
              float phi = 0.0f;
#pragma unroll
              for (int f = 0; f < F; ++f) phi += g[f] * feat[f];
              const float u = w * phi;
              cu += u;
              const float suffix = s_total - (cu + u_prev);
              const float om = 1.0f - alpha;
              const float da = tprefix * phi - (suffix + gt_tfin) / om;
              const float da_eff = raw[j] <= ALPHA_MAX ? da : 0.0f;
              sc_dpow[p * SCS + s0 + j] = raw[j] * da_eff;
              sc_dop[p * SCS + s0 + j] = apow[j] * da_eff;
              blended += lg;
              hit = true;
            }
          }
          sc_w[p * SCS + s0 + j] = w;
        }
      }
      if (!__syncthreads_or(hit)) continue;  // no pixel blended a lane of the batch

      // ---- lane-parallel: the rows of lane l0 + rl over pixels rq, rq + NQ, ... ----
      {
        const Gauss q = load_gauss<F>(sm, l0 + rl);
        float acc[NG];
#pragma unroll
        for (int c = 0; c < NG; ++c) acc[c] = 0.0f;
#pragma unroll 4
        for (int i = 0; i < PIX / NQ; ++i) {
          const int pp = rq + NQ * i;
          const float w = sc_w[pp * SCS + rl];
          if (w != 0.0f) {
            const float dpow = sc_dpow[pp * SCS + rl];
            const float dx = q.mx - (float)(x0 + pp % TILE);
            const float dy = q.my - (float)(y0 + pp / TILE);
            const float gmx = q.ca * dx + q.cb * dy;
            const float gmy = q.cc * dy + q.cb * dx;
            acc[0] += -gmx * dpow;
            acc[1] += -gmy * dpow;
            acc[2] += -0.5f * dx * dx * dpow;
            acc[3] += -dx * dy * dpow;
            acc[4] += -0.5f * dy * dy * dpow;
            acc[5] += sc_dop[pp * SCS + rl];
#pragma unroll
            for (int f = 0; f < F; ++f) acc[HEADER + f] += gs[pp * S::GP + f] * w;
            acc[HEADER + F] += fabsf(gmx * dpow);
            acc[HEADER + F + 1] += fabsf(gmy * dpow);
          }
        }
#pragma unroll
        for (int c = 0; c < NG; ++c) partial[rq * S::QS + c * LB + rl] = acc[c];
      }
      __syncthreads();
      for (int i = p; i < NG * LB; i += PIX) {
        const int c = i / LB, lane = l0 + i % LB;
        float s = partial[i];
#pragma unroll 4
        for (int k = 1; k < NQ; ++k) s += partial[k * S::QS + i];
        if (lane >= lo && lane < hi) d_payload[((size_t)b * c_pad + c) * CHUNK + lane] = s;
      }
    }
    segcum += blended;
    u_prev += cu;
    // also the barrier before the next block overwrites `sm`
    if (__syncthreads_count(done) == PIX) break;
  }
}

// ---- F above MAX_FIXED_F: the same kernel, F a runtime count ----
//
// Two things grow with F in tile_blend_bwd_kernel: the registers (g[F]
// and the lane-parallel phase's acc[8 + F]) and the partials [NQ][8 + F]
// [LB] in shared memory. Here the cotangents live in shared memory,
// feature-major (gs [F][256]: the walk reads its own column, conflict
// free), and the reduction takes the 8 + F rows in chunks of WROWS = 8
// over the same three scalar planes: first d mean x/y, d conic a/b/c,
// d opacity and the two AbsGS rows, then the feature rows 8 at a time,
// each chunk through one [NQ][8][LB] partial buffer. Every row is summed
// over the pixels, and then over the pixel groups, in the order of the
// instantiated kernel; phi and the entering prefix of u add g[f] * x in
// f order, as there. Shared memory: the payload block, gs, the scalar
// planes and one chunk's partials, 107,520 bytes at F = 27 (two blocks
// an SM) and 163,840 at F = 64 (one).
constexpr int WROWS = 8;
constexpr int WLB = SG_BWD_LB;
constexpr int WNQ = PIX / WLB;
constexpr int WSCS = WLB + 1;
constexpr int WQS = WROWS * WLB + (WLB < 32 ? (WLB - (WROWS * WLB) % 32 + 32) % 32 : 0);

struct WideSmem {
  int g_at, sc_at, part_at, floats;
  __host__ __device__ explicit WideSmem(int F) {
    g_at = CHUNK * wide_rp(F);
    sc_at = g_at + F * PIX;
    part_at = sc_at + 3 * PIX * WSCS;
    floats = part_at + WNQ * WQS;
  }
};

__global__ void __launch_bounds__(PIX, 2)
    tile_blend_bwd_wide_kernel(const float* __restrict__ payload,
                               const int* __restrict__ tile_start,
                               const int* __restrict__ tile_count,
                               const int* __restrict__ plan_data, int num_tiles, int max_items,
                               int seg_blocks, const float* __restrict__ blocklog,
                               const float* __restrict__ part, const float* __restrict__ out,
                               const float* __restrict__ gout, float* __restrict__ d_payload,
                               int grid_x, int c_pad, int F) {
  const WideSmem S(F);
  const int rp = wide_rp(F);
  extern __shared__ __align__(16) float smem[];
  float* sm = smem;
  float* gs = smem + S.g_at;  // [F][256]
  float* sc_dpow = smem + S.sc_at;
  float* sc_dop = sc_dpow + PIX * WSCS;
  float* sc_w = sc_dop + PIX * WSCS;
  float* partial = smem + S.part_at;  // [WNQ][WROWS][WLB], padded

  const Plan plan(plan_data, num_tiles, max_items);
  if ((int)blockIdx.x >= plan.n[1]) return;
  BlockTimer timer(0);
  const Item it(plan, blockIdx.x, tile_start, tile_count, seg_blocks);
  const int p = threadIdx.x;
  const int x0 = (it.tile % grid_x) * TILE, y0 = (it.tile / grid_x) * TILE;
  const float px = (float)(x0 + p % TILE);
  const float py = (float)(y0 + p / TILE);

  const float* o = out + ((size_t)it.tile * PIX + p) * (F + 1);
  const float* go = gout + ((size_t)it.tile * PIX + p) * (F + 1);
  float s_total = 0.0f;
  for (int f = 0; f < F; ++f) {
    const float g = go[f];
    gs[f * PIX + p] = g;
    s_total += g * o[f];
  }
  const float gt_tfin = go[F] * o[F];

  float base = 0.0f;
  float u_prev = 0.0f;
  if (it.slot0 >= 0) {
    base = entering_log_t(blocklog, it.b0, it.b_first, seg_blocks, p);
    for (int f = 0; f < F; ++f) {
      float before = 0.0f;
      for (int j = 0; j < it.seg; ++j) before += part[((size_t)(it.slot0 + j) * PIX + p) * (F + 1) + f];
      u_prev += gs[f * PIX + p] * before;
    }
  }
  bool done = !(base >= LOG_T_EPS);
  if (__syncthreads_count(done) == PIX) return;

  float segcum = 0.0f;
  const int rl = p % WLB, rq = p / WLB;
  const int nchunks = 1 + (F + WROWS - 1) / WROWS;

  for (int b = it.b_first; b < it.b_stop; ++b) {
    stage_block_wide(sm, payload + (size_t)b * c_pad * CHUNK, F);
    __syncthreads();
    const int lo = max(it.start - b * CHUNK, 0);
    const int hi = min(it.end - b * CHUNK, CHUNK);
    float cum = 0.0f;
    float blended = 0.0f;
    float cu = 0.0f;
    for (int l0 = lo & ~(WLB - 1); l0 < hi; l0 += WLB) {
      bool hit = false;
#pragma unroll 1
      for (int s0 = 0; s0 < WLB; s0 += BATCH) {
        float raw[BATCH], apow[BATCH];
        unsigned pass = 0;
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int l = l0 + s0 + j;
          const Alpha a = eval_alpha(load_gauss_wide(sm, l, rp), px, py);
          raw[j] = a.alpha_raw;
          apow[j] = a.apow;
          if (a.pass && l >= lo && l < hi) pass |= 1u << j;
        }
        if (done) pass = 0;
        const bool any = __any_sync(FULL, pass != 0);
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          float w = 0.0f;
          if (any && (pass >> j & 1)) {
            const int l = l0 + s0 + j;
            const float alpha = fminf(ALPHA_MAX, raw[j]);
            const float lg = log1pf(-alpha);
            cum += lg;
            const float v = base + (segcum + cum);
            if (!(v >= LOG_T_EPS)) {
              done = true;
              pass = 0;
            } else {
              const float tprefix = expf(v - lg);
              w = alpha * tprefix;
              const float* feat = sm + l * rp + HEADER;
              float phi = 0.0f;
              for (int f = 0; f < F; ++f) phi += gs[f * PIX + p] * feat[f];
              const float u = w * phi;
              cu += u;
              const float suffix = s_total - (cu + u_prev);
              const float om = 1.0f - alpha;
              const float da = tprefix * phi - (suffix + gt_tfin) / om;
              const float da_eff = raw[j] <= ALPHA_MAX ? da : 0.0f;
              sc_dpow[p * WSCS + s0 + j] = raw[j] * da_eff;
              sc_dop[p * WSCS + s0 + j] = apow[j] * da_eff;
              blended += lg;
              hit = true;
            }
          }
          sc_w[p * WSCS + s0 + j] = w;
        }
      }
      if (!__syncthreads_or(hit)) continue;

      // ---- lane-parallel, WROWS rows a pass ----
      const Gauss q = load_gauss_wide(sm, l0 + rl, rp);
      for (int ch = 0; ch < nchunks; ++ch) {
        const int f0 = (ch - 1) * WROWS;  // the chunk's first feature (ch >= 1)
        float acc[WROWS];
#pragma unroll
        for (int c = 0; c < WROWS; ++c) acc[c] = 0.0f;
#pragma unroll 4
        for (int i = 0; i < PIX / WNQ; ++i) {
          const int pp = rq + WNQ * i;
          const float w = sc_w[pp * WSCS + rl];
          if (w != 0.0f) {
            if (ch == 0) {
              const float dpow = sc_dpow[pp * WSCS + rl];
              const float dx = q.mx - (float)(x0 + pp % TILE);
              const float dy = q.my - (float)(y0 + pp / TILE);
              const float gmx = q.ca * dx + q.cb * dy;
              const float gmy = q.cc * dy + q.cb * dx;
              acc[0] += -gmx * dpow;
              acc[1] += -gmy * dpow;
              acc[2] += -0.5f * dx * dx * dpow;
              acc[3] += -dx * dy * dpow;
              acc[4] += -0.5f * dy * dy * dpow;
              acc[5] += sc_dop[pp * WSCS + rl];
              acc[6] += fabsf(gmx * dpow);
              acc[7] += fabsf(gmy * dpow);
            } else {
#pragma unroll
              for (int c = 0; c < WROWS; ++c) {
                if (f0 + c < F) acc[c] += gs[(f0 + c) * PIX + pp] * w;
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < WROWS; ++c) partial[rq * WQS + c * WLB + rl] = acc[c];
        __syncthreads();
        for (int i = p; i < WROWS * WLB; i += PIX) {
          const int c = i / WLB, lane = l0 + i % WLB;
          // the chunk's row c: header rows, then the AbsGS rows after the features
          const int row = ch == 0 ? (c < HEADER ? c : HEADER + F + (c - HEADER)) : HEADER + f0 + c;
          if (ch > 0 && f0 + c >= F) continue;
          float s = partial[i];
#pragma unroll 4
          for (int k = 1; k < WNQ; ++k) s += partial[k * WQS + i];
          if (lane >= lo && lane < hi) d_payload[((size_t)b * c_pad + row) * CHUNK + lane] = s;
        }
        // before the next chunk overwrites the partials
        __syncthreads();
      }
    }
    segcum += blended;
    u_prev += cu;
    if (__syncthreads_count(done) == PIX) break;
  }
}

int launch_wide(const float* payload, const int* tile_start, const int* tile_count,
                const int* plan, const float* blocklog, const float* part, const float* out,
                const float* gout, float* d_payload, int num_tiles, int grid_x, int c_pad, int F,
                int seg_blocks, int max_items, cudaStream_t stream) {
  const int bytes = WideSmem(F).floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tile_blend_bwd_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  tile_blend_bwd_wide_kernel<<<max_items, PIX, bytes, stream>>>(
      payload, tile_start, tile_count, plan, num_tiles, max_items, seg_blocks, blocklog, part, out,
      gout, d_payload, grid_x, c_pad, F);
  return (int)cudaGetLastError();
}

template <int F>
int launch(const float* payload, const int* tile_start, const int* tile_count, const int* plan,
           const float* blocklog, const float* part, const float* out, const float* gout,
           float* d_payload, int num_tiles, int grid_x, int c_pad, int seg_blocks,
           int max_items, cudaStream_t stream) {
  auto kernel = tile_blend_bwd_kernel<F, SG_BWD_LB>;
  constexpr int bytes = Smem<F, SG_BWD_LB>::FLOATS * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<max_items, PIX, bytes, stream>>>(payload, tile_start, tile_count, plan, num_tiles,
                                            max_items, seg_blocks, blocklog, part, out, gout,
                                            d_payload, grid_x, c_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// F = 1..MAX_F blend features (1..8 instantiated, wider counts through
// launch_wide); the wrapper rejects other counts. d_payload
// must be zero-filled: only the lanes of live runs are written. `plan`,
// `blocklog` and `part` are the forward's work list and boundary state for
// the same payload and runs (tile_blend_fwd).
extern "C" int tile_blend_bwd(const float* payload, const int* tile_start,
                              const int* tile_count, const int* plan, const float* blocklog,
                              const float* part, const float* out, const float* gout,
                              float* d_payload, int num_tiles, int grid_x, int c_pad,
                              int num_features, int seg_blocks, int max_items, void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_CASE(N)                                                                       \
  case N:                                                                                \
    return launch<N>(payload, tile_start, tile_count, plan, blocklog, part, out, gout,     \
                     d_payload, num_tiles, grid_x, c_pad, seg_blocks, max_items, s);
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
        return launch_wide(payload, tile_start, tile_count, plan, blocklog, part, out, gout,
                           d_payload, num_tiles, grid_x, c_pad, num_features, seg_blocks,
                           max_items, s);
      }
      return (int)cudaErrorInvalidValue;
  }
#undef SG_CASE
}

#ifdef SG_BLOCK_TIMES
namespace {
template <int F>
int fixed_blocks_per_sm() {
  int n = 0;
  auto kernel = tile_blend_bwd_kernel<F, SG_BWD_LB>;
  constexpr int bytes = Smem<F, SG_BWD_LB>::FLOATS * (int)sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, PIX, bytes);
  return n;
}
}  // namespace

// blocks of the launch an SM holds at once at num_features features
extern "C" int sg_blocks_per_sm(int region, int num_features) {
  if (region != 0 || num_features < 1 || num_features > MAX_F) return -1;
  if (num_features > MAX_FIXED_F) {
    int n = 0;
    const int bytes = WideSmem(num_features).floats * (int)sizeof(float);
    cudaFuncSetAttribute(tile_blend_bwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tile_blend_bwd_wide_kernel, PIX, bytes);
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
