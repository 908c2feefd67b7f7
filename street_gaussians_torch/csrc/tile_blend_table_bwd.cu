// Backward of the dense-table tile blend (csrc/tile_blend_table.cu).
//
// Replaces street_gaussians_tpu/ops/tile_raster.py::_bwd_kernel. Each
// work item of the forward's list (a short tile, or one segment of a long
// tile) re-walks its chunks in forward order with the forward's
// product-form stop rule. For every blended (pixel, slot) pair, with
// T_before = T * cp, w = alpha * T_before, phi = g . features,
// u = w * phi:
//   suffix = S_total - (prefix of u through this slot), where
//            S_total = g . out_features (as the JAX kernel, so both
//            round the same way);
//   da     = T_before * phi - (suffix + gT * T_final) / (1 - alpha);
//   da_eff = da where op * exp(power) <= 0.99, else 0 (the clamp);
//   dpow   = op * exp(power) * da_eff.
// Per slot it writes 8 + F gradient rows: d mean x/y, d conic a/b/c,
// d opacity (exp(power) * da_eff), d features (sum of g * w), and the
// two AbsGS rows (per-pixel |d mean x|, |d mean y| summed). The output is
// the whole [num_tiles, c_pad, K] table, as the JAX kernel's out_specs:
// zeros in every row and slot the walk does not reach.
//
// Bound on the H100: the bytes of that table (8.2 GB on the bench frame,
// 2.45 ms at 3.35 TB/s) beside the per-pair exp and arithmetic of the
// re-walk and its gradient terms. The one-block-per-tile kernel paid
// three things beyond that: its launch lasted as long as its longest
// tile's block; for every lane every warp ran a five-level shuffle tree
// over the 8 + F rows (70 shuffles a lane and warp at F = 4) with two
// block barriers per 32 lanes; and the wrapper zero-filled the whole
// table before the kernel wrote the walked chunks a second time.
//
// Design.
// 1. The forward's work list. Segment k of a long tile enters with the
//    forward's boundary state: T_k, its earlier chunks' products folded
//    in chunk order (so every pass and stop decision is the forward's,
//    bit for bit), and the prefix of u equal to g . (the sum of the
//    earlier segments' partial accumulators), as tile_blend_bwd.cu.
//    Every slot belongs to one tile and one segment, so a block writes
//    only its own slots: no atomics.
// 2. No shuffle tree. All 8 + F gradient rows of a pair follow from
//    three scalars (dpow, exp(power) * da_eff, w) and the pixel's dx, dy,
//    g. A pixel's thread stores those three for LB lanes in shared memory
//    ([3][256][LB + 1]); then the block turns lane-parallel: thread
//    (lane, q) forms the rows' per-pixel products for pixels q, q + NQ,
//    ... (NQ = 256 / LB) and adds them in that order, and the NQ partial
//    sums of a (row, lane) are added in q order. The order is fixed, so a
//    repeat is bit-equal; a pair that did not blend (w = 0) is skipped,
//    and a batch of lanes that no pixel blends writes zeros.
// 3. The table is written once. The block writes its walked slots' 8 + F
//    rows from the reduction and zeros, in 16-byte streaming stores, to
//    the rows past 8 + F of its walked chunks, to the chunks of its
//    segment it does not walk (once all 256 pixels have stopped), and,
//    when it holds the tile's end, to the chunks past the tile's count.
//    d_payload needs no zero fill (the wrapper takes torch.empty).
// 4. The chunks are staged with cp.async, the next one while the current
//    one is walked (two buffers; one in the runtime-count kernel).
// 5. F up to 8 is instantiated; F from 9 to MAX_F runs
//    tile_blend_table_bwd_wide_kernel, F a runtime count (see there).
// Compiled with -fmad=false, like the forward, so each product and sum
// rounds as in the plain version.
#include "table_common.cuh"

// lanes per batch of the reduction, and the blocks an SM should hold
#ifndef SG_TABLE_BWD_LB
#define SG_TABLE_BWD_LB 16
#endif
#ifndef SG_TABLE_BWD_MIN_BLOCKS
#define SG_TABLE_BWD_MIN_BLOCKS 2
#endif

namespace {

using namespace sgtable;

constexpr int LB = SG_TABLE_BWD_LB;
constexpr int NQ = PIX / LB;  // pixel groups of the reduction
constexpr int SCS = LB + 1;   // a pixel's stride in a scalar plane
static_assert(PIX % LB == 0 && LB % BATCH == 0 && CHUNK % LB == 0, "lane batch");

// a group's stride in the partials for `rows` rows, padded so that the
// groups of one warp fall on different banks
__host__ __device__ constexpr int group_stride(int rows) {
  return rows * LB + (LB < 32 ? (LB - (rows * LB) % 32 + 32) % 32 : 0);
}

template <int F>
struct Smem {
  static constexpr int NG = HEADER + F + 2;  // gradient rows written
  static constexpr int GP = (F + 3) / 4 * 4;
  static constexpr int QS = group_stride(NG);
  static constexpr int ROWS_AT = 0;  // two staging buffers
  static constexpr int G_AT = ROWS_AT + 2 * Rows<F>::FLOATS;
  static constexpr int SC_AT = G_AT + PIX * GP;
  static constexpr int PART_AT = SC_AT + 3 * PIX * SCS;
  static constexpr int FLOATS = PART_AT + NQ * QS;
  static_assert(NG * LB <= 2 * PIX, "row sums per batch");
};

// The state entering the item: T and the prefix of u, and whether the
// pixel enters at all (had not stopped before).
struct Entry {
  float T, u_prev;
  bool entered;
};

// u_prev = g . (the sum, in segment order, of the earlier segments'
// partial accumulators), g[f] read through gf(f)
template <class G>
__device__ inline Entry entry_state(const TableItem& it, const float* __restrict__ prod,
                                    const float* __restrict__ part, int seg_chunks, int F, int p,
                                    G gf) {
  Entry e{1.0f, 0.0f, true};
  if (it.slot0 < 0) return e;
  e.T = entering_t(prod, it.slot0, it.seg, seg_chunks, p);
  e.entered = e.T >= T_EPS;
  for (int f = 0; f < F; ++f) {
    float before = 0.0f;
    for (int k = 0; k < it.seg; ++k) before += part[((size_t)(it.slot0 + k) * PIX + p) * (F + 1) + f];
    e.u_prev += gf(f) * before;
  }
  return e;
}

// The walk of one batch of LB lanes from l0 for pixel p: the three
// scalars of every lane into the planes (w = 0 where the pixel does not
// blend). Returns whether the pixel blended a lane.
struct Walker {
  float px, py, s_total, gt_tfin, T, u_prev;
  float cp, cu;  // the chunk's product of (1 - alpha) and prefix of u over its blended lanes
  bool done;
  float *sc_dpow, *sc_dop, *sc_w;

  template <class GaussAt, class Phi>
  __device__ bool batch(int l0, GaussAt gauss_at, Phi phi_at) {
    const int p = threadIdx.x;
    bool hit = false;
#pragma unroll 1
    for (int s0 = 0; s0 < LB; s0 += BATCH) {
      float raw[BATCH], apow[BATCH];
      unsigned pass = 0;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const Alpha a = eval_alpha(gauss_at(l0 + s0 + b), px, py);
        raw[b] = a.alpha_raw;
        apow[b] = a.apow;
        if (a.pass) pass |= 1u << b;
      }
      if (done) pass = 0;
      const bool any = __any_sync(FULL, pass != 0);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        float w = 0.0f;
        if (any && (pass >> b & 1)) {
          const float alpha = fminf(ALPHA_MAX, raw[b]);
          const float om = 1.0f - alpha;
          const float cp_incl = cp * om;
          if (T * cp_incl < T_EPS) {
            done = true;
            pass = 0;
          } else {
            const float tprefix = T * cp;
            w = alpha * tprefix;
            const float phi = phi_at(l0 + s0 + b);
            const float u = w * phi;
            cu += u;
            const float suffix = s_total - (cu + u_prev);
            const float da = tprefix * phi - (suffix + gt_tfin) / om;
            const float da_eff = raw[b] <= ALPHA_MAX ? da : 0.0f;
            sc_dpow[p * SCS + s0 + b] = raw[b] * da_eff;
            sc_dop[p * SCS + s0 + b] = apow[b] * da_eff;
            hit = true;
            cp = cp_incl;
          }
        }
        sc_w[p * SCS + s0 + b] = w;
      }
    }
    return hit;
  }
};

// The eight rows of a (lane, pixel group) that do not depend on F, summed
// over the group's pixels rq, rq + NQ, ... in that order: d mean x/y,
// d conic a/b/c, d opacity, then the AbsGS pair. feat(pp, w) adds the
// feature rows of pixel pp (a no-op for the runtime-count kernel's first
// pass over the rows).
template <class Feat>
__device__ inline void reduce_lane(const Gauss& q, int x0, int y0, int rl, int rq,
                                   const float* sc_dpow, const float* sc_dop, const float* sc_w,
                                   float (&acc)[8], Feat feat) {
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < LB; ++i) {
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
      acc[6] += fabsf(gmx * dpow);
      acc[7] += fabsf(gmy * dpow);
      feat(pp, w);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(PIX, SG_TABLE_BWD_MIN_BLOCKS)
    tile_blend_table_bwd_kernel(const float* __restrict__ payload,
                                const int* __restrict__ tile_count,
                                const int* __restrict__ plan_data, int num_tiles, int max_items,
                                int seg_chunks, const float* __restrict__ prod,
                                const float* __restrict__ part, const float* __restrict__ out,
                                const float* __restrict__ gout, float* __restrict__ d_payload,
                                int grid_x, int c_pad, int K) {
  using S = Smem<F>;
  using R = Rows<F>;
  constexpr int NG = S::NG;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem + S::G_AT;  // [256][GP] the pixels' feature cotangents
  float* partial = smem + S::PART_AT;  // [NQ][NG][LB]

  const Plan plan(plan_data, num_tiles, max_items);
  const TableItem it(plan, blockIdx.x, tile_count, K, seg_chunks);
  BlockTimer timer(0);
  const ChunkStager st{smem + S::ROWS_AT, R::FLOATS, 2, R::ROWS, R::RP, K, it.c_first, it.c_stop,
                       payload + (size_t)it.tile * c_pad * K};
  st.start();
  float* d_table = d_payload + (size_t)it.tile * c_pad * K;
  const int p = threadIdx.x;
  const int x0 = (it.tile % grid_x) * TILE, y0 = (it.tile / grid_x) * TILE;

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
  const Entry e = entry_state(it, prod, part, seg_chunks, F, p, [&](int f) { return g[f]; });
  Walker wk{(float)(x0 + p % TILE), (float)(y0 + p / TILE), s_total, go[F] * o[F], e.T, e.u_prev,
            1.0f, 0.0f, !e.entered, smem + S::SC_AT, smem + S::SC_AT + PIX * SCS,
            smem + S::SC_AT + 2 * PIX * SCS};
  const int rl = p % LB, rq = p / LB;  // this thread's lane and pixel group in the reduction

  // chunks [c_first, c_walked) are walked
  int c_walked = it.c_first;
  // also the barrier that publishes `gs`
  if (__syncthreads_count(wk.done) < PIX) {
    for (int c = it.c_first; c < it.c_stop; ++c) {
      const float* sm = st.get(c);
      c_walked = c + 1;
      wk.cp = 1.0f;
      wk.cu = 0.0f;
      float* dst = d_table + (size_t)c * CHUNK;
      for (int l0 = 0; l0 < CHUNK; l0 += LB) {
        const bool hit = wk.batch(
            l0, [&](int l) { return load_gauss<F>(sm, l); },
            [&](int l) {
              const float* feat = sm + l * R::RP + HEADER;
              float phi = 0.0f;
#pragma unroll
              for (int f = 0; f < F; ++f) phi += g[f] * feat[f];
              return phi;
            });
        if (!__syncthreads_or(hit)) {  // no pixel blended a lane of the batch
          for (int i = p; i < NG * LB; i += PIX) dst[(size_t)(i / LB) * K + l0 + i % LB] = 0.0f;
          continue;
        }
        // ---- lane-parallel: the rows of lane l0 + rl over pixels rq, rq + NQ, ... ----
        {
          float acc[8], fa[F];
#pragma unroll
          for (int f = 0; f < F; ++f) fa[f] = 0.0f;
          reduce_lane(load_gauss<F>(sm, l0 + rl), x0, y0, rl, rq, wk.sc_dpow, wk.sc_dop, wk.sc_w, acc,
                      [&](int pp, float w) {
#pragma unroll
                        for (int f = 0; f < F; ++f) fa[f] += gs[pp * S::GP + f] * w;
                      });
          float* q = partial + rq * S::QS + rl;
#pragma unroll
          for (int c2 = 0; c2 < HEADER; ++c2) q[c2 * LB] = acc[c2];
#pragma unroll
          for (int f = 0; f < F; ++f) q[(HEADER + f) * LB] = fa[f];
          q[(HEADER + F) * LB] = acc[6];
          q[(HEADER + F + 1) * LB] = acc[7];
        }
        __syncthreads();
        for (int i = p; i < NG * LB; i += PIX) {
          float s = partial[i];
#pragma unroll 4
          for (int k = 1; k < NQ; ++k) s += partial[k * S::QS + i];
          dst[(size_t)(i / LB) * K + l0 + i % LB] = s;
        }
      }
      wk.T = wk.T * wk.cp;
      wk.u_prev += wk.cu;
      // also the barrier before the chunk's buffer is refilled
      if (__syncthreads_count(wk.done) == PIX) break;
    }
  }
  st.finish();
  zero_chunks(d_table, K, NG, c_pad, it.c_first, c_walked);
  zero_chunks(d_table, K, 0, c_pad, c_walked, it.last ? K / CHUNK : it.c_stop);
}

// ---- F above MAX_FIXED_F: the same kernel, F a runtime count ----
//
// The cotangents live in shared memory, feature-major (gs [F][256]: the
// walk reads its own column, conflict free), and the reduction takes the
// 8 + F rows in chunks of WROWS = 8 over the same three scalar planes:
// first d mean x/y, d conic a/b/c, d opacity and the two AbsGS rows, then
// the feature rows 8 at a time, each chunk through one [NQ][8][LB]
// partial buffer. Every row is summed over the pixels, and then over the
// pixel groups, in the order of the instantiated kernel; phi and the
// entering prefix of u add g[f] * x in f order, as there. One staging
// buffer: shared memory holds the chunk, gs, the scalar planes and one
// chunk's partials, 107,520 bytes at F = 27 (two blocks an SM) and
// 163,840 at F = 64 (one).
constexpr int WROWS = 8;
constexpr int WQS = group_stride(WROWS);

struct WideSmem {
  int g_at, sc_at, part_at, floats;
  __host__ __device__ explicit WideSmem(int F) {
    g_at = CHUNK * wide_rp(F);
    sc_at = g_at + F * PIX;
    part_at = sc_at + 3 * PIX * SCS;
    floats = part_at + NQ * WQS;
  }
};

__global__ void __launch_bounds__(PIX, 2)
    tile_blend_table_bwd_wide_kernel(const float* __restrict__ payload,
                                     const int* __restrict__ tile_count,
                                     const int* __restrict__ plan_data, int num_tiles,
                                     int max_items, int seg_chunks, const float* __restrict__ prod,
                                     const float* __restrict__ part,
                                     const float* __restrict__ out, const float* __restrict__ gout,
                                     float* __restrict__ d_payload, int grid_x, int c_pad, int K,
                                     int F) {
  const WideSmem S(F);
  const int rp = wide_rp(F);
  const int NG = HEADER + F + 2;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem + S.g_at;  // [F][256]
  float* partial = smem + S.part_at;  // [NQ][WROWS][LB], padded

  const Plan plan(plan_data, num_tiles, max_items);
  const TableItem it(plan, blockIdx.x, tile_count, K, seg_chunks);
  BlockTimer timer(0);
  const ChunkStager st{smem, CHUNK * rp, 1, HEADER + F, rp, K, it.c_first, it.c_stop,
                       payload + (size_t)it.tile * c_pad * K};
  st.start();
  float* d_table = d_payload + (size_t)it.tile * c_pad * K;
  const int p = threadIdx.x;
  const int x0 = (it.tile % grid_x) * TILE, y0 = (it.tile / grid_x) * TILE;

  const float* o = out + ((size_t)it.tile * PIX + p) * (F + 1);
  const float* go = gout + ((size_t)it.tile * PIX + p) * (F + 1);
  float s_total = 0.0f;
  for (int f = 0; f < F; ++f) {
    const float gf = go[f];
    gs[f * PIX + p] = gf;
    s_total += gf * o[f];
  }
  const Entry e = entry_state(it, prod, part, seg_chunks, F, p, [&](int f) { return gs[f * PIX + p]; });
  Walker wk{(float)(x0 + p % TILE), (float)(y0 + p / TILE), s_total, go[F] * o[F], e.T, e.u_prev,
            1.0f, 0.0f, !e.entered, smem + S.sc_at, smem + S.sc_at + PIX * SCS,
            smem + S.sc_at + 2 * PIX * SCS};
  const int rl = p % LB, rq = p / LB;
  const int nrow_chunks = 1 + (F + WROWS - 1) / WROWS;

  int c_walked = it.c_first;
  if (__syncthreads_count(wk.done) < PIX) {
    for (int c = it.c_first; c < it.c_stop; ++c) {
      const float* sm = st.get(c);
      c_walked = c + 1;
      wk.cp = 1.0f;
      wk.cu = 0.0f;
      float* dst = d_table + (size_t)c * CHUNK;
      for (int l0 = 0; l0 < CHUNK; l0 += LB) {
        const bool hit = wk.batch(
            l0, [&](int l) { return load_gauss_wide(sm, l, rp); },
            [&](int l) {
              const float* feat = sm + l * rp + HEADER;
              float phi = 0.0f;
              for (int f = 0; f < F; ++f) phi += gs[f * PIX + p] * feat[f];
              return phi;
            });
        if (!__syncthreads_or(hit)) {
          for (int i = p; i < NG * LB; i += PIX) dst[(size_t)(i / LB) * K + l0 + i % LB] = 0.0f;
          continue;
        }
        // ---- lane-parallel, WROWS rows a pass ----
        const Gauss q = load_gauss_wide(sm, l0 + rl, rp);
        for (int ch = 0; ch < nrow_chunks; ++ch) {
          const int f0 = (ch - 1) * WROWS;  // the chunk's first feature (ch >= 1)
          float acc[WROWS];
          if (ch == 0) {
            reduce_lane(q, x0, y0, rl, rq, wk.sc_dpow, wk.sc_dop, wk.sc_w, acc, [](int, float) {});
          } else {
#pragma unroll
            for (int c2 = 0; c2 < WROWS; ++c2) acc[c2] = 0.0f;
#pragma unroll 4
            for (int i = 0; i < LB; ++i) {
              const int pp = rq + NQ * i;
              const float w = wk.sc_w[pp * SCS + rl];
              if (w != 0.0f) {
#pragma unroll
                for (int c2 = 0; c2 < WROWS; ++c2) {
                  if (f0 + c2 < F) acc[c2] += gs[(f0 + c2) * PIX + pp] * w;
                }
              }
            }
          }
#pragma unroll
          for (int c2 = 0; c2 < WROWS; ++c2) partial[rq * WQS + c2 * LB + rl] = acc[c2];
          __syncthreads();
          for (int i = p; i < WROWS * LB; i += PIX) {
            const int c2 = i / LB;
            // the chunk's row c2: header rows, then the AbsGS rows after the features
            const int row = ch == 0 ? (c2 < HEADER ? c2 : HEADER + F + (c2 - HEADER)) : HEADER + f0 + c2;
            if (ch > 0 && f0 + c2 >= F) continue;
            float s = partial[i];
#pragma unroll 4
            for (int k = 1; k < NQ; ++k) s += partial[k * WQS + i];
            dst[(size_t)row * K + l0 + i % LB] = s;
          }
          // before the next chunk of rows overwrites the partials
          __syncthreads();
        }
      }
      wk.T = wk.T * wk.cp;
      wk.u_prev += wk.cu;
      if (__syncthreads_count(wk.done) == PIX) break;
    }
  }
  st.finish();
  zero_chunks(d_table, K, NG, c_pad, it.c_first, c_walked);
  zero_chunks(d_table, K, 0, c_pad, c_walked, it.last ? K / CHUNK : it.c_stop);
}

template <int F>
int launch(const float* payload, const int* tile_count, const int* plan, const float* prod,
           const float* part, const float* out, const float* gout, float* d_payload,
           int num_tiles, int grid_x, int c_pad, int K, int seg_chunks, int n_items,
           int max_items, cudaStream_t stream) {
  auto kernel = tile_blend_table_bwd_kernel<F>;
  constexpr int bytes = Smem<F>::FLOATS * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_items, PIX, bytes, stream>>>(payload, tile_count, plan, num_tiles, max_items,
                                          seg_chunks, prod, part, out, gout, d_payload, grid_x,
                                          c_pad, K);
  return (int)cudaGetLastError();
}

int launch_wide(const float* payload, const int* tile_count, const int* plan, const float* prod,
                const float* part, const float* out, const float* gout, float* d_payload,
                int num_tiles, int grid_x, int c_pad, int K, int F, int seg_chunks, int n_items,
                int max_items, cudaStream_t stream) {
  const int bytes = WideSmem(F).floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tile_blend_table_bwd_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  tile_blend_table_bwd_wide_kernel<<<n_items, PIX, bytes, stream>>>(
      payload, tile_count, plan, num_tiles, max_items, seg_chunks, prod, part, out, gout,
      d_payload, grid_x, c_pad, K, F);
  return (int)cudaGetLastError();
}

}  // namespace

// F = 1..MAX_F blend features (1..8 instantiated, wider counts through
// launch_wide) and K a multiple of 128; the wrapper rejects anything
// else. `plan` (with its n_items), `prod` and `part` are the forward's
// work list and boundary state for the same payload and counts
// (tile_blend_table_fwd). Writes every element of d_payload.
extern "C" int tile_blend_table_bwd(const float* payload, const int* tile_count, const int* plan,
                                    const float* prod, const float* part, const float* out,
                                    const float* gout, float* d_payload, int num_tiles,
                                    int grid_x, int c_pad, int K, int num_features,
                                    int seg_chunks, int n_items, int max_items, void* stream) {
  if (n_items == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_CASE(N)                                                                               \
  case N:                                                                                        \
    return launch<N>(payload, tile_count, plan, prod, part, out, gout, d_payload, num_tiles,     \
                     grid_x, c_pad, K, seg_chunks, n_items, max_items, s);
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
        return launch_wide(payload, tile_count, plan, prod, part, out, gout, d_payload, num_tiles,
                           grid_x, c_pad, K, num_features, seg_chunks, n_items, max_items, s);
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
  auto kernel = tile_blend_table_bwd_kernel<F>;
  constexpr int bytes = Smem<F>::FLOATS * (int)sizeof(float);
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
    cudaFuncSetAttribute(tile_blend_table_bwd_wide_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tile_blend_table_bwd_wide_kernel, PIX, bytes);
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
