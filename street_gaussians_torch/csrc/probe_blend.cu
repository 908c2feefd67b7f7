// Two ablation kernels of the instance-major tile blend
// (csrc/tile_blend.cu), for street_gaussians_torch/script/probe_kernel.py.
//
// Replaces script/probe_kernel.py::_floor_kernel and ::_mxu_kernel (both
// launched by its call_variant). Inputs as csrc/tile_blend.cu: payload
// [NB + 1, c_pad, 128], each tile's ragged run [tile_start, tile_start +
// tile_count); output [num_tiles, 256, F + 1].
//
// probe_floor: what reading the payload and launching the grid cost with
// no blend arithmetic. One block per tile reads every 128-lane block its
// run touches, sums rows 0..7 of the whole block, adds the block's sum
// to all [256, F] outputs and writes T = 1. Bound by bytes.
//
// probe_blend_mma: the blend's own function with the in-block inclusive
// prefix sums taken on the tensor cores, as products with the
// upper-triangular 0/1 matrix L[i, j] = (i <= j): first the [256, 128]
// tile of log1p(-alpha), then the 0/1 flags of the lanes that would stop
// their pixel. One block of 256 threads per tile, one thread per pixel
// for the elementwise passes; warp w owns pixels [32 w, 32 w + 32) in
// every pass, so only warp barriers separate the passes.
//   pass 1  log1p(-alpha) -> S[lane][pixel] (f32), active -> H (f16)
//   mma 1   S <- S x L, TF32 m16n16k8 fragments. The f32 operand is
//           split into three TF32 terms (hi + mid + lo carry all 24
//           bits) and L is exact in TF32, so the prefix keeps f32
//           accuracy. Only the fragment pairs that meet L's nonzero part
//           are multiplied; L's three distinct 8x16 tiles sit in
//           registers.
//   pass 2  flag = active and logT + prefix < log(1e-4) -> H
//   mma 2   H <- H x L, f16 m16n16k16 fragments with f16 accumulators
//           (counts up to 128 are exact)
//   pass 3  per pixel, lanes in order until the flag prefix is nonzero:
//           alpha is recomputed from the staged rows (the two tiles fill
//           shared memory: 132 + 68 KB of the block's 227 KB) and
//           weighs alpha * exp(logT + exclusive prefix).
// A warp whose 32 pixels have all stopped skips its passes and products.
// Bound as csrc/tile_blend.cu (operations); compiled with -fmad=false.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

using namespace nvcuda;

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int HEADER = 6;
constexpr int WARPS = PIX / 32;
constexpr int FLOOR_ROWS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_EPS = (float)-9.210340371976182;  // log(1e-4)
// row strides of the two [lane][pixel] tiles, padded so that a
// fragment's lanes fall in different banks
constexpr int LDS = PIX + 8;   // floats
constexpr int LDH = PIX + 16;  // halves
constexpr int LT_TILE = 8 * 16;
constexpr int LH_TILE = 16 * 16;

__device__ __forceinline__ int run_blocks(int start, int count) {
  return count > 0 ? (start % CHUNK + count + CHUNK - 1) / CHUNK : 0;
}

template <int F>
__global__ void __launch_bounds__(PIX)
    probe_floor_kernel(const float* __restrict__ payload,
                       const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count,
                       float* __restrict__ out, int c_pad) {
  __shared__ float part[WARPS];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int b0 = start / CHUNK;
  const int nb = run_blocks(start, tile_count[t]);
  float acc = 0.0f;
  for (int i = 0; i < nb; ++i) {
    const float* blk = payload + (size_t)(b0 + i) * c_pad * CHUNK;
    float s = 0.0f;
    for (int j = p; j < FLOOR_ROWS * CHUNK; j += PIX) s += blk[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
    if (p % 32 == 0) part[p / 32] = s;
    __syncthreads();
    float total = part[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total += part[w];
    acc += total;
    __syncthreads();
  }
  float* o = out + ((size_t)t * PIX + p) * (F + 1);
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = acc;
  o[F] = 1.0f;
}

template <int F>
size_t mma_shared_bytes() {
  return (size_t)CHUNK * LDS * sizeof(float) + (size_t)CHUNK * LDH * sizeof(__half) +
         3 * LT_TILE * sizeof(float) + 2 * LH_TILE * sizeof(__half) +
         (size_t)(HEADER + F) * CHUNK * sizeof(float);
}

template <int F>
__global__ void __launch_bounds__(PIX)
    probe_blend_mma_kernel(const float* __restrict__ payload,
                           const int* __restrict__ tile_start,
                           const int* __restrict__ tile_count,
                           float* __restrict__ out, int grid_x, int c_pad) {
  constexpr int ROWS = HEADER + F;
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);               // [CHUNK][LDS]
  __half* H = reinterpret_cast<__half*>(S + CHUNK * LDS);  // [CHUNK][LDH]
  float* Lt = reinterpret_cast<float*>(H + CHUNK * LDH);   // [3][8][16]
  __half* Lh = reinterpret_cast<__half*>(Lt + 3 * LT_TILE);  // [2][16][16]
  float* rows = reinterpret_cast<float*>(Lh + 2 * LH_TILE);  // [ROWS][CHUNK]

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const float px = (float)((t % grid_x) * TILE + p % TILE);
  const float py = (float)((t / grid_x) * TILE + p / TILE);
  const int start = tile_start[t];
  const int end = start + tile_count[t];
  const int b0 = start / CHUNK;
  const int nb = run_blocks(start, tile_count[t]);

  // L's distinct fragment tiles. With i = 8 k + ii and j = 16 n + jj,
  // i <= j reads ii - jj <= d, d = 16 n - 8 k: all ones for d >= 8, none
  // for d <= -16, and two partial tiles (d = 0, d = -8). The f16 product
  // has 16x16 tiles: ones above the diagonal, one partial tile on it.
  for (int j = p; j < 3 * LT_TILE; j += PIX) {
    const int which = j / LT_TILE, ii = (j % LT_TILE) / 16, jj = j % 16;
    const bool one = which == 0 || (which == 1 ? ii <= jj : jj >= ii + 8);
    Lt[j] = one ? 1.0f : 0.0f;
  }
  for (int j = p; j < 2 * LH_TILE; j += PIX) {
    const int which = j / LH_TILE, ii = (j % LH_TILE) / 16, jj = j % 16;
    Lh[j] = __float2half((which == 0 || ii <= jj) ? 1.0f : 0.0f);
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> bt[3];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::row_major> bh[2];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    wmma::load_matrix_sync(bt[q], Lt + q * LT_TILE, 16);
#pragma unroll
    for (int e = 0; e < bt[q].num_elements; ++e) bt[q].x[e] = wmma::__float_to_tf32(bt[q].x[e]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) wmma::load_matrix_sync(bh[q], Lh + q * LH_TILE, 16);

  float accum[F];
#pragma unroll
  for (int f = 0; f < F; ++f) accum[f] = 0.0f;
  float logT = 0.0f;
  int done = 0;

  for (int i = 0; i < nb; ++i) {
    const int b = b0 + i;
    const float* blk = payload + (size_t)b * c_pad * CHUNK;
    for (int j = p; j < ROWS * CHUNK; j += PIX) rows[j] = blk[j];
    __syncthreads();
    const int lo = max(start - b * CHUNK, 0);
    const int hi = min(end - b * CHUNK, CHUNK);

    if (!__all_sync(FULL, done)) {
      // pass 1
      for (int l = 0; l < CHUNK; ++l) {
        float lg = 0.0f;
        if (!done && l >= lo && l < hi) {
          const float dx = rows[0 * CHUNK + l] - px;
          const float dy = rows[1 * CHUNK + l] - py;
          const float power =
              -0.5f * (rows[2 * CHUNK + l] * dx * dx + rows[4 * CHUNK + l] * dy * dy) -
              rows[3 * CHUNK + l] * dx * dy;
          const float alpha =
              fminf(ALPHA_MAX, rows[5 * CHUNK + l] * expf(fminf(power, 0.0f)));
          if (power <= 0.0f && alpha >= ALPHA_MIN) lg = log1pf(-alpha);
        }
        S[l * LDS + p] = lg;
        // an active lane has alpha >= 1/255, so its log is below zero
        H[l * LDH + p] = __float2half(lg < 0.0f ? 1.0f : 0.0f);
      }
      __syncwarp();

      // mma 1: inclusive prefix of the logs, in place
      for (int mt = 0; mt < 2; ++mt) {
        const int pix0 = warp * 32 + mt * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[CHUNK / 16];
#pragma unroll
        for (int n = 0; n < CHUNK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
        for (int k = 0; k < CHUNK / 8; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major>
              a_hi, a_mid, a_lo;
          wmma::load_matrix_sync(a_hi, S + (k * 8) * LDS + pix0, LDS);
#pragma unroll
          for (int e = 0; e < a_hi.num_elements; ++e) {
            const float x = a_hi.x[e];
            const float h = wmma::__float_to_tf32(x);
            const float m = wmma::__float_to_tf32(x - h);
            a_hi.x[e] = h;
            a_mid.x[e] = m;
            a_lo.x[e] = wmma::__float_to_tf32(x - h - m);
          }
#pragma unroll
          for (int n = k / 2; n < CHUNK / 16; ++n) {
            const int d = 16 * n - 8 * k;
            const int q = d >= 8 ? 0 : (d == 0 ? 1 : 2);
            wmma::mma_sync(acc[n], a_lo, bt[q], acc[n]);
            wmma::mma_sync(acc[n], a_mid, bt[q], acc[n]);
            wmma::mma_sync(acc[n], a_hi, bt[q], acc[n]);
          }
        }
        __syncwarp();
#pragma unroll
        for (int n = 0; n < CHUNK / 16; ++n) {
          wmma::store_matrix_sync(S + (n * 16) * LDS + pix0, acc[n], LDS, wmma::mem_col_major);
        }
      }
      __syncwarp();

      // pass 2
      for (int l = 0; l < CHUNK; ++l) {
        const bool active = __half2float(H[l * LDH + p]) != 0.0f;
        const bool flag = active && !(logT + S[l * LDS + p] >= LOG_T_EPS);
        H[l * LDH + p] = __float2half(flag ? 1.0f : 0.0f);
      }
      __syncwarp();

      // mma 2: inclusive prefix of the flags, in place
      for (int mt = 0; mt < 2; ++mt) {
        const int pix0 = warp * 32 + mt * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, __half> acc[CHUNK / 16];
#pragma unroll
        for (int n = 0; n < CHUNK / 16; ++n) wmma::fill_fragment(acc[n], __float2half(0.0f));
#pragma unroll
        for (int k = 0; k < CHUNK / 16; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::col_major> a;
          wmma::load_matrix_sync(a, H + (k * 16) * LDH + pix0, LDH);
#pragma unroll
          for (int n = k; n < CHUNK / 16; ++n) {
            wmma::mma_sync(acc[n], a, bh[n > k ? 0 : 1], acc[n]);
          }
        }
        __syncwarp();
#pragma unroll
        for (int n = 0; n < CHUNK / 16; ++n) {
          wmma::store_matrix_sync(H + (n * 16) * LDH + pix0, acc[n], LDH, wmma::mem_col_major);
        }
      }
      __syncwarp();

      // pass 3
      if (!done) {
        float prev = 0.0f;  // exclusive prefix of the logs at lane l
        for (int l = lo; l < hi; ++l) {
          if (__half2float(H[l * LDH + p]) != 0.0f) {
            done = 1;
            break;
          }
          const float cum = S[l * LDS + p];
          const float dx = rows[0 * CHUNK + l] - px;
          const float dy = rows[1 * CHUNK + l] - py;
          const float power =
              -0.5f * (rows[2 * CHUNK + l] * dx * dx + rows[4 * CHUNK + l] * dy * dy) -
              rows[3 * CHUNK + l] * dx * dy;
          const float alpha =
              fminf(ALPHA_MAX, rows[5 * CHUNK + l] * expf(fminf(power, 0.0f)));
          if (power <= 0.0f && alpha >= ALPHA_MIN) {
            const float w = alpha * expf(logT + prev);
#pragma unroll
            for (int f = 0; f < F; ++f) accum[f] += w * rows[(HEADER + f) * CHUNK + l];
          }
          prev = cum;
        }
        logT += prev;
      }
    }
    // also the barrier before the next block overwrites `rows`
    if (__syncthreads_count(done) == PIX) break;
  }

  float* o = out + ((size_t)t * PIX + p) * (F + 1);
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = accum[f];
  o[F] = expf(logT);
}

template <int F>
int launch_floor(const float* payload, const int* tile_start, const int* tile_count,
                 float* out, int num_tiles, int c_pad, cudaStream_t stream) {
  probe_floor_kernel<F><<<num_tiles, PIX, 0, stream>>>(payload, tile_start, tile_count, out, c_pad);
  return (int)cudaGetLastError();
}

template <int F>
int launch_mma(const float* payload, const int* tile_start, const int* tile_count,
               float* out, int num_tiles, int grid_x, int c_pad, cudaStream_t stream) {
  const size_t bytes = mma_shared_bytes<F>();
  cudaError_t err = cudaFuncSetAttribute(probe_blend_mma_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  probe_blend_mma_kernel<F><<<num_tiles, PIX, bytes, stream>>>(
      payload, tile_start, tile_count, out, grid_x, c_pad);
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
// needs at least 8 rows (c_pad is a multiple of 8).
// Both take tile_blend_fwd's arguments; the floor ignores grid_x.
extern "C" int probe_floor(const float* payload, const int* tile_start,
                           const int* tile_count, float* out, int num_tiles,
                           int /*grid_x*/, int c_pad, int num_features,
                           void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_FLOOR(N) launch_floor<N>(payload, tile_start, tile_count, out, num_tiles, c_pad, s)
  SG_SWITCH(SG_FLOOR)
#undef SG_FLOOR
}

extern "C" int probe_blend_mma(const float* payload, const int* tile_start,
                               const int* tile_count, float* out, int num_tiles,
                               int grid_x, int c_pad, int num_features, void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_MMA(N) launch_mma<N>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s)
  SG_SWITCH(SG_MMA)
#undef SG_MMA
}
