// Backward of the dense-table tile blend (csrc/tile_blend_table.cu).
//
// Replaces street_gaussians_tpu/ops/tile_raster.py::_bwd_kernel. Each
// 16x16 tile re-walks the chunks of its table in forward order with the
// forward's product-form stop rule. For every blended (pixel, slot)
// pair, with T_before = T * cp, w = alpha * T_before,
// phi = g . features, u = w * phi:
//   suffix = S_total - (prefix of u through this slot), where
//            S_total = g . out_features (as the JAX kernel, so both
//            round the same way);
//   da     = T_before * phi - (suffix + gT * T_final) / (1 - alpha);
//   da_eff = da where op * exp(power) <= 0.99, else 0 (the clamp);
//   dpow   = op * exp(power) * da_eff.
// Per slot it writes 8 + F gradient rows: d mean x/y, d conic a/b/c,
// d opacity (exp(power) * da_eff), d features (sum of g * w), and the
// two AbsGS rows (per-pixel |d mean x|, |d mean y| summed).
//
// Bound on the H100: the per-pair exp and arithmetic of the re-walk plus
// the gradient terms, far above the bytes. Design: one block of 256
// threads per tile, one thread per pixel, each 128-lane chunk staged in
// shared memory. A slot's 8 + F contributions are summed over the
// tile's 256 pixels in a fixed order (a warp shuffle tree, then the 8
// warp partials in shared memory, 32 lanes at a time), so the result is
// bit-reproducible. A tile writes only its own table: no atomics. Every
// lane of a chunk the walk reads is written (zeros where nothing
// blended); the chunks after every pixel has stopped keep the zeros the
// wrapper filled d_payload with. A warp skips the shuffles of a lane
// where none of its pixels blended. Compiled with -fmad=false, like the
// forward.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int HEADER = 6;
constexpr int WARPS = PIX / 32;
constexpr int SUB = 32;  // lanes per cross-warp reduction
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

template <int F>
__global__ void __launch_bounds__(PIX)
    tile_blend_table_bwd_kernel(const float* __restrict__ payload,
                                const int* __restrict__ tile_count,
                                const float* __restrict__ out,
                                const float* __restrict__ gout,
                                float* __restrict__ d_payload, int grid_x,
                                int c_pad, int K) {
  constexpr int ROWS = HEADER + F;    // payload rows read
  constexpr int NG = HEADER + F + 2;  // gradient rows written
  __shared__ float rows[ROWS][CHUNK];
  __shared__ float part[WARPS][NG][SUB];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int wl = p % 32;
  const float px = (float)((t % grid_x) * TILE + p % TILE);
  const float py = (float)((t / grid_x) * TILE + p / TILE);
  const float* table = payload + (size_t)t * c_pad * K;
  float* d_table = d_payload + (size_t)t * c_pad * K;
  const int nchunks = min((tile_count[t] + CHUNK - 1) / CHUNK, K / CHUNK);

  const float* o = out + ((size_t)t * PIX + p) * (F + 1);
  const float* go = gout + ((size_t)t * PIX + p) * (F + 1);
  float g[F];
  float s_total = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    g[f] = go[f];
    s_total += g[f] * o[f];
  }
  const float gt_tfin = go[F] * o[F];

  float T = 1.0f;
  float u_prev = 0.0f;  // sum of u over the earlier chunks
  int done = 0;

  for (int i = 0; i < nchunks; ++i) {
    for (int j = p; j < ROWS * CHUNK; j += PIX) {
      rows[j / CHUNK][j % CHUNK] = table[(size_t)(j / CHUNK) * K + i * CHUNK + j % CHUNK];
    }
    __syncthreads();
    float cp = 1.0f;  // product of (1 - alpha) over the chunk's blended lanes
    float cu = 0.0f;  // in-chunk prefix of u
    for (int l0 = 0; l0 < CHUNK; l0 += SUB) {
      for (int k = 0; k < SUB; ++k) {
        const int l = l0 + k;
        float v[NG];
#pragma unroll
        for (int c = 0; c < NG; ++c) v[c] = 0.0f;
        bool hit = false;
        if (!done) {
          const float dx = rows[0][l] - px;
          const float dy = rows[1][l] - py;
          const float ca = rows[2][l], cb = rows[3][l], cc = rows[4][l];
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
          const float apow = expf(fminf(power, 0.0f));
          const float alpha_raw = rows[5][l] * apow;
          const float alpha = fminf(ALPHA_MAX, alpha_raw);
          if (power <= 0.0f && alpha >= ALPHA_MIN) {
            const float om = 1.0f - alpha;
            const float cp_incl = cp * om;
            if (T * cp_incl < T_EPS) {
              done = 1;
            } else {
              hit = true;
              const float tprefix = T * cp;
              const float w = alpha * tprefix;
              float phi = 0.0f;
#pragma unroll
              for (int f = 0; f < F; ++f) phi += g[f] * rows[HEADER + f][l];
              const float u = w * phi;
              cu += u;
              const float suffix = s_total - (cu + u_prev);
              const float da = tprefix * phi - (suffix + gt_tfin) / om;
              const float da_eff = alpha_raw <= ALPHA_MAX ? da : 0.0f;
              const float dpow = alpha_raw * da_eff;
              const float gmx = ca * dx + cb * dy;
              const float gmy = cc * dy + cb * dx;
              v[0] = -gmx * dpow;
              v[1] = -gmy * dpow;
              v[2] = -0.5f * dx * dx * dpow;
              v[3] = -dx * dy * dpow;
              v[4] = -0.5f * dy * dy * dpow;
              v[5] = apow * da_eff;
#pragma unroll
              for (int f = 0; f < F; ++f) v[HEADER + f] = g[f] * w;
              v[HEADER + F] = fabsf(gmx * dpow);
              v[HEADER + F + 1] = fabsf(gmy * dpow);
              cp = cp_incl;
            }
          }
        }
        if (__any_sync(FULL, hit)) {
#pragma unroll
          for (int c = 0; c < NG; ++c) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              v[c] += __shfl_down_sync(FULL, v[c], off);
            }
          }
        }
        if (wl == 0) {
#pragma unroll
          for (int c = 0; c < NG; ++c) part[warp][c][k] = v[c];
        }
      }
      __syncthreads();
      for (int j = p; j < NG * SUB; j += PIX) {
        const int c = j / SUB;
        const int k = j % SUB;
        float s = part[0][c][k];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += part[w][c][k];
        d_table[(size_t)c * K + i * CHUNK + l0 + k] = s;
      }
      __syncthreads();
    }
    T = T * cp;
    u_prev += cu;
    if (__syncthreads_count(done) == PIX) break;
  }
}

template <int F>
int launch(const float* payload, const int* tile_count, const float* out,
           const float* gout, float* d_payload, int num_tiles, int grid_x,
           int c_pad, int K, cudaStream_t stream) {
  tile_blend_table_bwd_kernel<F><<<num_tiles, PIX, 0, stream>>>(
      payload, tile_count, out, gout, d_payload, grid_x, c_pad, K);
  return (int)cudaGetLastError();
}

}  // namespace

// F = 1..8 blend features and K a multiple of 128; the wrapper rejects
// anything else. d_payload must be zero-filled: only the chunks the walk
// reads are written.
extern "C" int tile_blend_table_bwd(const float* payload, const int* tile_count,
                                    const float* out, const float* gout,
                                    float* d_payload, int num_tiles, int grid_x,
                                    int c_pad, int K, int num_features,
                                    void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_CASE(N)                                                       \
  case N:                                                                \
    return launch<N>(payload, tile_count, out, gout, d_payload, num_tiles, \
                     grid_x, c_pad, K, s);
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
      return (int)cudaErrorInvalidValue;
  }
#undef SG_CASE
}
