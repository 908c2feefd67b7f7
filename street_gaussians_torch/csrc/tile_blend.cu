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
// Bound on the H100: the per-pixel exp/log1p and FMA work (256 pixels
// times the instances each pixel reaches before it stops), far above
// the bytes (each instance's 6 + F words, once per tile). Design: one
// block of 256 threads per tile, one thread per pixel. The block stages
// each 128-lane payload block of its run into shared memory with
// coalesced loads, so every pixel reads the instance from there, and
// the block leaves as soon as all its pixels have stopped
// (__syncthreads_count). The transmittance is carried in log space, as
// in the JAX kernel: logT += log1p(-alpha), stop when
// logT + (in-block prefix) < log(1e-4). A product-form test would flip
// the triggering Gaussian at the edge against the reference. The
// in-block prefix restarts at each 128-lane block, as the JAX kernel's
// does, so the two sum in the same grouping.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int HEADER = 6;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_EPS = (float)-9.210340371976182;  // log(1e-4)

template <int F>
__global__ void __launch_bounds__(PIX)
    tile_blend_fwd_kernel(const float* __restrict__ payload,
                          const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count,
                          float* __restrict__ out, int grid_x, int c_pad) {
  constexpr int ROWS = HEADER + F;
  __shared__ float rows[ROWS][CHUNK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  // integer pixel coordinates, as tile_raster2._pixel_coords
  const float px = (float)((t % grid_x) * TILE + p % TILE);
  const float py = (float)((t / grid_x) * TILE + p / TILE);
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  float accum[F];
#pragma unroll
  for (int f = 0; f < F; ++f) accum[f] = 0.0f;
  float logT = 0.0f;
  int done = 0;

  for (int b = start / CHUNK; b * CHUNK < end; ++b) {
    const float* blk = payload + (size_t)b * c_pad * CHUNK;
    for (int i = p; i < ROWS * CHUNK; i += PIX) {
      rows[i / CHUNK][i % CHUNK] = blk[i];
    }
    __syncthreads();
    if (!done) {
      const int lo = max(start - b * CHUNK, 0);
      const int hi = min(end - b * CHUNK, CHUNK);
      float cum = 0.0f;      // in-block prefix of log(1 - alpha)
      float blended = 0.0f;  // the same over the lanes that blended
      for (int l = lo; l < hi; ++l) {
        const float dx = rows[0][l] - px;
        const float dy = rows[1][l] - py;
        const float power =
            -0.5f * (rows[2][l] * dx * dx + rows[4][l] * dy * dy) -
            rows[3][l] * dx * dy;
        const float alpha =
            fminf(ALPHA_MAX, rows[5][l] * expf(fminf(power, 0.0f)));
        if (!(power <= 0.0f) || !(alpha >= ALPHA_MIN)) continue;
        const float lg = log1pf(-alpha);
        cum += lg;
        if (!(logT + cum >= LOG_T_EPS)) {
          done = 1;
          break;
        }
        const float w = alpha * expf(logT + cum - lg);
#pragma unroll
        for (int f = 0; f < F; ++f) accum[f] += w * rows[HEADER + f][l];
        blended += lg;
      }
      logT += blended;
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
int launch(const float* payload, const int* tile_start, const int* tile_count,
           float* out, int num_tiles, int grid_x, int c_pad,
           cudaStream_t stream) {
  tile_blend_fwd_kernel<F><<<num_tiles, PIX, 0, stream>>>(
      payload, tile_start, tile_count, out, grid_x, c_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// F = 1..8 blend features; the wrapper rejects other counts.
extern "C" int tile_blend_fwd(const float* payload, const int* tile_start,
                              const int* tile_count, float* out,
                              int num_tiles, int grid_x, int c_pad,
                              int num_features, void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_features) {
    case 1: return launch<1>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 2: return launch<2>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 3: return launch<3>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 4: return launch<4>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 5: return launch<5>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 6: return launch<6>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 7: return launch<7>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    case 8: return launch<8>(payload, tile_start, tile_count, out, num_tiles, grid_x, c_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
