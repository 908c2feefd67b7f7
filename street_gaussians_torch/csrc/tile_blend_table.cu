// Forward tile blend over a dense per-tile table.
//
// Replaces street_gaussians_tpu/ops/tile_raster.py::_fwd_kernel. Tile t
// owns payload[t], a [c_pad, K] table of its depth-ordered Gaussians:
// rows mean x, mean y, conic a/b/c, opacity, then F features; opacity 0
// marks an empty slot. The tile's count only sets how many 128-lane
// chunks are read, cdiv(count, 128): no lane is masked by the count.
// Per pixel, front to back:
//   alpha = min(0.99, op * exp(min(power, 0))), skipped when power > 0
//   or alpha < 1/255; with T the transmittance before the chunk and cp
//   the running product of (1 - alpha) inside it, the pixel stops at the
//   first Gaussian with T * cp * (1 - alpha) < 1e-4, which is not
//   blended; a blended Gaussian weighs alpha * T * cp; after the chunk
//   T *= cp.
// Output [num_tiles, 256, F + 1]: the F blended features, then final T.
//
// Bound on the H100: the per-pixel exp and FMA work (256 pixels times
// the slots each pixel reaches before it stops), far above the bytes
// (the live chunks' 6 + F rows, once). Design: one block of 256 threads
// per tile, one thread per pixel; each 128-lane chunk is staged in
// shared memory with coalesced loads, and the block leaves as soon as
// all its pixels have stopped (__syncthreads_count), which is the JAX
// kernel's chunk skip. The transmittance is a direct product, as in the
// JAX kernel, whose lane-parallel prefix products become this thread's
// sequential cp. Compiled with -fmad=false so that every product and sum
// rounds on its own, as in the plain PyTorch version.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int HEADER = 6;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

template <int F>
__global__ void __launch_bounds__(PIX)
    tile_blend_table_fwd_kernel(const float* __restrict__ payload,
                                const int* __restrict__ tile_count,
                                float* __restrict__ out, int grid_x, int c_pad,
                                int K) {
  constexpr int ROWS = HEADER + F;
  __shared__ float rows[ROWS][CHUNK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_x) * TILE + p % TILE);
  const float py = (float)((t / grid_x) * TILE + p / TILE);
  const float* table = payload + (size_t)t * c_pad * K;
  const int nchunks = min((tile_count[t] + CHUNK - 1) / CHUNK, K / CHUNK);

  float accum[F];
#pragma unroll
  for (int f = 0; f < F; ++f) accum[f] = 0.0f;
  float T = 1.0f;
  int done = 0;

  for (int i = 0; i < nchunks; ++i) {
    for (int j = p; j < ROWS * CHUNK; j += PIX) {
      rows[j / CHUNK][j % CHUNK] = table[(size_t)(j / CHUNK) * K + i * CHUNK + j % CHUNK];
    }
    __syncthreads();
    if (!done) {
      float cp = 1.0f;  // product of (1 - alpha) over the chunk's blended lanes
      for (int l = 0; l < CHUNK; ++l) {
        const float dx = rows[0][l] - px;
        const float dy = rows[1][l] - py;
        const float power =
            -0.5f * (rows[2][l] * dx * dx + rows[4][l] * dy * dy) -
            rows[3][l] * dx * dy;
        const float alpha =
            fminf(ALPHA_MAX, rows[5][l] * expf(fminf(power, 0.0f)));
        if (!(power <= 0.0f) || !(alpha >= ALPHA_MIN)) continue;
        const float cp_incl = cp * (1.0f - alpha);
        if (T * cp_incl < T_EPS) {
          done = 1;
          break;
        }
        const float w = alpha * T * cp;
#pragma unroll
        for (int f = 0; f < F; ++f) accum[f] += w * rows[HEADER + f][l];
        cp = cp_incl;
      }
      T = T * cp;
    }
    // also the barrier before the next chunk overwrites `rows`
    if (__syncthreads_count(done) == PIX) break;
  }

  float* o = out + ((size_t)t * PIX + p) * (F + 1);
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = accum[f];
  o[F] = T;
}

// F above MAX_FIXED_F: the same walk with F a runtime count; the
// chunk's rows and the accumulators ([F][256], each pixel its own column)
// in dynamic shared memory. Each accumulator takes the same sums in the
// same order as the instantiated kernel's registers.
constexpr int MAX_FIXED_F = 8;
constexpr int MAX_F = 64;

size_t wide_smem(int F) { return (size_t)((HEADER + F) * CHUNK + F * PIX) * sizeof(float); }

__global__ void __launch_bounds__(PIX)
    tile_blend_table_fwd_wide_kernel(const float* __restrict__ payload,
                                     const int* __restrict__ tile_count,
                                     float* __restrict__ out, int grid_x, int c_pad, int K,
                                     int F) {
  const int ROWS = HEADER + F;
  extern __shared__ float wsm[];
  float* rows = wsm;                   // [ROWS][CHUNK]
  float* accum = wsm + ROWS * CHUNK;   // [F][PIX]

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % grid_x) * TILE + p % TILE);
  const float py = (float)((t / grid_x) * TILE + p / TILE);
  const float* table = payload + (size_t)t * c_pad * K;
  const int nchunks = min((tile_count[t] + CHUNK - 1) / CHUNK, K / CHUNK);

  for (int f = 0; f < F; ++f) accum[f * PIX + p] = 0.0f;
  float T = 1.0f;
  int done = 0;

  for (int i = 0; i < nchunks; ++i) {
    for (int j = p; j < ROWS * CHUNK; j += PIX) {
      rows[j] = table[(size_t)(j / CHUNK) * K + i * CHUNK + j % CHUNK];
    }
    __syncthreads();
    if (!done) {
      float cp = 1.0f;
      for (int l = 0; l < CHUNK; ++l) {
        const float dx = rows[0 * CHUNK + l] - px;
        const float dy = rows[1 * CHUNK + l] - py;
        const float power =
            -0.5f * (rows[2 * CHUNK + l] * dx * dx + rows[4 * CHUNK + l] * dy * dy) -
            rows[3 * CHUNK + l] * dx * dy;
        const float alpha =
            fminf(ALPHA_MAX, rows[5 * CHUNK + l] * expf(fminf(power, 0.0f)));
        if (!(power <= 0.0f) || !(alpha >= ALPHA_MIN)) continue;
        const float cp_incl = cp * (1.0f - alpha);
        if (T * cp_incl < T_EPS) {
          done = 1;
          break;
        }
        const float w = alpha * T * cp;
        for (int f = 0; f < F; ++f) accum[f * PIX + p] += w * rows[(HEADER + f) * CHUNK + l];
        cp = cp_incl;
      }
      T = T * cp;
    }
    if (__syncthreads_count(done) == PIX) break;
  }

  float* o = out + ((size_t)t * PIX + p) * (F + 1);
  for (int f = 0; f < F; ++f) o[f] = accum[f * PIX + p];
  o[F] = T;
}

int launch_wide(const float* payload, const int* tile_count, float* out, int num_tiles,
                int grid_x, int c_pad, int K, int F, cudaStream_t stream) {
  const size_t bytes = wide_smem(F);
  cudaError_t err = cudaFuncSetAttribute(tile_blend_table_fwd_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  tile_blend_table_fwd_wide_kernel<<<num_tiles, PIX, bytes, stream>>>(payload, tile_count, out,
                                                                     grid_x, c_pad, K, F);
  return (int)cudaGetLastError();
}

template <int F>
int launch(const float* payload, const int* tile_count, float* out,
           int num_tiles, int grid_x, int c_pad, int K, cudaStream_t stream) {
  tile_blend_table_fwd_kernel<F><<<num_tiles, PIX, 0, stream>>>(
      payload, tile_count, out, grid_x, c_pad, K);
  return (int)cudaGetLastError();
}

}  // namespace

// F = 1..MAX_F blend features (1..8 instantiated, wider counts through
// launch_wide) and K a multiple of 128; the wrapper rejects anything else.
extern "C" int tile_blend_table_fwd(const float* payload, const int* tile_count,
                                    float* out, int num_tiles, int grid_x,
                                    int c_pad, int K, int num_features,
                                    void* stream) {
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SG_CASE(N) \
  case N:          \
    return launch<N>(payload, tile_count, out, num_tiles, grid_x, c_pad, K, s);
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
        return launch_wide(payload, tile_count, out, num_tiles, grid_x, c_pad, K, num_features, s);
      }
      return (int)cudaErrorInvalidValue;
  }
#undef SG_CASE
}
