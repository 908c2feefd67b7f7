// The SH colour of every Gaussian, forward and backward, one launch each.
//
// Replaces no TPU kernel: the JAX package computes the colour in plain
// jnp (street_gaussians_tpu/models/renderer.py compose_frame: the
// Fourier DC, the band mask, the [C, K, 3] table; ops/preprocess.py: the
// view directions, the basis, the product, + 0.5, the clamp), which XLA
// fuses. Run eagerly, its PyTorch port (ops/sh_color.sh_color_plain) is
// some 50 kernels forward and their VJPs backward, each a pass over a
// [C, K] or [C, K, 3] array; ~40 ms of the garden's step.
//
// Bound on the H100: memory. A row reads xyz (12 bytes), feat_dc (12 F),
// feat_rest (12 (K - 1)), t_row (4) and is_actor (1) where given, and
// writes rgb (12); the backward reads the same and d_rgb (12) and writes
// d_xyz (12), d_feat_dc (12 F) and d_feat_rest (12 (K - 1)). At the
// garden's K = 16, F = 1, 6,291,456 rows: 216 and 420 bytes a row,
// 1.36 and 2.64 GB, 0.41 and 0.79 ms at 3.35 TB/s. Some 150 f32
// operations a row forward and 400 backward are far below the 67
// TFLOP/s line.
// Design:
//  - one thread a row, SH_ROWS consecutive rows a block, so that a
//    block's feat_rest rows are one run of floats (as are its feat_dc
//    rows). A row's 12 (K - 1) bytes (180 at K = 16) are not 16-byte
//    aligned row by row, but a block's run is (it starts at a multiple
//    of SH_ROWS rows) wherever the array is: the block stages its run
//    into shared memory with 16-byte loads, coalesced, and a thread
//    reads its row there at an odd stride of 3 (K - 1) floats, free of
//    bank conflicts. The backward writes d_feat_rest and d_feat_dc into
//    the same slots and stores the runs back the same way. xyz, d_rgb,
//    rgb and d_xyz (12 bytes a row) are read and written in place: a
//    warp's 32 rows are 384 contiguous bytes, fully used in L1/L2;
//  - K is a template parameter (1, 4, 9, 16): the basis, its products
//    and its derivatives are unrolled in registers. F and the active
//    degrees are run-time values; a band above the row's degree is
//    skipped forward and written 0 backward, so no masked copy of
//    feat_rest is ever made;
//  - the backward recomputes the row (direction, basis, colour) from the
//    inputs: nothing [C, K] is kept between the two launches.
// The arithmetic is the plain version's in float32 (utils/sh.py's
// constants and band order, the 1e-12 clamp of the direction's norm,
// clamp's gradient passed at a colour of exactly 0); the sums of a row
// run in another order, the higher bands' with fused multiply-adds. Out
// of place: the wrapper allocates the outputs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SH_ROWS = 128;

// utils/sh.py, each rounded to float as PyTorch rounds a Python float
// against a float32 tensor
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f, C2_2 = 0.31539156525252005f,
                C2_3 = -1.0925484305920792f, C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f, C3_2 = -0.4570457994644658f,
                C3_3 = 0.3731763325901154f, C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;
constexpr float PI_F = 3.14159265358979323846f;

struct ShArgs {
  const float* xyz;     // [C, 3]
  const float* center;  // [3]
  const float* dc;      // [C, F, 3]
  const float* rest;    // [C, K - 1, 3]
  const float* t_row;   // [C]; null: 0
  const unsigned char* is_actor;  // bool [C]; null: no actor rows
  const float* d_rgb;   // [C, 3], the backward's
  float* rgb;           // [C, 3], the forward's
  float* d_xyz;         // the backward's: [C, 3], [C, F, 3], [C, K - 1, 3]
  float* d_dc;
  float* d_rest;
  long long rows;
  int F, deg_bkgd, deg_obj;
};

// the band of coefficient k >= 1
__host__ __device__ constexpr int band(int k) { return k < 4 ? 1 : (k < 9 ? 2 : 3); }

// floats [0, n) of src into s (16-byte loads where src is 16-byte
// aligned; s always is)
__device__ __forceinline__ void stage_in(float* s, const float* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += SH_ROWS)
      reinterpret_cast<float4*>(s)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += SH_ROWS) s[i] = __ldg(src + i);
}

__device__ __forceinline__ void stage_out(float* dst, const float* s, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += SH_ROWS)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(s)[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += SH_ROWS) dst[i] = s[i];
}

// utils/sh.sh_basis, in its order of operations
template <int K>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float (&b)[K]) {
  b[0] = C0;
  if constexpr (K > 1) {
    b[1] = -C1 * y;
    b[2] = C1 * z;
    b[3] = -C1 * x;
  }
  if constexpr (K > 4) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2_0 * xy;
    b[5] = C2_1 * yz;
    b[6] = C2_2 * (2.0f * zz - xx - yy);
    b[7] = C2_3 * xz;
    b[8] = C2_4 * (xx - yy);
    if constexpr (K > 9) {
      b[9] = C3_0 * y * (3.0f * xx - yy);
      b[10] = C3_1 * xy * z;
      b[11] = C3_2 * y * (4.0f * zz - xx - yy);
      b[12] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = C3_4 * x * (4.0f * zz - xx - yy);
      b[14] = C3_5 * z * (xx - yy);
      b[15] = C3_6 * x * (xx - 3.0f * yy);
    }
  }
}

// the direction's gradient from the basis values' (gb[0] is not read:
// b[0] is a constant)
template <int K>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, const float (&gb)[K], float& dx, float& dy,
                                             float& dz) {
  dx = dy = dz = 0.0f;
  if constexpr (K > 1) {
    dy = -C1 * gb[1];
    dz = C1 * gb[2];
    dx = -C1 * gb[3];
  }
  if constexpr (K > 4) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    dx += C2_0 * y * gb[4] - 2.0f * C2_2 * x * gb[6] + C2_3 * z * gb[7] + 2.0f * C2_4 * x * gb[8];
    dy += C2_0 * x * gb[4] + C2_1 * z * gb[5] - 2.0f * C2_2 * y * gb[6] - 2.0f * C2_4 * y * gb[8];
    dz += C2_1 * y * gb[5] + 4.0f * C2_2 * z * gb[6] + C2_3 * x * gb[7];
    if constexpr (K > 9) {
      dx += 6.0f * C3_0 * xy * gb[9] + C3_1 * yz * gb[10] - 2.0f * C3_2 * xy * gb[11] -
            6.0f * C3_3 * xz * gb[12] + C3_4 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
            2.0f * C3_5 * xz * gb[14] + 3.0f * C3_6 * (xx - yy) * gb[15];
      dy += 3.0f * C3_0 * (xx - yy) * gb[9] + C3_1 * xz * gb[10] + C3_2 * (4.0f * zz - xx - 3.0f * yy) * gb[11] -
            6.0f * C3_3 * yz * gb[12] - 2.0f * C3_4 * xy * gb[13] - 2.0f * C3_5 * yz * gb[14] -
            6.0f * C3_6 * xy * gb[15];
      dz += C3_1 * xy * gb[10] + 8.0f * C3_2 * yz * gb[11] + C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] +
            8.0f * C3_4 * xz * gb[13] + C3_5 * (xx - yy) * gb[14];
    }
  }
}

// utils/sh.idft_basis at coefficient f: cos(pi f t) for even f, sin(pi (f + 1) t) for odd
__device__ __forceinline__ float fourier(int f, float t) {
  return (f % 2 == 0) ? cosf(PI_F * (float)f * t) : sinf(PI_F * (float)(f + 1) * t);
}

// A row's direction from the camera: the raw difference r, its norm n
// and the unit direction u = r / max(n, 1e-12)
struct Dir {
  float rx, ry, rz, n, nc, x, y, z;
};

__device__ __forceinline__ Dir direction(const ShArgs& a, long long r) {
  Dir d;
  d.rx = __ldg(a.xyz + 3 * r) - __ldg(a.center);
  d.ry = __ldg(a.xyz + 3 * r + 1) - __ldg(a.center + 1);
  d.rz = __ldg(a.xyz + 3 * r + 2) - __ldg(a.center + 2);
  d.n = sqrtf(d.rx * d.rx + d.ry * d.ry + d.rz * d.rz);
  d.nc = d.n < 1e-12f ? 1e-12f : d.n;
  d.x = d.rx / d.nc;
  d.y = d.ry / d.nc;
  d.z = d.rz / d.nc;
  return d;
}

template <int K, bool BACKWARD>
__global__ void __launch_bounds__(SH_ROWS) sh_color_kernel(const ShArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int W = 3 * (K - 1);  // floats of feat_rest a row
  const int WD = 3 * a.F;         // floats of feat_dc a row
  float* s_rest = reinterpret_cast<float*>(smem4);
  float* s_dc = s_rest + SH_ROWS * W;
  const long long r0 = (long long)blockIdx.x * SH_ROWS;
  const int rows = (int)min((long long)SH_ROWS, a.rows - r0);
  if constexpr (K > 1) stage_in(s_rest, a.rest + r0 * W, rows * W);
  stage_in(s_dc, a.dc + r0 * WD, rows * WD);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const long long r = r0 + t;
    const Dir d = direction(a, r);
    float b[K];
    sh_basis<K>(d.x, d.y, d.z, b);
    const bool actor = a.is_actor != nullptr && a.is_actor[r];
    const int deg = actor ? a.deg_obj : a.deg_bkgd;
    const float tr = actor && a.t_row != nullptr ? __ldg(a.t_row + r) : 0.0f;
    float* rest = s_rest + t * W;
    float* dc = s_dc + t * WD;

    float v[3];  // the colour before + 0.5 and the clamp
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = dc[c];
    if (actor) {
      for (int f = 1; f < a.F; ++f) {
        const float w = fourier(f, tr);
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = fmaf(w, dc[3 * f + c], v[c]);
      }
    }
    // the DC's product and the + 0.5 rounded on their own, as the plain
    // version's are (never contracted into one fused multiply-add): a
    // colour the plain version sees at exactly 0 is 0 here too
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(v[c], b[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (band(k) <= deg) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = fmaf(b[k], rest[3 * (k - 1) + c], v[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fadd_rn(v[c], 0.5f);

    if constexpr (!BACKWARD) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a.rgb[3 * r + c] = v[c] < 0.0f ? 0.0f : v[c];
    } else {
      float g[3];  // the gradient through the clamp, passed at 0
#pragma unroll
      for (int c = 0; c < 3; ++c) g[c] = v[c] >= 0.0f ? __ldg(a.d_rgb + 3 * r + c) : 0.0f;
      float gb[K];
      gb[0] = 0.0f;
#pragma unroll
      for (int k = 1; k < K; ++k) {
        float* ck = rest + 3 * (k - 1);
        if (band(k) <= deg) {
          gb[k] = ck[0] * g[0] + ck[1] * g[1] + ck[2] * g[2];
#pragma unroll
          for (int c = 0; c < 3; ++c) ck[c] = b[k] * g[c];
        } else {
          gb[k] = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) ck[c] = 0.0f;
        }
      }
      // the DC: d_dc = b[0] g, spread over the Fourier coefficients
      float ddc[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ddc[c] = b[0] * g[c];
        dc[c] = ddc[c];
      }
      for (int f = 1; f < a.F; ++f) {
        const float w = actor ? fourier(f, tr) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) dc[3 * f + c] = w * ddc[c];
      }
      float dx, dy, dz;
      sh_basis_vjp<K>(d.x, d.y, d.z, gb, dx, dy, dz);
      // through u = r / max(n, 1e-12): (du - u (du . u)) / n past the
      // clamp, du / 1e-12 below it
      float px = dx / d.nc, py = dy / d.nc, pz = dz / d.nc;
      if (d.n >= 1e-12f) {
        const float s = (dx * d.x + dy * d.y + dz * d.z) / d.nc;
        px -= d.x * s;
        py -= d.y * s;
        pz -= d.z * s;
      }
      a.d_xyz[3 * r] = px;
      a.d_xyz[3 * r + 1] = py;
      a.d_xyz[3 * r + 2] = pz;
    }
  }
  if constexpr (BACKWARD) {
    __syncthreads();
    if constexpr (K > 1) stage_out(a.d_rest + r0 * W, s_rest, rows * W);
    stage_out(a.d_dc + r0 * WD, s_dc, rows * WD);
  }
}

template <int K, bool BACKWARD>
int launch(const ShArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SH_ROWS * (3 * (K - 1) + 3 * a.F);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sh_color_kernel<K, BACKWARD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((a.rows + SH_ROWS - 1) / SH_ROWS);
  sh_color_kernel<K, BACKWARD><<<blocks, SH_ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool BACKWARD>
int launch_k(const ShArgs& a, int K, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<1, BACKWARD>(a, stream);
    case 4: return launch<4, BACKWARD>(a, stream);
    case 9: return launch<9, BACKWARD>(a, stream);
    case 16: return launch<16, BACKWARD>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The forward where d_rgb is null (writes rgb), else the backward
// (writes d_xyz, d_dc, d_rest). rows > 0; K in {1, 4, 9, 16}; F >= 1;
// a null t_row reads as 0, a null is_actor as no actor rows.
extern "C" int sh_color_f32(const float* xyz, const float* center, const float* dc, const float* rest,
                            const float* t_row, const unsigned char* is_actor, const float* d_rgb, float* rgb,
                            float* d_xyz, float* d_dc, float* d_rest, long long rows, int K, int F, int deg_bkgd,
                            int deg_obj, void* stream) {
  ShArgs a{xyz, center, dc, rest, t_row, is_actor, d_rgb, rgb, d_xyz, d_dc, d_rest, rows, F, deg_bkgd, deg_obj};
  cudaStream_t s = (cudaStream_t)stream;
  return d_rgb == nullptr ? launch_k<false>(a, K, s) : launch_k<true>(a, K, s);
}
