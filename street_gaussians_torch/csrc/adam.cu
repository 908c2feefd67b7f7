// Row-masked Adam over every leaf of a train step, in one launch.
//
// Replaces no TPU kernel: street_gaussians_tpu/optim/adam.py is plain
// jnp, which XLA fused into one pass over each leaf. Run eagerly, its
// PyTorch port (optim/adam.leaf_update) is some 22 full-size
// elementwise kernels a leaf, each reading one or two leaf-sized arrays
// and writing one: ~230 bytes move a float.
//
// Bound on the H100: memory. A step must read p, g, mu, nu and write p,
// mu, nu once, 28 bytes a float, plus each row's mask (1 byte), count
// (4 read, 4 written) and per-row lr (4) once a leaf. Design:
//  - one launch for all leaves: the leaves are described in a table
//    passed by value in the kernel's parameters (AdamTable, read through
//    __grid_constant__, no copy to the device), built by the C entry
//    point from the wrapper's pointers; block b takes chunk
//    b - chunk0[l] of the leaf l whose chunk range holds b;
//  - a block's chunk is ADAM_CHUNK consecutive floats of its leaf, a
//    warp's share one run of WARP_FLOATS, each lane ADAM_ITEMS vectors
//    of 4 floats, loaded and stored as 16 bytes where the leaf's seven
//    arrays are 16-byte aligned; the ragged tail is masked;
//  - with its floats' loads in flight, a warp takes each row its run
//    touches once, a lane a row: the row's mask, count and lr, read
//    through the read-only cache, and its bias corrections (two powf),
//    kept in shared memory for the warp's floats; the warp that holds a
//    row's first float writes its new count (a scalar count: the leaf's
//    first block's first thread). No block barrier: warps run apart.
// Measured on the garden's leaves (377M floats in 7 leaves, 11.1 GB):
// 4.07 ms, 82% of the 3.33 ms bound at 3.35 TB/s (PyTorch's own add and
// copy kernels move 3.08 TB/s on the card); the block and item sizes
// and the two designs that lost, each thread computing its own rows'
// steps or a block barrier before the floats, are in PERF.md.
// The arithmetic is leaf_update's, operation for operation and in the
// same order, each product and sum rounded on its own (built with
// -fmad=false, as PyTorch's separate kernels round), powf for the
// bias corrections as PyTorch's pow kernel calls it: the result is
// bit-equal to leaf_update's on the card. Out of place: the wrapper
// allocates the outputs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ADAM_THREADS = 128;
constexpr int ADAM_ITEMS = 2;  // vectors of 4 floats a lane
constexpr unsigned ADAM_CHUNK = ADAM_THREADS * 4 * ADAM_ITEMS;
constexpr int ADAM_MAX_LEAVES = 32;  // the table fits the 4 KB of a launch's parameters

// AdamLeaf.flags
constexpr unsigned ROW_COUNT = 1;  // count [rows]; else a scalar count and no mask
constexpr unsigned VEC = 2;        // the seven arrays 16-byte aligned

struct AdamLeaf {
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  float* p_out;
  float* mu_out;
  float* nu_out;
  const float* cnt;
  float* cnt_out;
  const unsigned char* mask;  // bool [rows]; null: every row steps
  const float* lr;   // [rows]; null: lr_scalar
  float lr_scalar;
  unsigned numel;  // < 2^31
  unsigned width;  // floats a row
  unsigned flags;
  unsigned chunk0;  // the leaf's first block
};

struct AdamTable {
  AdamLeaf leaf[ADAM_MAX_LEAVES];
  int n;
  float b1, b2, omb1, omb2, eps;  // omb = 1 - b, rounded from double as PyTorch rounds a Python float
};

// What leaf_update computes once a row: the mask, the new count, the
// bias corrections and the lr
struct RowStep {
  float mb, c, bc1, bc2, lr;
};

__device__ __forceinline__ RowStep row_step(const AdamLeaf& L, const AdamTable& t, unsigned row) {
  RowStep r;
  r.mb = 1.0f;
  if (L.mask != nullptr) r.mb = __ldg(L.mask + row) ? 1.0f : 0.0f;
  r.c = __ldg(L.cnt + ((L.flags & ROW_COUNT) ? row : 0)) + r.mb;
  const float e = r.c > 0.0f ? r.c : 1.0f;
  r.bc1 = 1.0f - powf(t.b1, e);
  r.bc2 = 1.0f - powf(t.b2, e);
  r.lr = L.lr != nullptr ? __ldg(L.lr + row) : L.lr_scalar;
  return r;
}

// leaf_update on one float: p, mu, nu in place of the new values
__device__ __forceinline__ void step(const RowStep& r, const AdamTable& t, float& p, float g, float& mu,
                                     float& nu) {
  const float omb = 1.0f - r.mb;
  mu = r.mb * (t.b1 * mu + t.omb1 * g) + omb * mu;
  nu = r.mb * (t.b2 * nu + t.omb2 * g * g) + omb * nu;
  const float upd = r.c > 0.0f ? r.lr * (mu / r.bc1) / (sqrtf(nu / r.bc2) + t.eps) : 0.0f;
  p = p - r.mb * upd;
}

__device__ __forceinline__ float4 load4(const float* a) { return __ldg(reinterpret_cast<const float4*>(a)); }

__device__ __forceinline__ void store4(float* a, const float (&v)[4]) {
  *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
}

// a warp's row steps: its floats are one run of WARP_FLOATS, so it
// touches at most that many rows (width 1)
constexpr unsigned WARP_FLOATS = 32 * 4 * ADAM_ITEMS;
struct WarpRows {
  float mb[WARP_FLOATS], c[WARP_FLOATS], bc1[WARP_FLOATS], bc2[WARP_FLOATS], lr[WARP_FLOATS];
};
static_assert(sizeof(WarpRows) * (ADAM_THREADS / 32) <= 48 * 1024, "static shared memory");

__global__ void __launch_bounds__(ADAM_THREADS) adam_kernel(const __grid_constant__ AdamTable t) {
  __shared__ WarpRows shared_rows[ADAM_THREADS / 32];
  int l = 0;
  for (int k = 1; k < t.n; ++k) {
    if (t.leaf[k].chunk0 <= blockIdx.x) l = k;
  }
  const AdamLeaf& L = t.leaf[l];
  const unsigned chunk = blockIdx.x - L.chunk0;
  if (!(L.flags & ROW_COUNT) && chunk == 0 && threadIdx.x == 0) L.cnt_out[0] = __ldg(L.cnt) + 1.0f;
  const unsigned lane = threadIdx.x % 32;
  const unsigned base = chunk * ADAM_CHUNK + threadIdx.x / 32 * WARP_FLOATS;  // the warp's run
  if (base >= L.numel) return;
  WarpRows& sh = shared_rows[threadIdx.x / 32];

  // 1. the warp's floats, loaded first so that they are in flight while
  // 2 runs; item i of a lane is floats base + 128 i + 4 lane .. + 3
  float p[ADAM_ITEMS][4], g[ADAM_ITEMS][4], mu[ADAM_ITEMS][4], nu[ADAM_ITEMS][4];
  unsigned e0[ADAM_ITEMS];
  const bool vec = L.flags & VEC;
#pragma unroll
  for (int i = 0; i < ADAM_ITEMS; ++i) {
    e0[i] = base + 128 * i + 4 * lane;
    if (vec && e0[i] + 4 <= L.numel) {
      const float4 a = load4(L.p + e0[i]), b = load4(L.g + e0[i]);
      const float4 c = load4(L.mu + e0[i]), d = load4(L.nu + e0[i]);
      p[i][0] = a.x, p[i][1] = a.y, p[i][2] = a.z, p[i][3] = a.w;
      g[i][0] = b.x, g[i][1] = b.y, g[i][2] = b.z, g[i][3] = b.w;
      mu[i][0] = c.x, mu[i][1] = c.y, mu[i][2] = c.z, mu[i][3] = c.w;
      nu[i][0] = d.x, nu[i][1] = d.y, nu[i][2] = d.z, nu[i][3] = d.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned e = e0[i] + j;
        const bool live = e < L.numel;
        p[i][j] = live ? __ldg(L.p + e) : 0.0f;
        g[i][j] = live ? __ldg(L.g + e) : 0.0f;
        mu[i][j] = live ? __ldg(L.mu + e) : 0.0f;
        nu[i][j] = live ? __ldg(L.nu + e) : 0.0f;
      }
    }
  }

  // 2. each row the warp's run touches, once: a lane a row reads its
  // mask, count and lr and takes its bias corrections; the warp that
  // holds the row's first float writes its new count
  const unsigned end = min(base + WARP_FLOATS, L.numel);
  const unsigned r0 = base / L.width, nrows = (end - 1) / L.width - r0 + 1;
  for (unsigned k = lane; k < nrows; k += 32) {
    const unsigned row = r0 + k;
    const RowStep r = row_step(L, t, row);
    sh.mb[k] = r.mb, sh.c[k] = r.c, sh.bc1[k] = r.bc1, sh.bc2[k] = r.bc2, sh.lr[k] = r.lr;
    if ((L.flags & ROW_COUNT) && row * L.width >= base) L.cnt_out[row] = r.c;
  }
  __syncwarp();

  // 3. the step a float, and the stores
#pragma unroll
  for (int i = 0; i < ADAM_ITEMS; ++i) {
    if (e0[i] >= L.numel) continue;
    unsigned k = e0[i] / L.width;
    unsigned col = e0[i] - k * L.width;
    k -= r0;
    RowStep r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0[i] + j >= L.numel) break;
      if (j > 0 && ++col == L.width) {
        col = 0;
        ++k;
      }
      if (j == 0 || col == 0) r = RowStep{sh.mb[k], sh.c[k], sh.bc1[k], sh.bc2[k], sh.lr[k]};
      step(r, t, p[i][j], g[i][j], mu[i][j], nu[i][j]);
    }
    if (vec && e0[i] + 4 <= L.numel) {
      store4(L.p_out + e0[i], p[i]);
      store4(L.mu_out + e0[i], mu[i]);
      store4(L.nu_out + e0[i], nu[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e0[i] + j < L.numel) {
          L.p_out[e0[i] + j] = p[i][j];
          L.mu_out[e0[i] + j] = mu[i][j];
          L.nu_out[e0[i] + j] = nu[i][j];
        }
      }
    }
  }
}

}  // namespace

// n <= ADAM_MAX_LEAVES leaves; ptrs: 11 a leaf, in AdamLeaf's order (p,
// g, mu, nu, p_out, mu_out, nu_out, cnt, cnt_out, mask or null, lr or
// null); sizes: numel and width a leaf; flags: ROW_COUNT a leaf (VEC is
// decided here); lr_scalar: a leaf's Python lr where lr is null.
// *launched: 1, or 0 where no leaf has a float or a scalar count.
extern "C" int adam_step_f32(int n, void* const* ptrs, const long long* sizes, const int* flags,
                             const double* lr_scalar, double b1, double b2, double eps, int* launched,
                             void* stream) {
  AdamTable t;
  t.n = n;
  t.b1 = (float)b1;
  t.b2 = (float)b2;
  t.omb1 = (float)(1.0 - b1);
  t.omb2 = (float)(1.0 - b2);
  t.eps = (float)eps;
  unsigned blocks = 0;
  for (int k = 0; k < n; ++k) {
    void* const* q = ptrs + 11 * k;
    AdamLeaf& L = t.leaf[k];
    L.p = static_cast<const float*>(q[0]);
    L.g = static_cast<const float*>(q[1]);
    L.mu = static_cast<const float*>(q[2]);
    L.nu = static_cast<const float*>(q[3]);
    L.p_out = static_cast<float*>(q[4]);
    L.mu_out = static_cast<float*>(q[5]);
    L.nu_out = static_cast<float*>(q[6]);
    L.cnt = static_cast<const float*>(q[7]);
    L.cnt_out = static_cast<float*>(q[8]);
    L.mask = static_cast<const unsigned char*>(q[9]);
    L.lr = static_cast<const float*>(q[10]);
    L.lr_scalar = (float)lr_scalar[k];
    L.numel = (unsigned)sizes[2 * k];
    L.width = (unsigned)sizes[2 * k + 1];
    bool aligned = true;
    for (int a = 0; a < 7; ++a) aligned = aligned && reinterpret_cast<uintptr_t>(q[a]) % 16 == 0;
    L.flags = (unsigned)flags[k] | (aligned ? VEC : 0u);
    L.chunk0 = blocks;
    unsigned chunks = (L.numel + ADAM_CHUNK - 1) / ADAM_CHUNK;
    if (!(L.flags & ROW_COUNT) && chunks == 0) chunks = 1;  // the scalar count still steps
    blocks += chunks;
  }
  *launched = blocks > 0;
  if (blocks > 0) adam_kernel<<<blocks, ADAM_THREADS, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
