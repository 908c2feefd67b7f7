// What the dense-table blend's forward (tile_blend_table.cu) and backward
// (tile_blend_table_bwd.cu) share: a tile's chunks and segments, one work
// item, the entering transmittance, the asynchronous staging of a chunk
// and the zero stores of the gradient table. Both kernels take every pass
// and stop decision through eval_alpha (blend_common.cuh) and carry the
// transmittance in the same grouping, so they agree bit for bit on where
// a pixel stops.
#pragma once
#include "blend_common.cuh"

namespace sgtable {

using namespace sgblend;

constexpr float T_EPS = 1e-4f;

// 128-lane chunks of a tile's table that the blend reads: cdiv(count,
// 128), no more than the table holds
__host__ __device__ inline int table_chunks(int count, int K) {
  return min((count + CHUNK - 1) / CHUNK, K / CHUNK);
}

__host__ __device__ inline int table_segments(int nchunks, int seg_chunks) {
  return max(1, (nchunks + seg_chunks - 1) / seg_chunks);
}

// a tile's segments, for build_plan
struct TableSegments {
  const int* tile_count;
  int K, seg_chunks;
  __device__ int operator()(int t) const {
    return table_segments(table_chunks(tile_count[t], K), seg_chunks);
  }
};

// One work item: segment `seg` of tile `tile`, its chunks [c_first, c_stop).
struct TableItem {
  int tile, seg, slot0;  // slot0 < 0: a short tile, its own only item
  int nchunks;           // the tile's
  int c_first, c_stop;
  bool last;  // holds the tile's last chunk (an empty tile's only item too)
  __device__ TableItem(const Plan& plan, int i, const int* tile_count, int K, int seg_chunks) {
    tile = plan.item_tile[i];
    seg = plan.item_seg[i];
    slot0 = plan.tile_slot[tile];
    nchunks = table_chunks(tile_count[tile], K);
    c_first = seg * seg_chunks;
    c_stop = min(c_first + seg_chunks, nchunks);
    last = c_stop == nchunks;
  }
};

// T entering segment `seg` of a long tile whose first slot is slot0: its
// earlier chunks' products P_c (prod[(slot0 * seg_chunks + c) * 256 + p],
// c the tile's chunk) folded in chunk order, T = T * P_c, as the walk
// folds each chunk's cp into T.
__device__ inline float entering_t(const float* __restrict__ prod, int slot0, int seg,
                                   int seg_chunks, int p) {
  float T = 1.0f;
  const float* q = prod + (size_t)slot0 * seg_chunks * PIX + p;
  for (int c = 0; c < seg * seg_chunks; ++c) T = T * q[(size_t)c * PIX];
  return T;
}

// ---- staging a chunk with cp.async ----

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Chunks [c0, c1) of one tile's table ([rows][K] at `table`, row stride
// K) through `nbuf` (1 or 2) shared buffers, each the lane-major copy of
// blend_common's Rows (lane l's rows at l * rp). With two buffers the
// next chunk is copied while the current one is walked. A caller calls
// start(), then get(c) for c = c0, c0 + 1, ... in turn, each followed by
// a block barrier once the chunk has been read (the barrier before its
// buffer is refilled), and finish() before it leaves: a walk that ends
// early may leave a copy in flight.
struct ChunkStager {
  float* sm;
  int floats, nbuf, rows, rp, K, c0, c1;
  const float* table;

  __device__ float* buf(int c) const { return sm + (size_t)((c - c0) % nbuf) * floats; }
  __device__ void stage(int c) const {
    float* dst = buf(c);
    const float* src = table + (size_t)c * CHUNK;
    for (int i = threadIdx.x; i < rows * CHUNK; i += PIX) {
      cp_async4(dst + (i % CHUNK) * rp + i / CHUNK, src + (size_t)(i / CHUNK) * K + i % CHUNK);
    }
    cp_async_commit();
  }
  __device__ void start() const {
    if (c0 < c1) stage(c0);
  }
  // chunk c's buffer, arrived and visible to the whole block
  __device__ const float* get(int c) const {
    if (nbuf > 1 && c + 1 < c1) {
      stage(c + 1);
      cp_async_wait_one();
    } else {
      if (nbuf == 1 && c > c0) stage(c);
      cp_async_wait_all();
    }
    __syncthreads();
    return buf(c);
  }
  __device__ void finish() const { cp_async_wait_all(); }
};

// ---- zeros in the gradient table ----

// rows [r0, r1) of chunks [ca, cb) of a tile's gradient table ([c_pad][K]
// at d_table), in 16-byte streaming stores
__device__ inline void zero_chunks(float* __restrict__ d_table, int K, int r0, int r1, int ca,
                                   int cb) {
  if (cb <= ca || r1 <= r0) return;
  const int per_row = (cb - ca) * (CHUNK / 4);
  const int n = (r1 - r0) * per_row;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < n; i += PIX) {
    const int r = r0 + i / per_row, o = i % per_row;
    __stcs(reinterpret_cast<float4*>(d_table + (size_t)r * K + (size_t)ca * CHUNK) + o, z);
  }
}

}  // namespace sgtable
