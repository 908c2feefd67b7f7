// Segmented row-sum: out[c, g] = sum of d[c, j] over the rows j whose
// key falls in segment g, [offs[g], ends[g]) (identity segments: key g
// alone). Keys are ascending, so each segment owns one contiguous row
// range of the sorted array; padding rows carry keys >= 2^30 and fall in
// no segment.
//
// Replaces street_gaussians_tpu/ops/segsum.py::_kernel, a banded 0/1
// matmul on the TPU's matrix unit that walks (group, chunk) pairs of a
// sequential grid. That is a TPU device and is not carried over.
//
// Bound on the H100: memory. The function reads d [C, L] and the keys
// [L] and writes out [C, N]. Design: a block of 256 threads takes
// 256 / G consecutive segments. Its threads first find those segments'
// row ranges [row0, row1) by binary searches over the keys (L2 holds
// them) into shared memory; then thread (segment j, channel group q)
// sums channels q, q + G, ... of segment j in key order, 8 loads issued
// ahead and added in order. A warp is 32 consecutive segments of one
// channel group, so its loads walk adjacent rows and its writes of
// out[c, g] are coalesced. G comes from the rows per segment: where
// L >= N (the payload gradient: a Gaussian's instances, up to hundreds)
// G = 8 splits a long segment's serial chain over the channels; where
// L < N (the sky gradient: most texels empty) G = 1 keeps one thread per
// segment, since 8x the threads would mostly find nothing to sum. Each
// output has exactly one writer and sums in key order, with no atomics:
// the result is bit-reproducible and equal to the CPU plain version's.
// An empty segment costs its share of the searches and writes zeros, so
// `skip_empty` needs no work here.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // loads in flight per thread

// first row j with keys[j] >= key
__device__ __forceinline__ long lower_bound(const int* __restrict__ keys,
                                            long L, int key) {
  long lo = 0, hi = L;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    if (keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    segment_rowsum_kernel(const float* __restrict__ d,
                          const int* __restrict__ keys,
                          const int* __restrict__ offs,
                          const int* __restrict__ ends,
                          float* __restrict__ out, int C, long L, int N,
                          int groups) {
  __shared__ long bound[2][THREADS];  // row0, row1 of the block's segments
  const int t = threadIdx.x;
  const int segs = THREADS / groups;
  const int s0 = blockIdx.x * segs;
  for (int i = t; i < 2 * segs; i += THREADS) {
    const int side = i / segs;  // 0: segment start, 1: segment end
    const int g = s0 + i % segs;
    long r = 0;
    if (g < N) {
      const int key = offs == nullptr ? g + side : (side ? ends[g] : offs[g]);
      r = lower_bound(keys, L, key);
    }
    bound[side][i % segs] = r;
  }
  __syncthreads();
  const int j = t % segs;
  const int g = s0 + j;
  if (g >= N) return;
  const long a = bound[0][j];
  const long b = bound[1][j] > a ? bound[1][j] : a;  // ends <= offs: empty
  for (int c = t / segs; c < C; c += groups) {
    const float* dc = d + (size_t)c * L;
    float s = 0.0f;
    long r = a;
    for (; r + UNROLL <= b; r += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = dc[r + u];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s += v[u];
    }
    for (; r < b; ++r) s += dc[r];
    out[(size_t)c * N + g] = s;
  }
}

}  // namespace

// offs == ends == nullptr selects identity segments.
extern "C" int segment_rowsum_f32(const float* d, const int* keys,
                                  const int* offs, const int* ends,
                                  float* out, int C, long L, int N,
                                  void* stream) {
  if (N > 0) {
    const int groups = L >= N ? 8 : 1;
    const int segs = THREADS / groups;
    segment_rowsum_kernel<<<(N + segs - 1) / segs, THREADS, 0,
                            (cudaStream_t)stream>>>(d, keys, offs, ends, out,
                                                    C, L, N, groups);
  }
  return (int)cudaGetLastError();
}
