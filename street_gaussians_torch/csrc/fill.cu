// Run expansion: out[c, s] = vals[c, j] for the unique run j with
// offs[j] <= s < offs[j+1] (the last run ends at *total), and 0 for a
// slot that no run covers, at and beyond total included.
//
// Replaces street_gaussians_tpu/ops/fill.py::_kernel, a banded 0/1
// select matmul on the TPU's matrix unit. That is a TPU device and is
// not carried over.
//
// Bound on the H100: memory. The function reads vals [C, N] and offs
// [N] and writes out [C, S]. Design: one thread per output slot. Each
// thread binary-searches the run ends for the run that owns its slot
// (the log2(N) probes hit offs, which L2 holds), so the work is even
// however ragged the runs are. The values are copied, never summed, so
// the result is exact for any float and deterministic. Writes of one
// channel row are coalesced across a warp.
#include <cuda_runtime.h>

#include <cstddef>

__global__ void expand_runs_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ offs,
                                   const int* __restrict__ total_ptr,
                                   float* __restrict__ out, int C, int N,
                                   int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int total = *total_ptr;
  // first run whose end lies past s
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int end = mid + 1 < N ? offs[mid + 1] : total;
    if (end > s) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const bool hit = lo < N && offs[lo] <= s;
  for (int c = 0; c < C; ++c) {
    out[(size_t)c * S + s] = hit ? vals[(size_t)c * N + lo] : 0.0f;
  }
}

extern "C" int expand_runs_f32(const float* vals, const int* offs,
                               const int* total, float* out, int C, int N,
                               int S, void* stream) {
  if (S > 0) {
    const int threads = 256;
    expand_runs_kernel<<<(S + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(vals, offs, total, out, C,
                                                 N, S);
  }
  return (int)cudaGetLastError();
}
