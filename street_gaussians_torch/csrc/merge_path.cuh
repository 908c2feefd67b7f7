// Merge-path partition (the CSR-SpMV "load-balanced search"): split the
// merge of two sorted lists into tiles of equal length with one binary
// search per tile boundary.
//
// List A holds a_len items, list B b_len items, and `a_before_b(i, j)`
// says whether A's item i comes before B's item j in the merge. Then
// the first `diag` items of the merge are A's first i items and B's
// first diag - i, and merge_path_search(diag, ...) returns that i. A
// tile [diag0, diag1) so holds A's items [i(diag0), i(diag1)) and B's
// [diag0 - i(diag0), diag1 - i(diag1)), the same number of items in
// every tile however the two lists interleave.
//
// The port's two merges (the segmented row-sum and the run expansion):
//   segment ends 0..N-1 with sorted keys: segment end i comes before
//     row j iff keys[j] > i (row j belongs to a later segment);
//   run ends (offs[i + 1], the last run's total) with slots 0..S-1: run
//     end i comes before slot j iff end(i) <= j.
#pragma once

// By one thread: a plain binary search, one probe a step.
template <class Before>
__device__ __forceinline__ int merge_path_search(int diag, int a_len, int b_len, Before a_before_b) {
  int lo = diag > b_len ? diag - b_len : 0;
  int hi = diag < a_len ? diag : a_len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_before_b(mid, diag - mid - 1)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// By a whole warp (all 32 lanes, converged; every lane gets the
// answer): 32 probes a round, so a round narrows the range 32-fold and
// a range of a few million takes 5 rounds of loads instead of 22 steps
// of one load each. For a search over device memory, where each step
// waits on a load.
template <class Before>
__device__ __forceinline__ int merge_path_search_warp(int diag, int a_len, int b_len, Before a_before_b) {
  const int lane = threadIdx.x & 31;
  int lo = diag > b_len ? diag - b_len : 0;
  int hi = diag < a_len ? diag : a_len;
  while (lo < hi) {
    // a_before_b(m, diag - m - 1) holds for m below the answer only:
    // the lanes that find it true are a prefix
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    const bool below = m < hi && a_before_b(m, diag - m - 1);
    const int k = __popc(__ballot_sync(0xffffffffu, below));
    if (k == 0) {
      hi = lo;
    } else {
      const int last = lo + (k - 1) * step;  // the last probe below the answer
      hi = min(hi, last + step);
      lo = last + 1;
    }
  }
  return lo;
}
