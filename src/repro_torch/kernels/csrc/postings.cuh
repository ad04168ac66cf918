// The postings kernel's per-tile steps, shared by the CUDA kernel
// (postings.cu, K5) and a host build the CPU tests check bit for bit
// against the plain version (kernels/postings.py).
//
// Counterpart of repro/kernels/postings.py:_bitonic_sort, _lower_bound
// and the body of _postings_kernel. A tile is block_w (a power of two)
// composite keys id * block_w + lane; they are unique, so the sorted
// order is unique and the rank of a word within its root segment is its
// key's sorted position minus the segment's start.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PK_HD __host__ __device__ __forceinline__
#else
#define PK_HD inline
#endif

namespace pk {

// Compare-exchange p (0 <= p < n / 2) of the bitonic stage (k, j), j a
// power of two below k: the pair is (i, i + j) with bit j of i clear; the
// run is ascending when bit k of i is clear.
PK_HD void exchange(int32_t* keys, int k, int j, int p) {
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int32_t a = keys[i], b = keys[i + j];
  if ((a > b) == ((i & k) == 0)) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

// Count of the n sorted keys strictly below q (n a power of two): log2 n
// branchless bisection steps, then one adjust, as _lower_bound does.
PK_HD int lower_bound(const int32_t* keys, int n, int log_n, int32_t q) {
  int lo = 0, hi = n - 1;
  for (int s = 0; s < log_n; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool ge = keys[mid] >= q;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  return lo + (keys[lo] < q);
}

// Per-tile histogram entry r: keys in [r * n, (r + 1) * n).
PK_HD int32_t bucket(const int32_t* keys, int n, int log_n, int r) {
  return lower_bound(keys, n, log_n, (r + 1) * n) -
         lower_bound(keys, n, log_n, r * n);
}

// The sorted key at position p -> (its lane, its rank in its segment).
PK_HD void rank_of(const int32_t* keys, int n, int log_n, int p, int* lane,
                   int32_t* rank) {
  const int32_t key = keys[p];
  *lane = key & (n - 1);
  *rank = p - lower_bound(keys, n, log_n, (key >> log_n) * n);
}

}  // namespace pk
