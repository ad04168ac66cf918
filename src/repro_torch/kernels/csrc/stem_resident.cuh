// Stage 5 against resident dictionaries, for ONE word, and the word and
// output plumbing around it: shared by the megakernel (stem_fused.cu, K1)
// and the persistent kernel's resident variant (stem_persistent.cu, K3).
//
// The tables are the padded flat layouts of kernels/stem_fused.py
// (padded_tables): sorted and padded to a pow2 >= 128 with the sentinel for
// the binary search, padded to a 128 multiple with -2 for the bank. A
// kernel either copies them into shared memory (stage_tables) or reads
// them from global memory through __ldg (SHARED = false); the answers do
// not depend on where they are.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_datapath.cuh"

namespace rt {

// Threads a block launches: block_b (the logical tile: checksum tiles,
// visit lists, descriptor rows) may be any size; a block runs
// min(block_b, kMaxThreads) threads, each striding over the tile's words.
constexpr int kMaxThreads = 512;

__host__ __device__ __forceinline__ int block_threads(int block_b) {
  return block_b < kMaxThreads ? block_b : kMaxThreads;
}

template <bool SHARED>
__device__ __forceinline__ int32_t dict_at(const int32_t* d, int i) {
  if constexpr (SHARED) {
    return d[i];
  } else {
    return __ldg(d + i);
  }
}

// ceil(log2 rp) bisection steps over a sorted, sentinel-padded table of
// pow2 length rp; each probe index is clamped into [0, rp-1] like the
// reference's jnp.take(mode="clip").
template <bool SHARED>
__device__ __forceinline__ bool bsearch_hit(const int32_t* d, int rp,
                                            int steps, int32_t key) {
  int lo = 0, hi = rp - 1;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool ge = dict_at<SHARED>(d, min(max(mid, 0), rp - 1)) >= key;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  return dict_at<SHARED>(d, min(max(lo, 0), rp - 1)) == key;
}

// Comparator bank: any equal entry. Stopping at the first equal entry
// gives the same answer as the reference's all-pairs OR.
template <bool SHARED>
__device__ __forceinline__ bool bank_hit(const int32_t* d, int r,
                                         int32_t key) {
  for (int i = 0; i < r; ++i) {
    if (dict_at<SHARED>(d, i) == key) return true;
  }
  return false;
}

__device__ __forceinline__ int ceil_log2(int n) {
  return n > 1 ? 32 - __clz(n - 1) : 0;
}

// The tables a candidate group count reads: bi feeds group 4 only.
template <int N_GROUPS>
__host__ __device__ constexpr int n_tables() {
  return N_GROUPS == 5 ? 3 : 2;
}

// Copy the tables the groups read into dynamic shared memory (every padded
// length is a multiple of 128 ints, so int4 copies), repoint dict[] at
// the copies, and wait for the whole block.
template <int N_GROUPS>
__device__ __forceinline__ void stage_tables(const int32_t* dict[3],
                                             const int len[3]) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  int off = 0;
#pragma unroll
  for (int t = 0; t < n_tables<N_GROUPS>(); ++t) {
    const int4* src = reinterpret_cast<const int4*>(dict[t]);
    int4* dst = reinterpret_cast<int4*>(smem + off);
    for (int i = threadIdx.x; i < len[t] / 4; i += blockDim.x) {
      dst[i] = __ldg(src + i);
    }
    dict[t] = smem + off;
    off += len[t];
  }
  __syncthreads();
}

// Word row i as 16 ints (four 16-byte loads); rows past n_words read as
// the zero word, which has no valid candidate.
__device__ __forceinline__ void load_word(const int4* __restrict__ words,
                                          long long i, int n_words,
                                          int32_t w[kMaxLen]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = i < n_words ? __ldg(words + 4 * i + k)
                               : make_int4(0, 0, 0, 0);
    w[4 * k + 0] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store_root(int4* __restrict__ root,
                                           int32_t* __restrict__ source,
                                           long long i, int32_t chosen,
                                           int32_t src) {
  root[i] = make_int4((chosen >> 18) & 63, (chosen >> 12) & 63,
                      (chosen >> 6) & 63, chosen & 63);
  source[i] = src;
}

// Stages 1-5 for one word against the resident tables: slots are tried in
// priority order and the first hit wins, which is what the reference's
// priority select picks from the full hit mask.
template <int MATCH, bool SHARED, int N_GROUPS>
__device__ __forceinline__ void resident_word(const int32_t w[kMaxLen],
                                              const int32_t* const dict[3],
                                              const int len[3],
                                              const int steps[3],
                                              int32_t& chosen, int32_t& src) {
  int32_t keys[kSlots];
  bool valid[kSlots];
  candidate_columns(w, keys, valid);
  bool found = false;
  chosen = 0;
  src = 0;
#pragma unroll
  for (int s = 0; s < N_GROUPS * kCand; ++s) {
    const int g = s / kCand;
    const int t = rt_group_dict(g);
    if (!found && valid[s]) {
      const bool hit =
          MATCH == kMatchBsearch
              ? bsearch_hit<SHARED>(dict[t], len[t], steps[t], keys[s])
              : bank_hit<SHARED>(dict[t], len[t], keys[s]);
      if (hit) {
        found = true;
        chosen = keys[s];
        src = rt_group_tag(g);
      }
    }
  }
}

// Bisection depth per table (0 for the bank, which does not bisect).
template <int MATCH, int N_GROUPS>
__device__ __forceinline__ void table_steps(const int len[3], int steps[3]) {
  steps[0] = steps[1] = steps[2] = 0;
  if constexpr (MATCH == kMatchBsearch) {
#pragma unroll
    for (int t = 0; t < n_tables<N_GROUPS>(); ++t) {
      steps[t] = ceil_log2(len[t]);
    }
  }
}

// Dynamic shared memory a resident kernel asks for: the tables it reads,
// or none when they are read from global memory.
template <bool SHARED, int N_GROUPS>
size_t resident_smem_bytes(int tri_n, int quad_n, int bi_n) {
  if (!SHARED) return 0;
  return sizeof(int32_t) *
         (size_t(tri_n) + quad_n + (N_GROUPS == 5 ? bi_n : 0));
}

// Blocks of `kernel` the card keeps resident at once (occupancy x SMs),
// at most `want`.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem, int want,
                          int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms < want ? per_sm * sms : want;
  return cudaSuccess;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace rt
