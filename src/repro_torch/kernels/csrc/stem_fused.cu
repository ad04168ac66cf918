// Stemmer megakernel for Hopper (sm_90a): stages 1-5 in one launch.
//
// Replaces repro/kernels/stem_fused.py:_fused_kernel (the resident,
// non-persistent Pallas kernel behind stem_fused_pallas). Per word: the
// 30 packed candidate keys and validity flags of stem_datapath.cuh, a
// membership test of each valid key against its group's sorted dictionary
// (branchless binary search, or a linear comparator-bank scan), and the
// first hit in slot order unpacked into (root[4], source).
//
// What bounds it on an H100: device traffic is small, 64 B of word in and
// 20 B of (root, source) out, 84 B a word. The work is integer issue and
// dependent dictionary lookups: up to 30 slots x (ceil(log2 Rp) + 1)
// probes a word, about 30 x 12 for the realistic 2048-entry tri table,
// each probe a load whose address depends on the last. So the kernel is
// bound by integer instructions and shared-memory latency, not bytes.
//
// What the design does about it:
//   - block_b words per block (the logical tile), min(block_b, 512)
//     threads, each striding over the tile's words; the word row read as
//     four 16-byte loads; the datapath and all 30 keys stay in registers;
//   - the padded tri/quad/bi tables are copied into dynamic shared memory
//     once per block, so every probe is a shared-memory load (bank
//     conflicts are data dependent). Tables larger than the shared-memory
//     budget are read from global memory through __ldg in the same kernel
//     (template flag SHARED); outputs do not depend on the path;
//   - slots are tried in priority order and a word stops at its first
//     hit, which the priority select would pick anyway, so a word pays
//     only for the valid slots up to its hit;
//   - the pad rows of a ragged last block are masked, not computed.
// The per-word code lives in stem_resident.cuh, shared with the
// persistent kernel (stem_persistent.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"

namespace {

using rt::kMatchBank;
using rt::kMatchBsearch;
using rt::kMaxThreads;

// One word of the tile: stages 1-5 and the store.
template <int MATCH, bool SHARED, int N_GROUPS>
__device__ __forceinline__ void fused_word(const int4* __restrict__ words,
                                           int n_words, int i,
                                           const int32_t* const dict[3],
                                           const int len[3],
                                           int4* __restrict__ root,
                                           int32_t* __restrict__ source) {
  int32_t word[rt::kMaxLen];
  rt::load_word(words, i, n_words, word);
  int steps[3];
  rt::table_steps<MATCH, N_GROUPS>(len, steps);
  int32_t chosen, src;
  rt::resident_word<MATCH, SHARED, N_GROUPS>(word, dict, len, steps, chosen,
                                             src);
  rt::store_root(root, source, i, chosen, src);
}

// WIDE: block_b exceeds the block's threads, which stride over the tile.
// Otherwise each thread has at most one word. The two are separate
// instances: the strided loop raises the register count (40 -> 64 for the
// bsearch, 5-group instances), which costs occupancy on narrow tiles.
template <int MATCH, bool SHARED, int N_GROUPS, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads)
stem_fused_kernel(const int4* __restrict__ words, int n_words,
                  const int32_t* __restrict__ tri, int tri_n,
                  const int32_t* __restrict__ quad, int quad_n,
                  const int32_t* __restrict__ bi, int bi_n,
                  int4* __restrict__ root, int32_t* __restrict__ source,
                  int block_b) {
  const int32_t* dict[3] = {tri, quad, bi};
  const int len[3] = {tri_n, quad_n, bi_n};
  if constexpr (SHARED) rt::stage_tables<N_GROUPS>(dict, len);

  if constexpr (WIDE) {
    // the grid covers n_words, so base < n_words and every index fits
    const int base = blockIdx.x * block_b;
    const int rows = min(block_b, n_words - base);
    for (int w = threadIdx.x; w < rows; w += blockDim.x) {
      fused_word<MATCH, SHARED, N_GROUPS>(words, n_words, base + w, dict, len,
                                          root, source);
    }
  } else {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_words) return;
    fused_word<MATCH, SHARED, N_GROUPS>(words, n_words, i, dict, len, root,
                                        source);
  }
}

struct Args {
  const int4* words;
  int n_words;
  const int32_t* tri;
  int tri_n;
  const int32_t* quad;
  int quad_n;
  const int32_t* bi;
  int bi_n;
  int4* root;
  int32_t* source;
  int block_b;
  cudaStream_t stream;
};

template <int MATCH, bool SHARED, int N_GROUPS, bool WIDE>
int launch(const Args& a) {
  auto kernel = stem_fused_kernel<MATCH, SHARED, N_GROUPS, WIDE>;
  const size_t smem =
      rt::resident_smem_bytes<SHARED, N_GROUPS>(a.tri_n, a.quad_n, a.bi_n);
  const cudaError_t e = rt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  const unsigned grid = unsigned((a.n_words + a.block_b - 1) / a.block_b);
  kernel<<<grid, rt::block_threads(a.block_b), smem, a.stream>>>(
      a.words, a.n_words, a.tri, a.tri_n, a.quad, a.quad_n, a.bi, a.bi_n,
      a.root, a.source, a.block_b);
  return int(cudaGetLastError());
}

template <int MATCH, bool SHARED, int N_GROUPS>
int launch_width(const Args& a) {
  return a.block_b > kMaxThreads ? launch<MATCH, SHARED, N_GROUPS, true>(a)
                                 : launch<MATCH, SHARED, N_GROUPS, false>(a);
}

template <int MATCH, bool SHARED>
int launch_groups(const Args& a, int n_groups) {
  return n_groups == 5 ? launch_width<MATCH, SHARED, 5>(a)
                       : launch_width<MATCH, SHARED, 2>(a);
}

template <int MATCH>
int launch_residency(const Args& a, int n_groups, int dict_in_shared) {
  return dict_in_shared ? launch_groups<MATCH, true>(a, n_groups)
                        : launch_groups<MATCH, false>(a, n_groups);
}

}  // namespace

// words int32[n_words, 16], tables int32[*_n] padded (pow2 >= 128 with the
// sentinel for match 0 = bsearch, a 128 multiple with -2 for match 1 =
// bank) -> root int32[n_words, 4], source int32[n_words]. All pointers
// 16-byte aligned. Launches on `stream` and returns the CUDA error code
// (0 on success) of the launch.
extern "C" int stem_fused_launch(const void* words, int n_words,
                                 const void* tri, int tri_n, const void* quad,
                                 int quad_n, const void* bi, int bi_n,
                                 void* root, void* source, int block_b,
                                 int n_groups, int match, int dict_in_shared,
                                 void* stream) {
  if (n_words <= 0) return 0;
  if (block_b < 1) return int(cudaErrorInvalidValue);
  if (n_groups != 2 && n_groups != 5) return int(cudaErrorInvalidValue);
  if (match != kMatchBsearch && match != kMatchBank) {
    return int(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int4*>(words),
               n_words,
               static_cast<const int32_t*>(tri),
               tri_n,
               static_cast<const int32_t*>(quad),
               quad_n,
               static_cast<const int32_t*>(bi),
               bi_n,
               static_cast<int4*>(root),
               static_cast<int32_t*>(source),
               block_b,
               static_cast<cudaStream_t>(stream)};
  return match == kMatchBsearch
             ? launch_residency<kMatchBsearch>(a, n_groups, dict_in_shared)
             : launch_residency<kMatchBank>(a, n_groups, dict_in_shared);
}

extern "C" const char* stem_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
