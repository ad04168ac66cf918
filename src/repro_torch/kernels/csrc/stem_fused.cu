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
//   - one thread per word, block_b words per block, the word row read as
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_datapath.cuh"

namespace {

constexpr int kMaxBlock = 512;
constexpr int kMatchBsearch = 0;
constexpr int kMatchBank = 1;

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

template <int MATCH, bool SHARED, int N_GROUPS>
__global__ void __launch_bounds__(kMaxBlock)
stem_fused_kernel(const int4* __restrict__ words, int n_words,
                  const int32_t* __restrict__ tri, int tri_n,
                  const int32_t* __restrict__ quad, int quad_n,
                  const int32_t* __restrict__ bi, int bi_n,
                  int4* __restrict__ root, int32_t* __restrict__ source) {
  constexpr int kTables = N_GROUPS == 5 ? 3 : 2;  // bi feeds group 4 only
  const int32_t* dict[3] = {tri, quad, bi};
  const int len[3] = {tri_n, quad_n, bi_n};

  if constexpr (SHARED) {
    extern __shared__ int4 smem4[];
    int32_t* smem = reinterpret_cast<int32_t*>(smem4);
    int off = 0;
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
      // every padded table length is a multiple of 128 ints
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

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;

  int32_t w[rt::kMaxLen];
  const int4* row = words + 4ll * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = __ldg(row + k);
    w[4 * k + 0] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }

  int32_t keys[rt::kSlots];
  bool valid[rt::kSlots];
  rt::candidate_columns(w, keys, valid);

  int steps[3] = {0, 0, 0};
  if constexpr (MATCH == kMatchBsearch) {
#pragma unroll
    for (int t = 0; t < kTables; ++t) steps[t] = ceil_log2(len[t]);
  }

  bool found = false;
  int32_t chosen = 0, src = 0;
#pragma unroll
  for (int s = 0; s < N_GROUPS * rt::kCand; ++s) {
    const int g = s / rt::kCand;
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
  root[i] = make_int4((chosen >> 18) & 63, (chosen >> 12) & 63,
                      (chosen >> 6) & 63, chosen & 63);
  source[i] = src;
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

template <int MATCH, bool SHARED, int N_GROUPS>
int launch(const Args& a) {
  auto kernel = stem_fused_kernel<MATCH, SHARED, N_GROUPS>;
  size_t smem = 0;
  if (SHARED) {
    smem = sizeof(int32_t) *
           (size_t(a.tri_n) + a.quad_n + (N_GROUPS == 5 ? a.bi_n : 0));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
    }
  }
  const unsigned grid = unsigned((a.n_words + a.block_b - 1) / a.block_b);
  kernel<<<grid, a.block_b, smem, a.stream>>>(
      a.words, a.n_words, a.tri, a.tri_n, a.quad, a.quad_n, a.bi, a.bi_n,
      a.root, a.source);
  return int(cudaGetLastError());
}

template <int MATCH, bool SHARED>
int launch_groups(const Args& a, int n_groups) {
  return n_groups == 5 ? launch<MATCH, SHARED, 5>(a)
                       : launch<MATCH, SHARED, 2>(a);
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
  if (block_b < 1 || block_b > kMaxBlock) return int(cudaErrorInvalidValue);
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
