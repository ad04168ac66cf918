// Streamed-dictionary stemmer megakernel for Hopper (sm_90a): stages 1-5
// in one launch, the dictionary streamed tile by tile from global memory.
//
// Replaces repro/kernels/stem_fused.py:_fused_pipeline_kernel with its
// _ladder_sweep (the streamed layout of stem_fused_pallas). One block per
// block_b-word tile, min(block_b, 512) threads, one word a thread (passes
// cover wider tiles): stages 1-4 (stem_datapath.cuh) leave 30 keys and a
// live-slot mask in registers; the block then walks its own visit list
// (n_visits[i] entries of row i of visit_idx, written by the torch
// pre-pass kernels/stem_fused.py:_visit_tables) through the cp.async ring
// of stem_sweep.cuh, and the first hit in slot order is the root.
//
// What bounds it on an H100: per word, 64 B in and 20 B out; per visited
// tile, dict_block_r * 512 bytes copied into shared memory by the block
// (the ~1 MB stream of a 262,144-key dictionary sits in the 50 MB L2, so
// these copies mostly hit L2), a range test of the word's live slots, and
// for the few keys that fall in the tile's range a bisection of
// log2(dict_block_r * 128) dependent shared-memory probes. With the skip
// index a batch tile still visits most tiles of a large dictionary, since
// 256 words' keys spread over all of them: the tile walk (copies,
// barriers, range tests) is the cost, not the compares.
//
// What the design does about it: the copy of visit k + num_buffers - 1 is
// issued before visit k is compared, so copies overlap compares; a
// block-wide vote (__syncthreads_or) skips the compare of a tile no live
// key of the block can hit; a slot stops searching once it has hit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"
#include "stem_sweep.cuh"

namespace {

using rt::kMatchBank;
using rt::kMatchBsearch;
using rt::kMaxThreads;

template <int MATCH, int N_GROUPS, int NB>
__global__ void __launch_bounds__(kMaxThreads)
stem_streamed_kernel(const int4* __restrict__ words, int n_words,
                     const int32_t* __restrict__ stream, int n_tiles,
                     const int32_t* __restrict__ n_visits,
                     const int32_t* __restrict__ visit_idx,
                     int4* __restrict__ root, int32_t* __restrict__ source,
                     int block_b, int tile_n, int tri_tiles,
                     int quad_tiles) {
  extern __shared__ int4 smem4[];
  rt::streamed_tile<MATCH, N_GROUPS, NB>(
      words, n_words, (long long)blockIdx.x * block_b, block_b, stream,
      visit_idx + size_t(blockIdx.x) * n_tiles, __ldg(n_visits + blockIdx.x),
      tile_n, tri_tiles, quad_tiles, reinterpret_cast<int32_t*>(smem4), root,
      source);
}

struct Args {
  const int4* words;
  int n_words;
  const int32_t* stream;
  int n_tiles;
  const int32_t* n_visits;
  const int32_t* visit_idx;
  int4* root;
  int32_t* source;
  int block_b;
  int tile_n;
  int tri_tiles;
  int quad_tiles;
  cudaStream_t stream_;
};

template <int MATCH, int N_GROUPS, int NB>
int launch(const Args& a) {
  auto kernel = stem_streamed_kernel<MATCH, N_GROUPS, NB>;
  const size_t smem = sizeof(int32_t) * size_t(NB) * a.tile_n;
  const cudaError_t e = rt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  const unsigned grid = unsigned((a.n_words + a.block_b - 1) / a.block_b);
  kernel<<<grid, rt::block_threads(a.block_b), smem, a.stream_>>>(
      a.words, a.n_words, a.stream, a.n_tiles, a.n_visits, a.visit_idx,
      a.root, a.source, a.block_b, a.tile_n, a.tri_tiles, a.quad_tiles);
  return int(cudaGetLastError());
}

template <int MATCH, int N_GROUPS>
int launch_buffers(const Args& a, int num_buffers) {
  switch (num_buffers) {
    case 1: return launch<MATCH, N_GROUPS, 1>(a);
    case 2: return launch<MATCH, N_GROUPS, 2>(a);
    case 3: return launch<MATCH, N_GROUPS, 3>(a);
    default: return launch<MATCH, N_GROUPS, 4>(a);
  }
}

template <int MATCH>
int launch_groups(const Args& a, int n_groups, int num_buffers) {
  return n_groups == 5 ? launch_buffers<MATCH, 5>(a, num_buffers)
                       : launch_buffers<MATCH, 2>(a, num_buffers);
}

}  // namespace

// words int32[n_words, 16]; stream int32[n_tiles * dict_block_r, 128] (the
// DictTileSet stream: tri_tiles tri tiles, then quad_tiles quad tiles,
// then bi); n_visits int32[bt], visit_idx int32[bt, n_tiles] with bt =
// ceil(n_words / block_b) -> root int32[n_words, 4], source int32[n_words].
// words and stream 16-byte aligned. Launches on `stream_` and returns the
// CUDA error code (0 on success) of the launch.
extern "C" int stem_streamed_launch(const void* words, int n_words,
                                    const void* stream, int n_tiles,
                                    const void* n_visits,
                                    const void* visit_idx, void* root,
                                    void* source, int block_b,
                                    int dict_block_r, int num_buffers,
                                    int tri_tiles, int quad_tiles,
                                    int n_groups, int match, void* stream_) {
  if (n_words <= 0) return 0;
  if (block_b < 1 || dict_block_r < 1 ||
      num_buffers < 1 || num_buffers > 4 || (n_groups != 2 && n_groups != 5) ||
      (match != kMatchBsearch && match != kMatchBank)) {
    return int(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int4*>(words),
               n_words,
               static_cast<const int32_t*>(stream),
               n_tiles,
               static_cast<const int32_t*>(n_visits),
               static_cast<const int32_t*>(visit_idx),
               static_cast<int4*>(root),
               static_cast<int32_t*>(source),
               block_b,
               dict_block_r * 128,
               tri_tiles,
               quad_tiles,
               static_cast<cudaStream_t>(stream_)};
  return match == kMatchBsearch
             ? launch_groups<kMatchBsearch>(a, n_groups, num_buffers)
             : launch_groups<kMatchBank>(a, n_groups, num_buffers);
}

extern "C" const char* stem_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
