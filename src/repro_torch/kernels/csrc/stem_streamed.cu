// Streamed-dictionary stemmer megakernel for Hopper (sm_90a): stages 1-5
// in one launch, the dictionary searched key by key from a fence level.
//
// Replaces repro/kernels/stem_fused.py:_fused_pipeline_kernel with its
// _ladder_sweep (the streamed layout of stem_fused_pallas). The reference
// streams dictionary tiles past a word tile through VMEM over a visit
// list, because VMEM cannot hold the table. On an H100 the whole stream
// of a large dictionary (1 MB at 262,144 keys) sits in the 50 MB L2, and
// its fence level (every 8th entry: 131.6 KB) in one block's shared
// memory. So there is no visit list and no tile walk: a block stages the
// fences once, then its threads stride over the words, one word a
// thread: stages 1-4 (stem_datapath.cuh) leave 30 keys and a live-slot
// mask in registers, and each live key is searched in its own table
// (stem_fences.cuh): a bisection of the fences in shared memory, one
// 32-byte read from L2, a compare. The first hit in slot order is the
// root. Each thread's first word goes through stages 1-4 while the
// fences are still being copied.
//
// What bounds it on an H100: per word, 64 B in and 20 B out, and the
// stream once; per live key (up to the first group with a hit), about
// log2(fences) dependent shared-memory probes and one L2 read. The
// latency of those reads is the cost, not the bytes. What the design does
// about it: the keys of a group are searched two at a time, so a thread
// keeps two reads in flight and stops at the first pair with a hit; the
// grid is one block per SM (or what occupancy allows), grid-striding over
// the words, so the fences are staged once a block, not once a word tile;
// no barrier sits in the search; a launch runs 256, 512 or 1024 threads
// a block, the fewest whose blocks take all its words in one wave, so a
// small launch spreads over more SMs and a large one has more warps to
// hide latency with.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_fences.cuh"
#include "stem_resident.cuh"

namespace {

using rt::kFenceThreads;
using rt::kMatchBank;
using rt::kMatchBsearch;

template <int MATCH, int N_GROUPS>
__global__ void __launch_bounds__(kFenceThreads)
stem_streamed_kernel(const int4* __restrict__ words, int n_words,
                     const int32_t* __restrict__ stream,
                     const int32_t* __restrict__ fences, rt::FenceLayout l,
                     int4* __restrict__ root, int32_t* __restrict__ source) {
  const int32_t* f = rt::stage_fences_begin(fences, l.n_fences);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t keys[rt::kSlots];
  uint32_t live = 0;
  if (i < n_words) live = rt::load_word_keys<N_GROUPS>(words, i, keys);
  rt::stage_end();
  for (; i < n_words; i += stride) {
    int32_t chosen, src;
    rt::search_word<MATCH, N_GROUPS>(keys, live, f, stream, l, chosen, src);
    rt::store_root(root, source, i, chosen, src);
    if (i + stride < n_words) {
      live = rt::load_word_keys<N_GROUPS>(words, i + stride, keys);
    }
  }
}

template <int MATCH, int N_GROUPS>
int launch(const int4* words, int n_words, const int32_t* stream,
           const int32_t* fences, const rt::FenceLayout& l, int4* root,
           int32_t* source, cudaStream_t s, int* grid_out) {
  auto kernel = stem_streamed_kernel<MATCH, N_GROUPS>;
  const size_t smem = sizeof(int32_t) * size_t(l.n_fences);
  int threads = 0, grid = 0;
  cudaError_t e = rt::allow_smem(kernel, smem);
  if (e == cudaSuccess) e = rt::fence_threads(n_words, &threads);
  if (e == cudaSuccess) {
    e = rt::resident_grid(kernel, threads, smem,
                          (n_words + threads - 1) / threads, &grid);
  }
  if (e != cudaSuccess) return int(e);
  if (grid_out) *grid_out = grid;
  kernel<<<grid, threads, smem, s>>>(words, n_words, stream, fences, l, root,
                                     source);
  return int(cudaGetLastError());
}

}  // namespace

// words int32[n_words, 16]; stream int32[(tri_tiles + quad_tiles +
// bi_tiles) * tile_n] (the DictTileSet stream); fences int32[n] with n =
// the three tables' ceil(tiles * tile_n / F), F = 1 << log2f (the
// DictTileSet fence level) -> root int32[n_words, 4], source
// int32[n_words]. words, stream and fences 16-byte aligned; the fences
// must fit one block's shared memory. *grid_out (if not null) gets the
// number of blocks launched. Launches on `s` and returns the CUDA error
// code (0 on success) of the launch.
extern "C" int stem_streamed_launch(const void* words, int n_words,
                                    const void* stream, const void* fences,
                                    int tri_tiles, int quad_tiles,
                                    int bi_tiles, int tile_n, int log2f,
                                    void* root, void* source, int n_groups,
                                    int match, void* s, int* grid_out) {
  if (n_words < 0 || tri_tiles < 1 || quad_tiles < 1 || bi_tiles < 1 ||
      tile_n < 128 || tile_n % 128 || log2f < 3 || log2f > 30 ||
      (n_groups != 2 && n_groups != 5) ||
      (match != kMatchBsearch && match != kMatchBank)) {
    return int(cudaErrorInvalidValue);
  }
  if (n_words == 0) return 0;
  const rt::FenceLayout l =
      rt::fence_layout(tri_tiles, quad_tiles, bi_tiles, tile_n, log2f);
  auto* w = static_cast<const int4*>(words);
  auto* st = static_cast<const int32_t*>(stream);
  auto* f = static_cast<const int32_t*>(fences);
  auto* r = static_cast<int4*>(root);
  auto* src = static_cast<int32_t*>(source);
  auto cs = static_cast<cudaStream_t>(s);
  if (match == kMatchBsearch) {
    return n_groups == 5
               ? launch<kMatchBsearch, 5>(w, n_words, st, f, l, r, src, cs,
                                          grid_out)
               : launch<kMatchBsearch, 2>(w, n_words, st, f, l, r, src, cs,
                                          grid_out);
  }
  return n_groups == 5
             ? launch<kMatchBank, 5>(w, n_words, st, f, l, r, src, cs,
                                     grid_out)
             : launch<kMatchBank, 2>(w, n_words, st, f, l, r, src, cs,
                                     grid_out);
}

extern "C" const char* stem_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
