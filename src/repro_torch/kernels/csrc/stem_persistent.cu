// Persistent serving kernel for Hopper (sm_90a): one launch walks a ring of
// work descriptors, stages 1-5 per descriptor, and marks each done.
//
// Replaces repro/kernels/stem_fused.py:_persistent_resident_kernel and
// _persistent_streamed_kernel (with _persistent_io, _persistent_retire and
// the descriptor ring of _descriptors). Descriptor d is int32[3] in global
// memory: (row offset, n_visits, version slot). Its block_b-word tile runs
// stages 1-5, writes its root/source rows, and then flags[d] = 1 + its
// version slot, so the host can check that every tile ran under the
// dictionary version pinned at dispatch (0 = never processed).
//
// The reference's single grid step loops over descriptors in ring order.
// Here the grid is the blocks the card keeps resident (occupancy x SMs, at
// most the number of descriptors), and block j takes descriptors j,
// j + grid, ...: descriptors retire out of order. Every thread fences its
// output writes (__threadfence) before the barrier after which one thread
// writes the flag, so a flag that reads set proves its tile's rows.
//
// A block runs min(block_b, 512) threads, which stride over a
// descriptor's block_b-word tile (the streamed variant takes passes over
// wider tiles, stem_sweep.cuh).
//
// Two variants, as template instances:
//   - resident: the padded tables are staged into shared memory once per
//     block per launch (not once per tile, as the megakernel does), or
//     read from global memory past the shared-memory budget, by the same
//     dict_in_shared rule as K1 (stem_resident.cuh);
//   - streamed: each descriptor sweeps its own row of visit_idx, n_visits
//     long, through the cp.async ring of stem_sweep.cuh, as K2 does.
//
// What bounds it on an H100 is what bounds K1 and K2 per tile; what the
// persistent loop saves is launches (one a chunk of descriptors, not one
// per tile) and, for the resident variant, table copies: grid copies per
// launch rather than one per tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"
#include "stem_sweep.cuh"

namespace {

using rt::kMatchBank;
using rt::kMatchBsearch;
using rt::kMaxThreads;

// Publish descriptor d as done: every thread's output writes are fenced
// device-wide before the barrier, then one thread stores the flag.
__device__ __forceinline__ void retire(const int32_t* __restrict__ desc,
                                       int d, int32_t* flags) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t done = 1 + __ldg(desc + 3 * d + 2);
    *reinterpret_cast<volatile int32_t*>(flags + d) = done;
  }
}

template <int MATCH, bool SHARED, int N_GROUPS>
__global__ void __launch_bounds__(kMaxThreads)
persistent_resident_kernel(const int4* __restrict__ words, int n_words,
                           const int32_t* __restrict__ desc, int n_desc,
                           const int32_t* __restrict__ tri, int tri_n,
                           const int32_t* __restrict__ quad, int quad_n,
                           const int32_t* __restrict__ bi, int bi_n,
                           int4* __restrict__ root,
                           int32_t* __restrict__ source, int32_t* flags,
                           int block_b) {
  const int32_t* dict[3] = {tri, quad, bi};
  const int len[3] = {tri_n, quad_n, bi_n};
  if constexpr (SHARED) rt::stage_tables<N_GROUPS>(dict, len);
  int steps[3];
  rt::table_steps<MATCH, N_GROUPS>(len, steps);

  for (int d = blockIdx.x; d < n_desc; d += gridDim.x) {
    const long long tile0 = __ldg(desc + 3 * d);
    for (int w = threadIdx.x; w < block_b; w += blockDim.x) {
      const long long i = tile0 + w;
      if (i >= n_words) break;
      int32_t word[rt::kMaxLen];
      rt::load_word(words, i, n_words, word);
      int32_t chosen, src;
      rt::resident_word<MATCH, SHARED, N_GROUPS>(word, dict, len, steps,
                                                 chosen, src);
      rt::store_root(root, source, i, chosen, src);
    }
    retire(desc, d, flags);
  }
}

template <int MATCH, int N_GROUPS, int NB>
__global__ void __launch_bounds__(kMaxThreads)
persistent_streamed_kernel(const int4* __restrict__ words, int n_words,
                           const int32_t* __restrict__ desc, int n_desc,
                           const int32_t* __restrict__ stream, int n_tiles,
                           const int32_t* __restrict__ visit_idx,
                           int4* __restrict__ root,
                           int32_t* __restrict__ source, int32_t* flags,
                           int block_b, int tile_n, int tri_tiles,
                           int quad_tiles) {
  extern __shared__ int4 smem4[];
  int32_t* bufs = reinterpret_cast<int32_t*>(smem4);
  for (int d = blockIdx.x; d < n_desc; d += gridDim.x) {
    rt::streamed_tile<MATCH, N_GROUPS, NB>(
        words, n_words, __ldg(desc + 3 * d), block_b, stream,
        visit_idx + size_t(d) * n_tiles, __ldg(desc + 3 * d + 1), tile_n,
        tri_tiles, quad_tiles, bufs, root, source);
    retire(desc, d, flags);
  }
}

// Blocks of `kernel` the card keeps resident at once, at most n_desc.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                          int n_desc, int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms < n_desc ? per_sm * sms : n_desc;
  return cudaSuccess;
}

struct ResidentArgs {
  const int4* words;
  int n_words;
  const int32_t* desc;
  int n_desc;
  const int32_t* tri;
  int tri_n;
  const int32_t* quad;
  int quad_n;
  const int32_t* bi;
  int bi_n;
  int4* root;
  int32_t* source;
  int32_t* flags;
  int block_b;
  cudaStream_t stream;
  int* grid_out;
};

template <int MATCH, bool SHARED, int N_GROUPS>
int launch_resident(const ResidentArgs& a) {
  auto kernel = persistent_resident_kernel<MATCH, SHARED, N_GROUPS>;
  const size_t smem =
      rt::resident_smem_bytes<SHARED, N_GROUPS>(a.tri_n, a.quad_n, a.bi_n);
  const int threads = rt::block_threads(a.block_b);
  cudaError_t e = rt::allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess) e = resident_grid(kernel, threads, smem, a.n_desc,
                                          &grid);
  if (e != cudaSuccess) return int(e);
  if (a.grid_out) *a.grid_out = grid;
  kernel<<<grid, threads, smem, a.stream>>>(
      a.words, a.n_words, a.desc, a.n_desc, a.tri, a.tri_n, a.quad, a.quad_n,
      a.bi, a.bi_n, a.root, a.source, a.flags, a.block_b);
  return int(cudaGetLastError());
}

template <int MATCH, bool SHARED>
int resident_groups(const ResidentArgs& a, int n_groups) {
  return n_groups == 5 ? launch_resident<MATCH, SHARED, 5>(a)
                       : launch_resident<MATCH, SHARED, 2>(a);
}

template <int MATCH>
int resident_residency(const ResidentArgs& a, int n_groups, int shared) {
  return shared ? resident_groups<MATCH, true>(a, n_groups)
                : resident_groups<MATCH, false>(a, n_groups);
}

struct StreamedArgs {
  const int4* words;
  int n_words;
  const int32_t* desc;
  int n_desc;
  const int32_t* stream;
  int n_tiles;
  const int32_t* visit_idx;
  int4* root;
  int32_t* source;
  int32_t* flags;
  int block_b;
  int tile_n;
  int tri_tiles;
  int quad_tiles;
  cudaStream_t stream_;
  int* grid_out;
};

template <int MATCH, int N_GROUPS, int NB>
int launch_streamed(const StreamedArgs& a) {
  auto kernel = persistent_streamed_kernel<MATCH, N_GROUPS, NB>;
  const size_t smem = sizeof(int32_t) * size_t(NB) * a.tile_n;
  const int threads = rt::block_threads(a.block_b);
  cudaError_t e = rt::allow_smem(kernel, smem);
  int grid = 0;
  if (e == cudaSuccess) e = resident_grid(kernel, threads, smem, a.n_desc,
                                          &grid);
  if (e != cudaSuccess) return int(e);
  if (a.grid_out) *a.grid_out = grid;
  kernel<<<grid, threads, smem, a.stream_>>>(
      a.words, a.n_words, a.desc, a.n_desc, a.stream, a.n_tiles, a.visit_idx,
      a.root, a.source, a.flags, a.block_b, a.tile_n, a.tri_tiles,
      a.quad_tiles);
  return int(cudaGetLastError());
}

template <int MATCH, int N_GROUPS>
int streamed_buffers(const StreamedArgs& a, int num_buffers) {
  switch (num_buffers) {
    case 1: return launch_streamed<MATCH, N_GROUPS, 1>(a);
    case 2: return launch_streamed<MATCH, N_GROUPS, 2>(a);
    case 3: return launch_streamed<MATCH, N_GROUPS, 3>(a);
    default: return launch_streamed<MATCH, N_GROUPS, 4>(a);
  }
}

template <int MATCH>
int streamed_groups(const StreamedArgs& a, int n_groups, int num_buffers) {
  return n_groups == 5 ? streamed_buffers<MATCH, 5>(a, num_buffers)
                       : streamed_buffers<MATCH, 2>(a, num_buffers);
}

bool bad_common(int n_desc, int block_b, int n_groups, int match) {
  return n_desc < 0 || block_b < 1 ||
         (n_groups != 2 && n_groups != 5) ||
         (match != kMatchBsearch && match != kMatchBank);
}

}  // namespace

// words int32[n_words, 16]; desc int32[n_desc, 3] of (row offset,
// n_visits, version slot); tables as for stem_fused_launch -> root
// int32[n_words, 4], source int32[n_words] (rows of the descriptors' tiles
// below n_words), flags int32[n_desc] (1 + version slot once descriptor d
// has retired; the caller zeroes it). words and the tables 16-byte
// aligned. *grid_out (if not null) gets the number of blocks launched.
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int persistent_resident_launch(
    const void* words, int n_words, const void* desc, int n_desc,
    const void* tri, int tri_n, const void* quad, int quad_n, const void* bi,
    int bi_n, void* root, void* source, void* flags, int block_b,
    int n_groups, int match, int dict_in_shared, void* stream,
    int* grid_out) {
  if (bad_common(n_desc, block_b, n_groups, match)) {
    return int(cudaErrorInvalidValue);
  }
  if (n_desc == 0) return 0;
  const ResidentArgs a{static_cast<const int4*>(words),
                       n_words,
                       static_cast<const int32_t*>(desc),
                       n_desc,
                       static_cast<const int32_t*>(tri),
                       tri_n,
                       static_cast<const int32_t*>(quad),
                       quad_n,
                       static_cast<const int32_t*>(bi),
                       bi_n,
                       static_cast<int4*>(root),
                       static_cast<int32_t*>(source),
                       static_cast<int32_t*>(flags),
                       block_b,
                       static_cast<cudaStream_t>(stream),
                       grid_out};
  return match == kMatchBsearch
             ? resident_residency<kMatchBsearch>(a, n_groups, dict_in_shared)
             : resident_residency<kMatchBank>(a, n_groups, dict_in_shared);
}

// As persistent_resident_launch, with the dictionary as the DictTileSet
// stream (see stem_streamed_launch) and visit_idx int32[n_desc, n_tiles]:
// descriptor d sweeps the first desc[d][1] entries of row d.
extern "C" int persistent_streamed_launch(
    const void* words, int n_words, const void* desc, int n_desc,
    const void* stream, int n_tiles, const void* visit_idx, void* root,
    void* source, void* flags, int block_b, int dict_block_r,
    int num_buffers, int tri_tiles, int quad_tiles, int n_groups, int match,
    void* stream_, int* grid_out) {
  if (bad_common(n_desc, block_b, n_groups, match) || dict_block_r < 1 ||
      num_buffers < 1 || num_buffers > 4) {
    return int(cudaErrorInvalidValue);
  }
  if (n_desc == 0) return 0;
  const StreamedArgs a{static_cast<const int4*>(words),
                       n_words,
                       static_cast<const int32_t*>(desc),
                       n_desc,
                       static_cast<const int32_t*>(stream),
                       n_tiles,
                       static_cast<const int32_t*>(visit_idx),
                       static_cast<int4*>(root),
                       static_cast<int32_t*>(source),
                       static_cast<int32_t*>(flags),
                       block_b,
                       dict_block_r * 128,
                       tri_tiles,
                       quad_tiles,
                       static_cast<cudaStream_t>(stream_),
                       grid_out};
  return match == kMatchBsearch
             ? streamed_groups<kMatchBsearch>(a, n_groups, num_buffers)
             : streamed_groups<kMatchBank>(a, n_groups, num_buffers);
}

extern "C" const char* stem_persistent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
