// Persistent serving kernel for Hopper (sm_90a): one launch walks a ring of
// work descriptors, stages 1-5 per descriptor, and marks each done.
//
// Replaces repro/kernels/stem_fused.py:_persistent_resident_kernel and
// _persistent_streamed_kernel (with _persistent_io, _persistent_retire and
// the descriptor ring of _descriptors). Descriptor d is int32[3] in global
// memory: (row offset, n_visits, version slot). Its block_b-word tile runs
// stages 1-5, writes its root/source rows, and then flags[d] = 1 + its
// version slot, so the host can check that every tile ran under the
// dictionary version pinned at dispatch (0 = never processed). n_visits
// is the reference's; no variant here reads it.
//
// The reference's single grid step loops over descriptors in ring order.
// Here the grid is the blocks the card keeps resident (occupancy x SMs, at
// most what the descriptors need), and blocks stride over the ring:
// descriptors retire out of order. Every thread fences its output writes
// (__threadfence) before the barrier after which the flags are written,
// and the writing warp fences at system scope before its volatile flag
// stores, so a flag that reads set proves its tile's rows, also to a host
// thread. The flags may be host-mapped pinned memory
// (persistent_flags_alloc): the serving ring's watchdog reads them without
// a sync while the launch runs. A tile cut into pieces counts them down in
// a device-memory array (counts), never in the flag: device atomics on
// mapped host memory are not guaranteed over PCIe.
//
// Two variants, as template instances:
//   - resident: the megakernel's body (stem_resident.cuh) over the ring,
//     with a retire after each item: a word's live slots split across G
//     lanes (G picked per launch), the padded tables staged into shared
//     memory with cp.async once a resident block (or read from global
//     memory past the shared-memory budget, by the same dict_in_shared
//     rule as K1), blocks taking several descriptors a round (one fence
//     and one barrier a round) or, at G lanes a word, a piece of one: a
//     256-word tile at the serve shape's G = 8 is 8 pieces on 8 blocks,
//     and its last piece to arrive writes its flag;
//   - streamed: the fence level of the tile stream is staged into shared
//     memory once per block per launch, and every live key is searched
//     from it, as K2 does (stem_fences.cuh). A block runs 256, 512 or
//     1024 threads (as K2 picks them, by the ring's words) and takes
//     threads / block_b descriptors at a time while tiles are narrower
//     than that (one descriptor, strided, otherwise), so narrow tiles do
//     not leave threads idle, and up to 4x as many on a long ring; the
//     barrier before the flags is the only one in the loop.
//
// What bounds it on an H100 is what bounds K1 and K2 per word; what the
// persistent loop saves is launches (one a chunk of descriptors, not one
// per tile) and staging: grid copies of the tables or fences per launch
// rather than one per tile.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "stem_fences.cuh"
#include "stem_resident.cuh"

namespace {

using rt::kFenceThreads;
using rt::kMatchBank;
using rt::kMatchBsearch;

template <int MATCH, int N_GROUPS>
__global__ void __launch_bounds__(kFenceThreads)
persistent_streamed_kernel(const int4* __restrict__ words, int n_words,
                           const int32_t* __restrict__ desc, int n_desc,
                           const int32_t* __restrict__ stream,
                           const int32_t* __restrict__ fences,
                           rt::FenceLayout l, int4* __restrict__ root,
                           int32_t* __restrict__ source, int32_t* flags,
                           int block_b, int per) {
  const int32_t* f = rt::stage_fences_begin(fences, l.n_fences);
  // row of word w of the round at descriptor d0 (-1 past the words)
  auto row = [&](int d0, int w) -> long long {
    const int d = d0 + w / block_b;
    const long long i = (long long)__ldg(desc + 3 * d) + w % block_b;
    return i < n_words ? i : -1;
  };
  // the thread's first word goes through stages 1-4 during the copy
  int32_t keys[rt::kSlots];
  uint32_t live = 0;
  const int first_d0 = blockIdx.x * per;
  long long ready = -1;
  if (first_d0 < n_desc &&
      int(threadIdx.x) < min(per, n_desc - first_d0) * block_b) {
    ready = row(first_d0, threadIdx.x);
    if (ready >= 0) live = rt::load_word_keys<N_GROUPS>(words, ready, keys);
  }
  rt::stage_end();
  for (int d0 = first_d0; d0 < n_desc; d0 += gridDim.x * per) {
    const int nd = min(per, n_desc - d0);
    for (int w = threadIdx.x; w < nd * block_b; w += blockDim.x) {
      const long long i = row(d0, w);
      if (i < 0) continue;
      if (i != ready) live = rt::load_word_keys<N_GROUPS>(words, i, keys);
      ready = -1;
      int32_t chosen, src;
      rt::search_word<MATCH, N_GROUPS>(keys, live, f, stream, l, chosen,
                                       src);
      rt::store_root(root, source, i, chosen, src);
    }
    rt::retire(desc, d0, nd, 1, nullptr, flags);
  }
}

struct StreamedArgs {
  const int4* words;
  int n_words;
  const int32_t* desc;
  int n_desc;
  const int32_t* stream;
  const int32_t* fences;
  rt::FenceLayout layout;
  int4* root;
  int32_t* source;
  int32_t* flags;
  int block_b;
  cudaStream_t stream_;
  int* grid_out;
};

template <int MATCH, int N_GROUPS>
int launch_streamed(const StreamedArgs& a) {
  auto kernel = persistent_streamed_kernel<MATCH, N_GROUPS>;
  const size_t smem = sizeof(int32_t) * size_t(a.layout.n_fences);
  int threads = 0, capacity = 0;
  cudaError_t e = rt::allow_smem(kernel, smem);
  if (e == cudaSuccess) {
    e = rt::fence_threads((long long)a.n_desc * a.block_b, &threads);
  }
  if (e == cudaSuccess) {
    e = rt::resident_grid(kernel, threads, smem, INT_MAX, &capacity);
  }
  if (e != cudaSuccess) return int(e);
  // Descriptors a block takes at a time: enough words for its threads,
  // and up to kMaxRounds times that while the ring holds more than the
  // resident blocks take in one round. A round ends in a barrier that
  // waits for its slowest word, so fewer, longer rounds lose less.
  const int base = a.block_b < threads ? threads / a.block_b : 1;
  const int rounds = (a.n_desc + base - 1) / base / capacity;
  const int per =
      base * (rounds < 1 ? 1 : rounds > rt::kMaxRounds ? rt::kMaxRounds
                                                       : rounds);
  const int need = (a.n_desc + per - 1) / per;
  const int grid = capacity < need ? capacity : need;
  if (a.grid_out) *a.grid_out = grid;
  kernel<<<grid, threads, smem, a.stream_>>>(
      a.words, a.n_words, a.desc, a.n_desc, a.stream, a.fences, a.layout,
      a.root, a.source, a.flags, a.block_b, per);
  return int(cudaGetLastError());
}

template <int MATCH>
int streamed_groups(const StreamedArgs& a, int n_groups) {
  return n_groups == 5 ? launch_streamed<MATCH, 5>(a)
                       : launch_streamed<MATCH, 2>(a);
}

bool bad_common(int n_desc, int block_b, int n_groups, int match) {
  return n_desc < 0 || rt::bad_resident(block_b, n_groups, match);
}

}  // namespace

// words int32[n_words, 16]; desc int32[n_desc, 3] of (row offset,
// n_visits, version slot); tables as for stem_fused_launch -> root
// int32[n_words, 4], source int32[n_words] (rows of the descriptors' tiles
// below n_words), flags int32[n_desc] (1 + version slot once descriptor d
// has retired, 0 before; the caller zeroes it; device or host-mapped
// memory, through its device pointer). counts int32[n_desc] in device
// memory, zeroed by the caller: a descriptor cut into pieces counts them
// down there. words and the tables 16-byte aligned. *grid_out (if not
// null) gets the number of blocks launched. Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int persistent_resident_launch(
    const void* words, int n_words, const void* desc, int n_desc,
    const void* tri, int tri_n, const void* quad, int quad_n, const void* bi,
    int bi_n, void* root, void* source, void* flags, void* counts,
    int block_b, int n_groups, int match, int dict_in_shared, void* stream,
    int* grid_out) {
  if (bad_common(n_desc, block_b, n_groups, match)) {
    return int(cudaErrorInvalidValue);
  }
  if (n_desc == 0) return 0;
  const rt::ResidentArgs a{static_cast<const int4*>(words),
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
                           static_cast<int32_t*>(counts),
                           static_cast<int32_t*>(flags),
                           block_b,
                           static_cast<cudaStream_t>(stream)};
  const int e = rt::dispatch_resident<true>(a, n_groups, match,
                                            dict_in_shared);
  if (e == 0 && grid_out) *grid_out = rt::last_shape().grid;
  return e;
}

// The lanes a word, blocks and resident-block capacity the calling
// thread's last persistent_resident_launch took.
extern "C" void persistent_resident_last_shape(int* lanes, int* grid,
                                               int* capacity) {
  const rt::LaunchShape& s = rt::last_shape();
  *lanes = s.lanes;
  *grid = s.grid;
  *capacity = s.capacity;
}

// As persistent_resident_launch, with the dictionary as the DictTileSet
// stream and its fence level (see stem_streamed_launch); desc[d][1] is
// not read.
extern "C" int persistent_streamed_launch(
    const void* words, int n_words, const void* desc, int n_desc,
    const void* stream, const void* fences, int tri_tiles, int quad_tiles,
    int bi_tiles, int tile_n, int log2f, void* root, void* source,
    void* flags, int block_b, int n_groups, int match, void* stream_,
    int* grid_out) {
  if (bad_common(n_desc, block_b, n_groups, match) || tri_tiles < 1 ||
      quad_tiles < 1 || bi_tiles < 1 || tile_n < 128 || tile_n % 128 ||
      log2f < 3 || log2f > 30) {
    return int(cudaErrorInvalidValue);
  }
  if (n_desc == 0) return 0;
  const StreamedArgs a{
      static_cast<const int4*>(words),
      n_words,
      static_cast<const int32_t*>(desc),
      n_desc,
      static_cast<const int32_t*>(stream),
      static_cast<const int32_t*>(fences),
      rt::fence_layout(tri_tiles, quad_tiles, bi_tiles, tile_n, log2f),
      static_cast<int4*>(root),
      static_cast<int32_t*>(source),
      static_cast<int32_t*>(flags),
      block_b,
      static_cast<cudaStream_t>(stream_),
      grid_out};
  return match == kMatchBsearch ? streamed_groups<kMatchBsearch>(a, n_groups)
                                : streamed_groups<kMatchBank>(a, n_groups);
}

// n int32 flags in pinned host memory mapped into the device's address
// space: *host the host pointer, *dev the pointer a kernel writes through.
// Returns the CUDA error code (0 on success); free with
// persistent_flags_free.
extern "C" int persistent_flags_alloc(int n, void** host, void** dev) {
  *host = nullptr;
  *dev = nullptr;
  if (n < 1) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaHostAlloc(host, sizeof(int32_t) * size_t(n),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return int(e);
  e = cudaHostGetDevicePointer(dev, *host, 0);
  if (e != cudaSuccess) {
    cudaFreeHost(*host);
    *host = nullptr;
  }
  return int(e);
}

extern "C" int persistent_flags_free(void* host) {
  return int(cudaFreeHost(host));
}

extern "C" const char* stem_persistent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
