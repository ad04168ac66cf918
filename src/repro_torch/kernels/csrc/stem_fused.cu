// Stemmer megakernel for Hopper (sm_90a): stages 1-5 in one launch.
//
// Replaces repro/kernels/stem_fused.py:_fused_kernel (the resident,
// non-persistent Pallas kernel behind stem_fused_pallas). Per word: the
// 30 packed candidate keys and validity flags of stem_datapath.cuh, a
// membership test of each live key against its group's table (branchless
// binary search, or a linear comparator-bank scan), and the first hit in
// slot order unpacked into (root[4], source).
//
// What bounds it on an H100: device traffic is small, 64 B of word in and
// 20 B of (root, source) out, 84 B a word, which is the bound at 1M words
// (0.026 ms). The work is integer issue (stages 1-4, some 450 operations
// a word) and dependent table probes, ceil(log2 Rp) + 1 a live slot
// searched (12 for the realistic 2048-entry tri table). At a 4096-word
// serve launch the card is nearly idle: what costs is latency, the
// launch, the staging of the tables and a block's slowest word.
//
// What the design does about it (stem_resident.cuh, whose kernel body
// the persistent kernel's resident variant shares): a word's live slots
// split across G lanes searched in rounds with a group vote, G picked per
// launch so that a small launch spreads over the card's SMs (8 lanes a
// word, 128 blocks, at a 4096-word serve launch); the tables staged into
// shared memory with cp.async while each thread's word goes through
// stages 1-4; the words one tile (block_b only groups them), a block a
// pass of 256 / G words with no walk arithmetic and no loop, which keeps
// a one-lane word at 40 registers (6 blocks an SM) for large launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"

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
  if (rt::bad_resident(block_b, n_groups, match)) {
    return int(cudaErrorInvalidValue);
  }
  // the words are one tile: block_b only groups them (fused_walk)
  const rt::ResidentArgs a{static_cast<const int4*>(words),
                           n_words,
                           nullptr,
                           1,
                           static_cast<const int32_t*>(tri),
                           tri_n,
                           static_cast<const int32_t*>(quad),
                           quad_n,
                           static_cast<const int32_t*>(bi),
                           bi_n,
                           static_cast<int4*>(root),
                           static_cast<int32_t*>(source),
                           nullptr,
                           nullptr,
                           n_words,
                           static_cast<cudaStream_t>(stream)};
  return rt::dispatch_resident<false>(a, n_groups, match, dict_in_shared);
}

// The lanes a word and blocks the calling thread's last launch took (and
// 0 for the resident-block capacity, which K1, a block an item, does not
// ask for).
extern "C" void stem_fused_last_shape(int* lanes, int* grid, int* capacity) {
  const rt::LaunchShape& s = rt::last_shape();
  *lanes = s.lanes;
  *grid = s.grid;
  *capacity = s.capacity;
}

extern "C" const char* stem_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
