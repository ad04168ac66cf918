// Standalone stemmer datapath for Hopper (sm_90a): stages 1-4 only, the
// candidates written to device memory for the staged Compare path.
//
// Replaces repro/kernels/stem_datapath.py:_datapath_kernel (behind
// stem_datapath_pallas). Per word: the 30 packed candidate keys and
// validity flags of stem_datapath.cuh (the functions K1 runs), written as
// two int32[32] rows, keys and valid (0/1), each with two zero pad
// columns: 64 B of word in, 256 B out.
//
// What bounds it on an H100: bytes. The datapath is about 430 int32
// operations a word, far under the card's rate for 320 B of traffic, and
// the 256 B written per word dominate: 335.5 MB at 1,048,576 words.
//
// What the design does about it: one thread per word computes its 30
// keys and flags in registers; the block stages its rows in shared memory
// (rows padded to 33 ints, so a warp's 32 row writes of one column fall
// in 32 banks) and stores each [rows, 32] tile as consecutive int32s, a
// warp writing 128 contiguous bytes. The pad columns are written as
// zeros here: the wrapper's outputs are uninitialised memory. block_b is
// the logical tile; a block runs min(block_b, 256) threads that take the
// tile in passes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"

namespace {

constexpr int kThreads = 256;     // threads a block at most
constexpr int kOut = 32;          // output columns: 30 slots + 2 pads
constexpr int kRow = kOut + 1;    // shared row stride, conflict-free

// One pass's rows of `vals` (this thread's row when it has a word) out to
// dst[row0 .. row0 + rows) through the shared tile.
template <typename T>
__device__ __forceinline__ void store_rows(int32_t* tile, const T* vals,
                                           bool has_word, int rows,
                                           int32_t* __restrict__ dst,
                                           long long row0) {
  if (has_word) {
    int32_t* row = tile + threadIdx.x * kRow;
#pragma unroll
    for (int s = 0; s < rt::kSlots; ++s) row[s] = int32_t(vals[s]);
    row[rt::kSlots] = 0;
    row[rt::kSlots + 1] = 0;
  }
  __syncthreads();
  int32_t* out = dst + row0 * kOut;
  for (int e = threadIdx.x; e < rows * kOut; e += blockDim.x) {
    out[e] = tile[(e / kOut) * kRow + (e % kOut)];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
stem_candidates_kernel(const int4* __restrict__ words, int n_words,
                       int32_t* __restrict__ keys,
                       int32_t* __restrict__ valid, int block_b) {
  __shared__ int32_t tile[kThreads * kRow];
  // the grid covers n_words, so base < n_words
  const long long base = (long long)blockIdx.x * block_b;
  const int rows = int(min((long long)block_b, n_words - base));
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {
    const int pass = min(int(blockDim.x), rows - r0);
    const bool has_word = int(threadIdx.x) < pass;
    int32_t k[rt::kSlots];
    bool v[rt::kSlots];
    if (has_word) {
      int32_t w[rt::kMaxLen];
      rt::load_word(words, base + r0 + threadIdx.x, n_words, w);
      rt::candidate_columns(w, k, v);
    }
    store_rows(tile, k, has_word, pass, keys, base + r0);
    store_rows(tile, v, has_word, pass, valid, base + r0);
  }
}

}  // namespace

// words int32[n_words, 16] (16-byte aligned) -> keys int32[n_words, 32],
// valid int32[n_words, 32]: the 30 candidate slots in stem_datapath.cuh's
// group order, then two zero columns. Launches on `stream` and returns
// the CUDA error code (0 on success) of the launch.
extern "C" int stem_candidates_launch(const void* words, int n_words,
                                      void* keys, void* valid, int block_b,
                                      void* stream) {
  if (n_words <= 0) return 0;
  if (block_b < 1) return int(cudaErrorInvalidValue);
  const unsigned grid = unsigned((n_words + (long long)block_b - 1) / block_b);
  const int threads = block_b < kThreads ? block_b : kThreads;
  stem_candidates_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(words), n_words, static_cast<int32_t*>(keys),
      static_cast<int32_t*>(valid), block_b);
  return int(cudaGetLastError());
}

extern "C" const char* stem_candidates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
