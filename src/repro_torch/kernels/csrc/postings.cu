// Postings reduction for Hopper (sm_90a): per word tile, the root
// histogram and each word's stable rank within its root.
//
// Replaces repro/kernels/postings.py:_postings_kernel (behind
// postings_pallas). One block per block_w-word tile (block_w a power of
// two): the composite keys id * block_w + lane go into shared memory,
// a bitonic network sorts them in place, then hist[tile, r] is the count
// of keys in bucket r (two lower-bound bisections per root, the drop
// bucket n_roots included) and rank[lane] is the key's sorted position
// minus its segment's start. The global half (cumsums and the postings
// scatter) stays in PyTorch, kernels/postings.py:finish_postings.
//
// What bounds it on an H100: neither bytes (4 B in and 4 B out a word,
// plus the histogram rows) nor operations, but the sort's barriers: the
// network has log2(block_w) * (log2(block_w) + 1) / 2 stages, 66 at
// block_w = 2048, each one compare-exchange a thread and a block-wide
// barrier, with one block of up to 1024 threads resident per tile.
//
// What the design does about it: the keys never leave shared memory
// between stages; block_w / 2 threads (at most 1024) each own
// block_w / (2 * blockDim) compare-exchanges a stage, so every stage is
// one barrier; the histogram and rank searches run on the sorted shared
// keys with no further barrier. A tile of block_w keys needs 4 * block_w
// bytes of shared memory, so tiles up to 32768 keys sort there. A wider
// tile (the reference takes any power of two whose composite keys fit
// int32) runs the same network, the same barriers and the same searches
// on its keys in a global-memory scratch row of its own (template flag
// GLOBAL): a 65,536-key tile is 256 KB and stays in the 50 MB L2, and a
// barrier orders global as well as shared accesses within the block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "postings.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// GLOBAL: the tile's keys live in scratch[tile * block_w, + block_w)
// instead of dynamic shared memory.
template <bool GLOBAL>
__global__ void __launch_bounds__(kMaxThreads)
postings_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ hist,
                int32_t* __restrict__ rank, int32_t* scratch, int block_w,
                int log_bw, int n_roots_pad) {
  extern __shared__ int32_t smem_keys[];
  const size_t tile = blockIdx.x;
  int32_t* keys = GLOBAL ? scratch + tile * block_w : smem_keys;
  const int32_t* tile_ids = ids + tile * block_w;
  for (int l = threadIdx.x; l < block_w; l += blockDim.x) {
    keys[l] = __ldg(tile_ids + l) * block_w + l;
  }
  __syncthreads();
  const int half = block_w >> 1;
  for (int k = 2; k <= block_w; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        pk::exchange(keys, k, j, p);
      }
      __syncthreads();
    }
  }
  int32_t* h = hist + tile * n_roots_pad;
  for (int r = threadIdx.x; r < n_roots_pad; r += blockDim.x) {
    h[r] = pk::bucket(keys, block_w, log_bw, r);
  }
  int32_t* rk = rank + tile * block_w;
  for (int p = threadIdx.x; p < block_w; p += blockDim.x) {
    int lane;
    int32_t r;
    pk::rank_of(keys, block_w, log_bw, p, &lane, &r);
    rk[lane] = r;
  }
}

}  // namespace

// ids int32[n_tiles, block_w] in [0, n_roots_pad) (n_roots_pad - 1 is the
// drop bucket; the caller pads with it), block_w a power of two with
// n_roots_pad * block_w < 2^31 -> hist int32[n_tiles, n_roots_pad], rank
// int32[n_tiles, block_w]. scratch is int32[n_tiles, block_w] when
// 4 * block_w exceeds max_smem bytes (the keys then sort there), else
// unused and may be null. Launches on `stream` and returns the CUDA error
// code (0 on success) of the launch.
extern "C" int postings_launch(const void* ids, int n_tiles, int block_w,
                               int n_roots_pad, void* hist, void* rank,
                               void* scratch, int max_smem, void* stream) {
  if (n_tiles <= 0) return 0;
  if (block_w < 1 || (block_w & (block_w - 1)) || n_roots_pad < 1 ||
      (long long)n_roots_pad * block_w >= (1ll << 31)) {
    return int(cudaErrorInvalidValue);
  }
  int log_bw = 0;
  while ((1 << log_bw) < block_w) ++log_bw;
  const int threads =
      block_w / 2 < 1 ? 1 : block_w / 2 < kMaxThreads ? block_w / 2
                                                      : kMaxThreads;
  const size_t tile_bytes = sizeof(int32_t) * size_t(block_w);
  const bool global = tile_bytes > size_t(max_smem);
  if (global && scratch == nullptr) return int(cudaErrorInvalidValue);
  auto kernel = global ? postings_kernel<true> : postings_kernel<false>;
  const size_t smem = global ? 0 : tile_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(hist),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(scratch), block_w,
      log_bw, n_roots_pad);
  return int(cudaGetLastError());
}

extern "C" const char* postings_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
