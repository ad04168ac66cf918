// Postings reduction for Hopper (sm_90a): per word tile, the root
// histogram and each word's stable rank within its root.
//
// Replaces repro/kernels/postings.py:_postings_kernel (behind
// postings_pallas). What it computes is simpler than the reference's
// sort: hist[tile, r] is the count of id r in the tile, and rank[lane] is
// the number of earlier lanes of the tile with the same id. The global
// half (cumsums and the postings scatter) stays in PyTorch,
// kernels/postings.py:finish_postings.
//
// What bounds it on an H100: bytes. The function needs each id read once
// and each rank and histogram entry written once, about 4 int32
// operations a word and 2 a bin (O(block_w + n_roots) a tile): at 512
// tiles of 2048 words and 2232 bins, 12.9 MB and 0.0039 ms.
//
// Two instances, picked by shape alone (pk::instance, postings.cuh):
//
// counting (postings_count_kernel): one block a tile, one warp per 256
// lanes. Each thread loads its 8 ids of the warp's lane run up front (8
// coalesced loads in flight), while the block zeroes uint16 counters
// [warps][n_roots_pad] in shared memory (35.7 KB at block_w 2048 and the
// realistic 2232 bins). Each warp then walks its run 32 lanes at a time:
// __ballot_sync of the counted flag and of each of the id's 12 low bits
// (at 2232 bins) finds the lanes with the same id (on the card, faster
// than __match_any_sync), the lowest of them reads and bumps the warp's
// counter for it, __shfl_sync hands the old count to its peers, and a
// lane's rank in the warp is that count plus its peers in lower lanes.
// After a barrier, one thread a bin scans the bin down the warps (the
// total is hist[tile, r], written coalesced; each warp's counter becomes
// the count in earlier warps), and after another each lane adds its
// warp's count to its rank. Three barriers a tile, no
// sort, and ranks in lane order (no atomic decides one). An id outside [0,
// n_roots_pad), which the contract excludes, gets the plain version's
// answer: no histogram entry, and a rank counted by a loop over the
// earlier lanes of the tile.
//
// bitonic (postings_kernel, unchanged from the sort-based design), for
// shapes whose counters do not fit one block's shared memory (vocabularies
// past ~14,500 roots at block_w 2048) or tiles past 8192 lanes: the
// composite keys id * block_w + lane go into shared memory, a bitonic
// network sorts them in place (log2(block_w) * (log2(block_w) + 1) / 2
// stages, each one compare-exchange a thread and a block-wide barrier),
// then hist[tile, r] is the count of keys in bucket r (two lower-bound
// bisections per root) and rank[lane] is the key's sorted position minus
// its segment's start. A tile of more than 32,768 keys (the reference
// takes any power of two whose composite keys fit int32) sorts in a
// global-memory scratch row of its own (template flag GLOBAL); a 65,536-key
// tile is 256 KB and stays in the 50 MB L2.
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

// One block of pk::count_warps(block_w) warps a tile.
__global__ void __launch_bounds__(pk::kMaxWarps * pk::kWarp)
postings_count_kernel(const int32_t* __restrict__ ids,
                      int32_t* __restrict__ hist, int32_t* __restrict__ rank,
                      int block_w, int n_roots_pad) {
  extern __shared__ uint4 smem_counts[];
  uint16_t* counts = reinterpret_cast<uint16_t*>(smem_counts);
  const int warps = blockDim.x / pk::kWarp;
  const int warp = threadIdx.x / pk::kWarp, lane = threadIdx.x % pk::kWarp;
  const int per_warp = block_w / warps;
  const int groups = (per_warp + pk::kWarp - 1) / pk::kWarp;
  const int width = per_warp < pk::kWarp ? per_warp : pk::kWarp;
  const bool live = lane < width;
  const int stride = pk::count_stride(n_roots_pad);
  const size_t tile = blockIdx.x;
  const int32_t* tile_ids = ids + tile * block_w;
  const int first = warp * per_warp + lane;
  int32_t id[pk::kMaxGroups];
#pragma unroll
  for (int g = 0; g < pk::kMaxGroups; ++g) {
    id[g] = g < groups && live ? __ldg(tile_ids + first + pk::kWarp * g) : 0;
  }
  for (int q = threadIdx.x; q < warps * stride / 8; q += blockDim.x) {
    smem_counts[q] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  uint16_t* mine = counts + warp * stride;
  const uint32_t active = width == pk::kWarp ? 0xffffffffu
                                             : (1u << width) - 1u;
  const int bits = pk::id_bits(n_roots_pad);
  int32_t rk[pk::kMaxGroups];
  if (live) {
#pragma unroll
    for (int g = 0; g < pk::kMaxGroups; ++g) {
      if (g < groups) {
        const bool ok = pk::counted(id[g], n_roots_pad);
        uint32_t peers = pk::narrow(active, __ballot_sync(active, ok), ok);
        for (int b = 0; b < bits; ++b) {
          const bool set = (id[g] >> b) & 1;
          peers = pk::narrow(peers, __ballot_sync(active, set), set);
        }
        const int leader = pk::lowest_lane(peers);
        uint32_t base = 0;
        if (lane == leader && ok) base = pk::bump(mine, id[g], peers);
        base = __shfl_sync(active, base, leader);
        rk[g] = pk::group_rank(base, peers, lane);
        __syncwarp(active);          // the counter's update before the next
      }
    }
  }
  __syncthreads();
  int32_t* h = hist + tile * n_roots_pad;
  for (int r = threadIdx.x; r < n_roots_pad; r += blockDim.x) {
    h[r] = pk::scan_bin(counts, warps, stride, r);
  }
  __syncthreads();
  if (!live) return;
  int32_t* out = rank + tile * block_w;
#pragma unroll
  for (int g = 0; g < pk::kMaxGroups; ++g) {
    if (g < groups) {
      const int l = first + pk::kWarp * g;
      out[l] = pk::counted(id[g], n_roots_pad)
                   ? rk[g] + mine[id[g]]
                   : pk::rank_by_scan(tile_ids, l, id[g]);
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

// The instance a launch of this shape takes: 1 counting, 0 bitonic.
extern "C" int postings_instance(int block_w, int n_roots_pad, int max_smem) {
  return pk::instance(block_w, n_roots_pad, size_t(max_smem));
}

// ids int32[n_tiles, block_w] (n_roots_pad - 1 is the drop bucket; the
// caller pads with it), block_w a power of two with n_roots_pad * block_w
// < 2^31 -> hist int32[n_tiles, n_roots_pad], rank int32[n_tiles,
// block_w]. max_smem is one block's shared-memory budget in bytes; it
// picks the instance (postings_instance). The bitonic instance takes ids
// in [0, n_roots_pad) (or any whose composite keys fit int32); the
// counting one any int32. scratch is int32[n_tiles, block_w] when the
// bitonic instance runs and 4 * block_w exceeds max_smem (the keys then
// sort there), else unused and may be null. Launches on `stream` and
// returns the CUDA error code (0 on success) of the launch.
extern "C" int postings_launch(const void* ids, int n_tiles, int block_w,
                               int n_roots_pad, void* hist, void* rank,
                               void* scratch, int max_smem, void* stream) {
  if (n_tiles <= 0) return 0;
  if (block_w < 1 || (block_w & (block_w - 1)) || n_roots_pad < 1 ||
      (long long)n_roots_pad * block_w >= (1ll << 31)) {
    return int(cudaErrorInvalidValue);
  }
  const auto* in = static_cast<const int32_t*>(ids);
  auto* h = static_cast<int32_t*>(hist);
  auto* r = static_cast<int32_t*>(rank);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pk::instance(block_w, n_roots_pad, size_t(max_smem)) == pk::kCounting) {
    const size_t smem = pk::count_smem(block_w, n_roots_pad);
    const cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(postings_count_kernel), smem);
    if (e != cudaSuccess) return int(e);
    postings_count_kernel<<<n_tiles, pk::kWarp * pk::count_warps(block_w),
                            smem, s>>>(in, h, r, block_w, n_roots_pad);
    return int(cudaGetLastError());
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
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<n_tiles, threads, smem, s>>>(in, h, r,
                                        static_cast<int32_t*>(scratch),
                                        block_w, log_bw, n_roots_pad);
  return int(cudaGetLastError());
}

extern "C" const char* postings_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
