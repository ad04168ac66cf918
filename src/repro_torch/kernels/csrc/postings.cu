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
// Three instances, picked by shape alone (pk::instance, postings.cuh):
//
// counting and sliced (postings_count_kernel, one kernel): a grid of
// (tile, slice of the tile's bins) blocks, one warp per 256 lanes. The
// counting instance is the one-slice case, for shapes whose uint16
// counters [warps][n_roots_pad] fit one block's shared memory (35.7 KB at
// block_w 2048 and the realistic 2232 bins); the sliced one cuts the row
// into slices of pk::kSliceCounters / warps bins (4096 at block_w 2048:
// 64 KB of counters a block, 3 blocks an SM), and a block takes
// pk::kSlicesPerBlock (4) of its tile's slices one after another, so at an
// index chunk of the 262,144-key vocabulary (64 tiles, 262,145 bins, 65
// slices) it runs 64 x 17 blocks. Each thread loads its 8 ids of the
// warp's lane run up front (8 coalesced loads in flight, from L2 for the
// sliced blocks that share a tile) while the block zeroes its counters
// once. Each warp then walks its run 32 lanes at a time: __ballot_sync
// of "in this slice" skips a group with no such lane; for the others,
// ballots of each of the id's low bits within the slice (12 at 4096 bins
// and at 2232) find the lanes with the same id (on the card, faster than
// __match_any_sync), the lowest of them reads and bumps the warp's
// counter for it and marks its quad of four bins in a bitmap,
// __shfl_sync hands the old count to its peers, and a lane's rank in the
// warp is that count plus its peers in lower lanes. After a barrier, the
// marked quads only are scanned down the warps (one 8-byte shared load
// and store a warp; warp 0's counters become the totals, the others the
// count in earlier warps); after another, the block writes its slice of
// hist[tile] from warp 0's counters densely and coalesced, zeros
// included, 16 bytes a thread between 16-byte boundaries, and each lane
// in the slice adds its warp's earlier count to its rank. Then the marked
// quads and the bitmap go back to 0 for the block's next slice. No sort,
// and ranks in lane order (no atomic decides one). An id outside [0,
// n_roots_pad), which the contract excludes, gets the plain version's
// answer from slice 0 alone: no histogram entry, and a rank counted by a
// loop over the earlier lanes of the tile.
//
// What bounds the sliced instance: the dense histogram it must write
// (67 MB at the 262,144-key index chunk, 0.020 ms at 3.35 TB/s). A
// 2048-lane tile has at most 2048 non-zero bins of 262,145, so the
// counting itself is small: each slice does it only for the groups that
// hold one of its ids, and scans only the quads they marked.
//
// bitonic (postings_kernel, unchanged from the sort-based design), for
// tiles past 8192 lanes, which the counting instances do not take: the
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

// Grid (n_tiles, pk::slice_blocks(n_slices)): block (t, y) counts bins
// [s * bins, + bins) of tile t for s = y, y + gridDim.y, ..., with
// pk::count_warps(block_w) warps; dynamic shared memory pk::slice_smem.
// (a minimum of one block an SM: without it ptxas keeps 32 registers and
// spills, and the kernel is 25-30% slower; chip_k5_slices.py)
__global__ void __launch_bounds__(pk::kMaxWarps * pk::kWarp, 1)
postings_count_kernel(const int32_t* __restrict__ ids,
                      int32_t* __restrict__ hist, int32_t* __restrict__ rank,
                      int block_w, int n_roots_pad, int bins, int n_slices) {
  extern __shared__ uint4 smem_counts[];
  uint16_t* counts = reinterpret_cast<uint16_t*>(smem_counts);
  const int warps = blockDim.x / pk::kWarp;
  // the bitmap of marked quads, after the counters (16-byte aligned)
  uint32_t* marked = reinterpret_cast<uint32_t*>(counts + warps * bins);
  const int words = pk::quad_words(bins);
  const int warp = threadIdx.x / pk::kWarp, lane = threadIdx.x % pk::kWarp;
  const int per_warp = block_w / warps;
  const int groups = (per_warp + pk::kWarp - 1) / pk::kWarp;
  const int width = per_warp < pk::kWarp ? per_warp : pk::kWarp;
  const bool live = lane < width;
  const size_t tile = blockIdx.x;
  const int32_t* tile_ids = ids + tile * block_w;
  const int first = warp * per_warp + lane;
  int32_t id[pk::kMaxGroups];
#pragma unroll
  for (int g = 0; g < pk::kMaxGroups; ++g) {
    id[g] = g < groups && live ? __ldg(tile_ids + first + pk::kWarp * g) : 0;
  }
  for (int q = threadIdx.x; q < warps * bins / 8; q += blockDim.x) {
    smem_counts[q] = make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < words; i += blockDim.x) marked[i] = 0;
  uint16_t* mine = counts + warp * bins;
  const uint32_t active = width == pk::kWarp ? 0xffffffffu
                                             : (1u << width) - 1u;
  int32_t* out = rank + tile * block_w;
  for (int s = blockIdx.y; s < n_slices; s += gridDim.y) {
    const int lo = s * bins;
    const int len = min(bins, n_roots_pad - lo);
    __syncthreads();                 // the counters and bitmap are all 0
    const int bits = pk::id_bits(len);
    int32_t rk[pk::kMaxGroups];
    if (live) {
#pragma unroll
      for (int g = 0; g < pk::kMaxGroups; ++g) {
        rk[g] = 0;
        if (g >= groups) continue;
        const bool in = pk::in_slice(id[g], lo, len);
        const uint32_t any = __ballot_sync(active, in);
        if (any == 0) continue;      // warp-uniform: no lane in the slice
        const uint32_t bin = pk::bin_of(id[g], lo);
        uint32_t peers = pk::narrow(active, any, in);
        for (int b = 0; b < bits; ++b) {
          const bool set = (bin >> b) & 1;
          peers = pk::narrow(peers, __ballot_sync(active, set), set);
        }
        const int leader = pk::lowest_lane(peers);
        uint32_t base = 0;
        if (lane == leader && in) {
          base = pk::bump(mine, bin, peers);
          pk::mark(marked, bin);
        }
        base = __shfl_sync(active, base, leader);
        rk[g] = pk::group_rank(base, peers, lane);
        __syncwarp(active);          // the counter's update before the next
      }
    }
    __syncthreads();
    // the marked quads down the warps, a warp a bitmap word at a time
    for (int w = warp; w < words; w += warps) {
      if (marked[w] >> lane & 1) {
        pk::scan_quad(counts, warps, bins, 4 * (pk::kWarp * w + lane));
      }
    }
    __syncthreads();
    // the slice of hist[tile] from warp 0's row, zeros included: 16-byte
    // stores between the 16-byte boundaries, single words before and after
    int32_t* h = hist + tile * n_roots_pad + lo;
    const int head = min(len, (4 - int(reinterpret_cast<uintptr_t>(h) & 15)
                                   / 4) & 3);
    const int tail = head + ((len - head) & ~3);
    if (int(threadIdx.x) < head) h[threadIdx.x] = counts[threadIdx.x];
    if (int(threadIdx.x) < len - tail) {
      h[tail + threadIdx.x] = counts[tail + threadIdx.x];
    }
    for (int r = head + 4 * threadIdx.x; r < tail; r += 4 * blockDim.x) {
      *reinterpret_cast<int4*>(h + r) = make_int4(
          counts[r], counts[r + 1], counts[r + 2], counts[r + 3]);
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < pk::kMaxGroups; ++g) {
        if (g < groups) {
          const int l = first + pk::kWarp * g;
          if (pk::in_slice(id[g], lo, len)) {
            out[l] = rk[g] + pk::earlier(counts, warp, bins,
                                         pk::bin_of(id[g], lo));
          } else if (s == 0 && !pk::counted(id[g], n_roots_pad)) {
            out[l] = pk::rank_by_scan(tile_ids, l, id[g]);
          }
        }
      }
    }
    if (s + gridDim.y < n_slices) {  // the marked quads back to 0
      __syncthreads();
      for (int w = warp; w < words; w += warps) {
        const uint32_t word = marked[w];
        if (word >> lane & 1) {
          pk::clear_quad(counts, warps, bins, 4 * (pk::kWarp * w + lane));
        }
        __syncwarp();
        if (lane == 0) marked[w] = 0;
      }
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

// The instance a launch of this shape takes: 0 bitonic, 1 counting, 2
// sliced.
extern "C" int postings_instance(int block_w, int n_roots_pad, int max_smem) {
  return pk::instance(block_w, n_roots_pad, size_t(max_smem));
}

// ids int32[n_tiles, block_w] (n_roots_pad - 1 is the drop bucket; the
// caller pads with it), block_w a power of two with n_roots_pad * block_w
// < 2^31 -> hist int32[n_tiles, n_roots_pad], rank int32[n_tiles,
// block_w]. max_smem is one block's shared-memory budget in bytes; it
// picks the instance (postings_instance). The bitonic instance takes ids
// in [0, n_roots_pad) (or any whose composite keys fit int32); the
// counting and sliced ones any int32. scratch is int32[n_tiles, block_w]
// when the bitonic instance runs and 4 * block_w exceeds max_smem (the
// keys then sort there), else unused and may be null. Launches on
// `stream` and returns the CUDA error code (0 on success) of the launch.
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
  const int inst = pk::instance(block_w, n_roots_pad, size_t(max_smem));
  if (inst != pk::kBitonic) {
    const int bins = pk::slice_bins(inst, block_w, n_roots_pad);
    const int n_slices = pk::slice_count(n_roots_pad, bins);
    const size_t smem = pk::slice_smem(block_w, bins);
    const cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(postings_count_kernel), smem);
    if (e != cudaSuccess) return int(e);
    const dim3 grid(unsigned(n_tiles), unsigned(pk::slice_blocks(n_slices)));
    postings_count_kernel<<<grid, pk::kWarp * pk::count_warps(block_w), smem,
                            s>>>(in, h, r, block_w, n_roots_pad, bins,
                                 n_slices);
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
