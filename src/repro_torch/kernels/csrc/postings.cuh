// The postings kernel's per-tile steps, shared by the CUDA kernel
// (postings.cu, K5) and a host build the CPU tests check bit for bit
// against the plain version (kernels/postings.py).
//
// Three instances, picked by shape alone (instance() below):
//
//   counting  per tile a warp-by-warp count of the ids in shared-memory
//             counters: a word's rank is the number of earlier words in
//             its tile with its id, a bin's total is the histogram entry.
//             No sort, O(block_w + n_roots) work a tile.
//   sliced    the same count, one block per (tile, slice of the bins):
//             each block counts only the ids in its slice, so the
//             counters of a vocabulary too large for one block's shared
//             memory are split over many blocks. The counting instance
//             is its one-slice case.
//   bitonic   counterpart of repro/kernels/postings.py:_bitonic_sort,
//             _lower_bound and the body of _postings_kernel: block_w (a
//             power of two) composite keys id * block_w + lane are sorted;
//             they are unique, so the rank of a word within its root
//             segment is its key's sorted position minus the segment's
//             start. For tiles wider than the counting instances take.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PK_HD __host__ __device__ __forceinline__
#else
#define PK_HD inline
#endif

namespace pk {

// ---------------------------------------------------------------------------
// the bitonic instance
// ---------------------------------------------------------------------------

// Compare-exchange p (0 <= p < n / 2) of the bitonic stage (k, j), j a
// power of two below k: the pair is (i, i + j) with bit j of i clear; the
// run is ascending when bit k of i is clear.
PK_HD void exchange(int32_t* keys, int k, int j, int p) {
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int32_t a = keys[i], b = keys[i + j];
  if ((a > b) == ((i & k) == 0)) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

// Count of the n sorted keys strictly below q (n a power of two): log2 n
// branchless bisection steps, then one adjust, as _lower_bound does.
PK_HD int lower_bound(const int32_t* keys, int n, int log_n, int32_t q) {
  int lo = 0, hi = n - 1;
  for (int s = 0; s < log_n; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool ge = keys[mid] >= q;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  return lo + (keys[lo] < q);
}

// Per-tile histogram entry r: keys in [r * n, (r + 1) * n).
PK_HD int32_t bucket(const int32_t* keys, int n, int log_n, int r) {
  return lower_bound(keys, n, log_n, (r + 1) * n) -
         lower_bound(keys, n, log_n, r * n);
}

// The sorted key at position p -> (its lane, its rank in its segment).
PK_HD void rank_of(const int32_t* keys, int n, int log_n, int p, int* lane,
                   int32_t* rank) {
  const int32_t key = keys[p];
  *lane = key & (n - 1);
  *rank = p - lower_bound(keys, n, log_n, (key >> log_n) * n);
}

// ---------------------------------------------------------------------------
// the counting and sliced instances
// ---------------------------------------------------------------------------
//
// A block counts one slice of a tile's bins at a time, [lo, lo + len):
// the whole row (counting) or slice_bins() of it (sliced). A tile's lanes
// are split into `warps` contiguous runs of per_warp = block_w / warps
// lanes; warp w walks its run 32 lanes (a group) at a time, in lane order,
// and keeps uint16 counters[w][id - lo] in shared memory (a row of `bins`
// counters a warp). A group with no lane in the slice is skipped after
// one ballot. Within the others, the lanes holding one id (its peers,
// found by that ballot and one of each of the id's id_bits(len) low bits
// within the slice) take consecutive ranks after the counter, and the
// lowest of them adds their number to it and marks the bin's quad (four
// bins) in a bitmap. After a barrier, each marked quad is scanned down the
// warps: each warp's counter but warp 0's becomes the count in earlier
// warps, which its lanes add to their ranks, and warp 0's becomes the
// bin's total, the histogram entry (an unmarked quad's are all 0). So
// ranks follow lane order and no atomic decides one. Before the block's
// next slice, the marked quads and the bitmap are cleared again.

constexpr int kWarp = 32;
constexpr int kLanesPerWarp = 256;          // 8 groups a warp, in registers
constexpr int kMaxGroups = kLanesPerWarp / kWarp;
constexpr int kMaxWarps = 32;               // 1024 threads
// the widest tile whose ids and ranks a block holds in registers
constexpr int kCountMaxBlockW = kMaxWarps * kLanesPerWarp;   // 8192
// a sliced block's counters: 64 KB, 3 blocks an SM. Fewer slices, each a
// block-wide pass behind barriers, beat more resident blocks: on the H100
// this is faster than 32 and 48 KB (chip_k5_slices.py)
constexpr int kSliceCounters = 32768;
// slices a block takes one after another, its tile's ids loaded and its
// counters zeroed once for them (faster than 1, 2 and 8, the same script)
constexpr int kSlicesPerBlock = 4;

enum Instance { kBitonic = 0, kCounting = 1, kSliced = 2 };

// Warps of a counting block: one per 256 lanes, one for narrower tiles.
PK_HD int count_warps(int block_w) {
  return block_w >= kLanesPerWarp ? block_w / kLanesPerWarp : 1;
}

// Counters a warp's row holds: n_roots_pad rounded up to 8 (16-byte rows).
PK_HD int count_stride(int n_roots_pad) { return (n_roots_pad + 7) & ~7; }

// Words of the bitmap of marked quads of a slice of `bins` bins.
PK_HD int quad_words(int bins) { return (bins / 4 + 31) / 32; }

// Blocks a tile's n_slices slices take: kSlicesPerBlock slices a block,
// at most 65,535 (a grid's y extent).
PK_HD int slice_blocks(int n_slices) {
  const int blocks = (n_slices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  return blocks < 65535 ? blocks : 65535;
}

// Shared-memory bytes of a block's counters, `bins` a warp, and its
// bitmap.
PK_HD size_t slice_smem(int block_w, int bins) {
  return sizeof(uint16_t) * size_t(count_warps(block_w)) * size_t(bins) +
         sizeof(uint32_t) * size_t(quad_words(bins));
}

// Shared-memory bytes of the counters of a whole block_w tile.
PK_HD size_t count_smem(int block_w, int n_roots_pad) {
  return slice_smem(block_w, count_stride(n_roots_pad));
}

// The instance a (block_w, n_roots_pad) launch takes, by shape alone:
// counting while block_w <= kCountMaxBlockW and the whole row's counters
// fit max_smem bytes, sliced for the other tiles up to kCountMaxBlockW,
// bitonic past it.
PK_HD int instance(int block_w, int n_roots_pad, size_t max_smem) {
  if (block_w > kCountMaxBlockW) return kBitonic;
  return count_smem(block_w, n_roots_pad) <= max_smem ? kCounting : kSliced;
}

// Bins a block of a counting or sliced launch counts (a multiple of 8):
// the whole row, or kSliceCounters over the warps.
PK_HD int slice_bins(int inst, int block_w, int n_roots_pad) {
  return inst == kCounting ? count_stride(n_roots_pad)
                           : kSliceCounters / count_warps(block_w);
}

// Slices of a row of n_roots_pad bins, `bins` a slice.
PK_HD int slice_count(int n_roots_pad, int bins) {
  return int((static_cast<long long>(n_roots_pad) + bins - 1) / bins);
}

// ids outside [0, n_roots_pad) have no counter and no histogram entry.
PK_HD bool counted(int32_t id, int n_roots_pad) {
  return uint32_t(id) < uint32_t(n_roots_pad);
}

// An id's bin within the slice that starts at lo, wrapped for ids below lo
// (no signed overflow, any int32 id).
PK_HD uint32_t bin_of(int32_t id, int lo) {
  return uint32_t(id) - uint32_t(lo);
}

// Whether id falls in the slice [lo, lo + len) (0 <= lo, lo + len <=
// n_roots_pad < 2^31): one unsigned compare, any int32 id.
PK_HD bool in_slice(int32_t id, int lo, int len) {
  return bin_of(id, lo) < uint32_t(len);
}

// Bits an id within a slice of len bins has: ceil(log2(len)).
PK_HD int id_bits(int len) {
  int bits = 0;
  while ((1 << bits) < len) ++bits;
  return bits;
}

// One step of finding a lane's peers: keep the lanes of `ballot` (the
// lanes whose predicate is set) if the lane's own predicate is set, else
// the others. Starting from the active lanes, the in-slice flag's step
// and one step for each of the id's id_bits low bits within the slice
// leave, for an id in the slice, exactly the lanes with that id (any
// other id gets lanes with its low bits, which only decide its leader).
PK_HD uint32_t narrow(uint32_t peers, uint32_t ballot, bool set) {
  return peers & (set ? ballot : ~ballot);
}

PK_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The lowest lane of a non-empty mask.
PK_HD int lowest_lane(uint32_t mask) {
#ifdef __CUDA_ARCH__
  return __ffs(mask) - 1;
#else
  return __builtin_ctz(mask);
#endif
}

// The group leader's step for an id in the slice (its bin_of): the
// warp's counter grows by the number of peers; -> the counter before, the
// rank of the first peer.
PK_HD uint32_t bump(uint16_t* warp_counts, uint32_t bin, uint32_t peers) {
  const uint32_t before = warp_counts[bin];
  warp_counts[bin] = uint16_t(before + popc(peers));
  return before;
}

// Marks the quad of a bumped bin in the slice's bitmap.
PK_HD void mark(uint32_t* marked, uint32_t bin) {
  const uint32_t q = bin >> 2;
#ifdef __CUDA_ARCH__
  atomicOr(marked + (q >> 5), 1u << (q & 31));
#else
  marked[q >> 5] |= 1u << (q & 31);
#endif
}

// A lane's rank among its warp's lanes so far with its id: the counter
// before its group, then its peers in lower lanes.
PK_HD int32_t group_rank(uint32_t base, uint32_t peers, int lane) {
  return int32_t(base + popc(peers & ((1u << lane) - 1u)));
}

// Four counters (8 bytes, p 8-byte aligned) as one word, 16 bits each.
PK_HD uint64_t load4(const uint16_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint64_t*>(p);
#else
  uint64_t v;
  memcpy(&v, p, sizeof v);
  return v;
#endif
}

PK_HD void store4(uint16_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint64_t*>(p) = v;
#else
  memcpy(p, &v, sizeof v);
#endif
}

// Bins r .. r + 3 of a slice (r a multiple of 4, `stride` counters a
// warp's row, a multiple of 8) down the warps: warp w's four counters (w
// >= 1) become the counts in earlier warps, and warp 0's, whose earlier
// count is always 0, become the four totals: the histogram entries. A
// total is at most block_w <= kCountMaxBlockW < 2^16, so the four sums,
// taken in one 64-bit add, never carry into each other.
PK_HD void scan_quad(uint16_t* counts, int warps, int stride, int r) {
  uint64_t run = load4(counts + r);
  for (int w = 1; w < warps; ++w) {
    uint16_t* p = counts + size_t(w) * stride + r;
    const uint64_t c = load4(p);
    store4(p, run);
    run += c;
  }
  store4(counts + r, run);
}

// Bins r .. r + 3 back to 0 in every warp's row.
PK_HD void clear_quad(uint16_t* counts, int warps, int stride, int r) {
  for (int w = 0; w < warps; ++w) store4(counts + size_t(w) * stride + r, 0);
}

// After scan_quad: the count of a bin in the warps before `warp`.
PK_HD uint32_t earlier(const uint16_t* counts, int warp, int stride,
                       uint32_t bin) {
  return warp == 0 ? 0u : counts[size_t(warp) * stride + bin];
}

// The rank of a lane whose id has no counter, as the plain version gives
// it: the earlier lanes of the tile with the same id (a slow loop, for ids
// the contract excludes; slice 0 of a tile writes it).
PK_HD int32_t rank_by_scan(const int32_t* tile_ids, int lane, int32_t id) {
  int32_t r = 0;
  for (int l = 0; l < lane; ++l) r += tile_ids[l] == id;
  return r;
}

}  // namespace pk
