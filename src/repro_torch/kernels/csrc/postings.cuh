// The postings kernel's per-tile steps, shared by the CUDA kernel
// (postings.cu, K5) and a host build the CPU tests check bit for bit
// against the plain version (kernels/postings.py).
//
// Two instances, picked by shape alone (instance() below):
//
//   counting  per tile a warp-by-warp count of the ids in shared-memory
//             counters: a word's rank is the number of earlier words in
//             its tile with its id, a bin's total is the histogram entry.
//             No sort, O(block_w + n_roots) work a tile.
//   bitonic   counterpart of repro/kernels/postings.py:_bitonic_sort,
//             _lower_bound and the body of _postings_kernel: block_w (a
//             power of two) composite keys id * block_w + lane are sorted;
//             they are unique, so the rank of a word within its root
//             segment is its key's sorted position minus the segment's
//             start. For shapes whose counters do not fit.
#pragma once

#include <stddef.h>
#include <stdint.h>

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
// the counting instance
// ---------------------------------------------------------------------------
//
// A tile's lanes are split into `warps` contiguous runs of per_warp =
// block_w / warps lanes; warp w walks its run 32 lanes (a group) at a
// time, in lane order, and keeps uint16 counters[w][id] in shared memory
// (a row of count_stride(n_roots_pad) counters a warp). Within a group,
// the lanes holding one id (its peers, found by one ballot of the counted
// flag and one of each of the id's id_bits(n_roots_pad) low bits) take
// consecutive ranks after the counter, and the lowest of them adds their
// number to it. After a
// barrier, each bin is scanned down the warps: the total is the histogram
// entry and each warp's counter becomes the count in earlier warps, which
// its lanes add to their ranks. So ranks follow lane order and no atomic
// decides one.

constexpr int kWarp = 32;
constexpr int kLanesPerWarp = 256;          // 8 groups a warp, in registers
constexpr int kMaxGroups = kLanesPerWarp / kWarp;
constexpr int kMaxWarps = 32;               // 1024 threads
// the widest tile whose ids and ranks a block holds in registers
constexpr int kCountMaxBlockW = kMaxWarps * kLanesPerWarp;   // 8192

enum Instance { kBitonic = 0, kCounting = 1 };

// Warps of a counting block: one per 256 lanes, one for narrower tiles.
PK_HD int count_warps(int block_w) {
  return block_w >= kLanesPerWarp ? block_w / kLanesPerWarp : 1;
}

// Counters a warp's row holds: n_roots_pad rounded up to 8 (16-byte rows).
PK_HD int count_stride(int n_roots_pad) { return (n_roots_pad + 7) & ~7; }

// Shared-memory bytes of the counters of a block_w tile.
PK_HD size_t count_smem(int block_w, int n_roots_pad) {
  return sizeof(uint16_t) * size_t(count_warps(block_w)) *
         size_t(count_stride(n_roots_pad));
}

// The instance a (block_w, n_roots_pad) launch takes, by shape alone: the
// counting one while block_w <= kCountMaxBlockW and its counters fit
// max_smem bytes, else the bitonic one.
PK_HD int instance(int block_w, int n_roots_pad, size_t max_smem) {
  return block_w <= kCountMaxBlockW &&
                 count_smem(block_w, n_roots_pad) <= max_smem
             ? kCounting
             : kBitonic;
}

// ids outside [0, n_roots_pad) have no counter and no histogram entry.
PK_HD bool counted(int32_t id, int n_roots_pad) {
  return uint32_t(id) < uint32_t(n_roots_pad);
}

// Bits a counted id has: ceil(log2(n_roots_pad)).
PK_HD int id_bits(int n_roots_pad) {
  int bits = 0;
  while ((1 << bits) < n_roots_pad) ++bits;
  return bits;
}

// One step of finding a lane's peers: keep the lanes of `ballot` (the
// lanes whose predicate is set) if the lane's own predicate is set, else
// the others. Starting from the active lanes, the counted flag's step
// and one step for each of the id's id_bits low bits leave, for a counted
// id, exactly the lanes with that id (an uncounted id gets lanes with its
// low bits, which only decide its leader).
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

// The group leader's step for a counted id: the warp's counter grows by
// the number of peers; -> the counter before, the rank of the first peer.
PK_HD uint32_t bump(uint16_t* warp_counts, int32_t id, uint32_t peers) {
  const uint32_t before = warp_counts[id];
  warp_counts[id] = uint16_t(before + popc(peers));
  return before;
}

// A lane's rank among its warp's lanes so far with its id: the counter
// before its group, then its peers in lower lanes.
PK_HD int32_t group_rank(uint32_t base, uint32_t peers, int lane) {
  return int32_t(base + popc(peers & ((1u << lane) - 1u)));
}

// Bin r down the warps: each warp's counter becomes the count in earlier
// warps; -> the tile's total, the histogram entry.
PK_HD int32_t scan_bin(uint16_t* counts, int warps, int stride, int r) {
  uint32_t run = 0;
  for (int w = 0; w < warps; ++w) {
    const uint32_t c = counts[w * stride + r];
    counts[w * stride + r] = uint16_t(run);
    run += c;
  }
  return int32_t(run);
}

// The rank of a lane whose id has no counter, as the plain version gives
// it: the earlier lanes of the tile with the same id (a slow loop, for ids
// the contract excludes).
PK_HD int32_t rank_by_scan(const int32_t* tile_ids, int lane, int32_t id) {
  int32_t r = 0;
  for (int l = 0; l < lane; ++l) r += tile_ids[l] == id;
  return r;
}

}  // namespace pk
