// The sorted search's steps (K8), shared by the CUDA kernel (dict_match.cu)
// and a host build the CPU tests check bit for bit against the plain
// version (kernels/stem_match.py: dict_match_bsearch_plain).
//
// The function: membership of each key in the sorted dictionary padded to
// a power of two rp >= 128 with the sentinel (the reference's bisection of
// that table, bsearch_hit, finds a key exactly when it is an entry). The
// kernel is given the unpadded table and its r entries; entries [r, rp)
// are read as the sentinel (entry()), never stored by the caller.
//
// The layout: a complete binary tree in breadth-first order (node j's
// children at 2j and 2j + 1) of every S-th entry of the padded table,
// entries S, 2S, ..., in shared memory, node 0 holding entry 0. log2(rp /
// S) steps of j = 2j + (node <= key) count the tree's entries at or below
// the key, and the walk's last right turn is at the largest of them.
//   - shared instance (rp <= kSharedMaxRp): S = 1, the whole table is the
//     tree, and a key is an entry iff that largest entry equals it: log2
//     rp + 1 loads a key and no block read;
//   - global instance: the table stays in global memory (L2) and only the
//     tree of every S-th entry is staged, S >= 8 chosen by the launch
//     (log2_step: fewer fences for a launch of few keys, whose blocks each
//     build the tree from L2); the walk gives the key's S-entry segment, a
//     bisection of its 8-entry blocks (S > 8) and one 32-byte block read
//     from L2 end it (rt::block8_member, as K2's search ends). A sorted
//     table holds a key iff the segment does: entry cS <= key < entry
//     (c + 1)S, so every copy of the key lies in it.
//
// Shared-memory traffic a warp (32 distinct keys, the tri table, rp =
// 2048, 11 levels): the first three levels come from registers (nodes
// 1-7, read once a thread); level d reads nodes [2^d, 2^(d+1)), one
// contiguous run, so levels 3-5 (up to 32 words) touch distinct banks,
// one wavefront each, and levels 6-10 hold 2, 4, 8, 16 and 32 words a
// bank, about 2-4 wavefronts each, and the final read about as many:
// about 18 a warp, where the plain bisection's
// 12 probes take some 80 (its first levels all land in one bank), and a
// fence level of every 8th entry with an 8-entry block about 34 (the two
// 16-byte reads alone about 24, served a quarter-warp at a time).
#pragma once

#include <stdint.h>

#include "stem_fences.cuh"

#ifdef __CUDACC__
#define DS_HD __host__ __device__ __forceinline__
#else
#define DS_HD inline
#endif

namespace ds {

constexpr int32_t kSentinel = RT_DICT_SENTINEL;
// entries a block of the global instance's last step
constexpr int kLog2Block = 3;
// levels of the tree a thread walks from registers (every tree has at
// least 16 nodes: rp >= 128, S <= rp / 16)
constexpr int kTop = 3;
// the two instances: the padded table in shared memory up to kSharedMaxRp
// entries (128 KB), else read from global memory with only a tree of
// fences staged, at most kFenceBudgetBytes of them
constexpr int kShared = 0;
constexpr int kGlobal = 1;
constexpr int kSharedMaxRp = 32768;
constexpr long long kFenceBudgetBytes = 227 * 1024;

DS_HD int instance(int rp) { return rp <= kSharedMaxRp ? kShared : kGlobal; }

DS_HD int floor_log2(unsigned v) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(v);
#else
  return 31 - __builtin_clz(v);
#endif
}

// Index of the lowest set bit of a nonzero v.
DS_HD int lowest_set(unsigned v) {
#ifdef __CUDA_ARCH__
  return __ffs(v) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// log2 of a power of two rp.
DS_HD int log2_of(int rp) { return floor_log2(unsigned(rp)); }

// log2 S: 0 for the shared instance; for the global one the step from 8
// up whose fences fit the budget and that moves the fewest 32-byte
// sectors: `grid` blocks each building the tree (a sector a fence) and n
// keys each reading log2(S / 8) + 1 sectors.
DS_HD int log2_step(int rp, int inst, long long n, int grid) {
  if (inst == kShared) return 0;
  int best = -1;
  long long best_cost = 0;
  for (int s = kLog2Block; s <= log2_of(rp) - 4; ++s) {
    if (4LL * (rp >> s) > kFenceBudgetBytes) continue;
    const long long cost =
        (long long)grid * (rp >> s) + n * (s - kLog2Block + 1);
    if (best < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

// Shared-memory bytes of a block: the tree's rp >> log2s words.
DS_HD long long smem_bytes(int rp, int log2s) { return 4LL * (rp >> log2s); }

// Entry i of the padded table: the dictionary's below r, the sentinel up
// to rp.
DS_HD int32_t entry(const int32_t* dict, int r, int i) {
#ifdef __CUDA_ARCH__
  return i < r ? __ldg(dict + i) : kSentinel;
#else
  return i < r ? dict[i] : kSentinel;
#endif
}

// The entry (its index over S) that tree node j >= 1 (breadth first, of a
// tree of 2^levels - 1 nodes) holds: its in-order position.
DS_HD int fence_of(int j, int levels) {
  const int d = floor_log2(unsigned(j));
  return (2 * (j - (1 << d)) + 1) << (levels - 1 - d);
}

// Entry index of tree node j of the tree of every 2^log2s-th entry.
DS_HD int node_entry(int j, int levels, int log2s) {
  return j == 0 ? 0 : fence_of(j, levels) << log2s;
}

// The dictionary in global memory, its padding read as the sentinel; a
// block wholly inside the dictionary is two 16-byte reads when the
// dictionary is 16-byte aligned.
struct GlobalTable {
  const int32_t* d;
  int r;
  bool aligned;
  DS_HD int32_t at(int i) const { return entry(d, r, i); }
  DS_HD void block8(int i, int32_t v[8]) const {
    if (aligned && i + 8 <= r) {
      rt::stream_block8(d + i, v);
    } else {
      for (int q = 0; q < 8; ++q) v[q] = entry(d, r, i + q);
    }
  }
};

// The search for K keys at once, their loads issued together -> the K
// flags, one a byte, key 0 lowest. tree holds 2^levels nodes of every
// 2^log2s-th entry; INST kShared: log2s = 0, the tree is the whole padded
// table and t is not read. After the walk, j's bits below its leading one
// are the turns (1: right); the last right turn was at node j >> ffs(j),
// the largest tree entry at or below the key (node 0, entry 0, when the
// walk never turned right).
template <int K, int INST>
DS_HD uint32_t search(const int32_t* tree, int levels, int log2s,
                      const GlobalTable& t, const int32_t key[K]) {
  // the top kTop levels (nodes 1-7) from registers, by selects: every
  // lane would read the same few words, a wavefront a level
  const int32_t n1 = tree[1], n2 = tree[2], n3 = tree[3], n4 = tree[4];
  const int32_t n5 = tree[5], n6 = tree[6], n7 = tree[7];
  int j[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const bool b0 = n1 <= key[u];
    const bool b1 = (b0 ? n3 : n2) <= key[u];
    const bool b2 = (b0 ? (b1 ? n7 : n6) : (b1 ? n5 : n4)) <= key[u];
    j[u] = 8 | int(b0) << 2 | int(b1) << 1 | int(b2);
  }
  for (int l = kTop; l < levels; ++l) {
#pragma unroll
    for (int u = 0; u < K; ++u) j[u] = 2 * j[u] + (tree[j[u]] <= key[u]);
  }
  uint32_t flags = 0;
  if constexpr (INST == kShared) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int pred = j[u] >> (lowest_set(unsigned(j[u])) + 1);
      flags |= uint32_t(tree[pred] == key[u]) << (8 * u);
    }
    return flags;
  }
  int at[K];
#pragma unroll
  for (int u = 0; u < K; ++u) at[u] = (j[u] - (1 << levels)) << log2s;
  for (int n = 1 << (log2s - kLog2Block); n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int p = at[u] + 8 * half;
      at[u] = t.at(p) <= key[u] ? p : at[u];
    }
    n -= half;
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    int32_t v[8];
    t.block8(at[u], v);
    flags |= uint32_t(rt::block8_member<rt::kMatchBsearch>(v, key[u]))
             << (8 * u);
  }
  return flags;
}

}  // namespace ds
