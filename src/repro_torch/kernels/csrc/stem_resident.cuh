// Stage 5 against resident tables, and the one kernel body behind the two
// resident kernels: the megakernel (stem_fused.cu, K1) and the persistent
// kernel's resident variant (stem_persistent.cu, K3), which adds the
// descriptor ring and the completion flags.
//
// The tables are the padded flat layouts of kernels/stem_fused.py
// (padded_tables): sorted and padded to a pow2 >= 128 with the sentinel for
// the binary search, padded to a 128 multiple with -2 for the bank. A
// kernel either copies them into shared memory or reads them from global
// memory through __ldg (SHARED = false: past the shared-memory budget);
// the answers do not depend on where they are.
//
// The design, for Hopper:
//   - a word's live slots are searched by a group of G lanes (G in {1, 2,
//     4, 8}, picked per launch): in rounds of 2G live slots in priority
//     order, lane j takes the j-th and (G + j)-th of the round and runs
//     both searches step by step together (two loads in flight); a group
//     vote (__ballot_sync, then the lowest set bit) picks the round's
//     first hit in slot order, and the group stops after the first round
//     with a hit. So the answer is the sequential first hit, early exit
//     kept. The launcher takes the fewest lanes whose threads reach 4
//     warps a SM (G = 8 at a 4096-word serve launch: blocks on 128 SMs,
//     not 16; G = 1 from 16,896 words on 132 SMs, an index chunk's
//     131,072 and 1M, where the words alone hide the latency and issue
//     is the cost). At G = 1 a lane tries the live slots one after
//     another, the slots unrolled, with no vote and no selects;
//   - a block copies the tables into shared memory with cp.async
//     (stage_begin, shared with the fence level's staging) and runs its
//     threads' first words through stages 1-4 while the copy is in flight;
//   - K1's words are one tile (block_b only groups them): a block takes
//     one pass of 256 / G words, rows blockIdx.x * 256 / G on, with no
//     loop. In K3 an item is `per` whole tiles (block_b words each) when a
//     block's pass holds a tile, or one of a tile's `parts` pieces
//     otherwise; its grid is at most the blocks the card keeps resident,
//     striding over the ring's items, so it stages the tables once a
//     resident block;
//   - K3 retires each item with one fence and one barrier, then a
//     system-scope fence and volatile flag stores by one warp, so the
//     flags may live in host-mapped memory that the host reads while the
//     launch runs; a tile cut into parts is retired by the last part to
//     arrive, counted down in a device-memory array beside the flags
//     (device atomics on mapped host memory are not guaranteed over
//     PCIe), so a flag only ever holds 0 or 1 + its version slot.
// The lane split, the round vote, the walk and the rule for G are
// __host__ __device__: a g++ build of this header (host_datapath.cpp)
// runs the same walk and search for the CPU tests, each group's lanes in
// lane order.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "stem_fences.cuh"

#ifdef __CUDACC__
#include <limits.h>

#include <mutex>
#include <vector>
#endif

namespace rt {

// Threads a resident block runs, whatever block_b is.
constexpr int kResidentThreads = 256;
// The most lanes a word's slots are split across.
constexpr int kMaxLanes = 8;
// Items a persistent block takes a round: at most this many times the
// tiles one pass of its threads holds (a round ends in a barrier that
// waits for its slowest word, so fewer, longer rounds lose less).
constexpr int kMaxRounds = 4;

RT_HD int imin(int a, int b) { return a < b ? a : b; }

template <bool SHARED>
RT_HD int32_t dict_at(const int32_t* d, int i) {
#ifdef __CUDA_ARCH__
  if constexpr (!SHARED) return __ldg(d + i);
#endif
  return d[i];
}

// ceil(log2 rp) bisection steps over a sorted, sentinel-padded table of
// pow2 length rp; each probe index is clamped into [0, rp-1] like the
// reference's jnp.take(mode="clip").
template <bool SHARED>
RT_HD bool bsearch_hit(const int32_t* d, int rp, int steps, int32_t key) {
  int lo = 0, hi = rp - 1;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool ge = dict_at<SHARED>(d, imin(mid < 0 ? 0 : mid, rp - 1)) >= key;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  return dict_at<SHARED>(d, imin(lo < 0 ? 0 : lo, rp - 1)) == key;
}

// Comparator bank: any equal entry. Stopping at the first equal entry
// gives the same answer as the reference's all-pairs OR.
template <bool SHARED>
RT_HD bool bank_hit(const int32_t* d, int r, int32_t key) {
  for (int i = 0; i < r; ++i) {
    if (dict_at<SHARED>(d, i) == key) return true;
  }
  return false;
}

RT_HD int ceil_log2(int n) {
  int s = 0;
  while (s < 31 && (1 << s) < n) ++s;
  return s;
}

// Lowest set bit of a nonzero mask.
RT_HD int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The tables a candidate group count reads: bi feeds group 4 only.
template <int N_GROUPS>
RT_HD constexpr int n_tables() {
  return N_GROUPS == 5 ? 3 : 2;
}

// The three tables (0 tri, 1 quad, 2 bi), their padded lengths and their
// bisection depths (0 for the bank, which does not bisect). Read by a
// table number through selects, not an indexed array.
struct Tables {
  const int32_t* d[3];
  int len[3];
  int steps[3];

  RT_HD const int32_t* table(int t) const {
    return t == 0 ? d[0] : t == 1 ? d[1] : d[2];
  }
  RT_HD int length(int t) const {
    return t == 0 ? len[0] : t == 1 ? len[1] : len[2];
  }
  RT_HD int depth(int t) const {
    return t == 0 ? steps[0] : t == 1 ? steps[1] : steps[2];
  }
};

template <int MATCH>
RT_HD Tables make_tables(const int32_t* tri, int tri_n, const int32_t* quad,
                         int quad_n, const int32_t* bi, int bi_n) {
  Tables t{{tri, quad, bi}, {tri_n, quad_n, bi_n}, {0, 0, 0}};
  if (MATCH == kMatchBsearch) {
    for (int k = 0; k < 3; ++k) t.steps[k] = ceil_log2(t.len[k]);
  }
  return t;
}

// Is key in table tt (by the launch's match)?
template <int MATCH, bool SHARED>
RT_HD bool table_hit(const Tables& t, int tt, int32_t key) {
  return MATCH == kMatchBsearch
             ? bsearch_hit<SHARED>(t.table(tt), t.length(tt), t.depth(tt), key)
             : bank_hit<SHARED>(t.table(tt), t.length(tt), key);
}

// A word's first hit searched by one lane (a launch's G = 1, where the
// words alone hide the latency and issue is the cost): the
// live slots in priority order, one search each, up to the first hit; the
// slots unrolled, so every key and table is a register, not a select.
// -> the hit's slot (-1: none) and its key in chosen.
template <int MATCH, bool SHARED, int N_GROUPS>
RT_HD int first_live_hit(const int32_t keys[kSlots], uint32_t live,
                         const Tables& t, int32_t& chosen) {
  int win = -1;
  chosen = 0;
#pragma unroll
  for (int s = 0; s < N_GROUPS * kCand; ++s) {
    if (win < 0 && ((live >> s) & 1u) &&
        table_hit<MATCH, SHARED>(t, rt_group_dict(s / kCand), keys[s])) {
      win = s;
      chosen = keys[s];
    }
  }
  return win;
}

// Slot of the n-th set bit of m (n from 0), -1 past the last.
RT_HD int nth_slot(uint32_t m, int n) {
  for (int i = 0; i < n && m != 0; ++i) m &= m - 1u;
  return m != 0 ? lowest_bit(m) : -1;
}

// keys[s] by selects over the slots (no indexed register array); 0 for
// s = -1.
RT_HD int32_t slot_key(const int32_t keys[kSlots], int s) {
  int32_t k = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) k = i == s ? keys[i] : k;
  return k;
}

// One lane's share of a round: are the keys of slots sa and sb (-1: no
// slot) in their groups' tables? bsearch runs both bisections step by
// step together; the bank scans for both keys in one pass and stops once
// the first is found (the lane's first slot comes before every second
// slot of the round, so the second no longer matters).
template <int MATCH, bool SHARED>
RT_HD void lane_hits(const int32_t keys[kSlots], int sa, int sb,
                     const Tables& t, bool& ha, bool& hb, int32_t& ka,
                     int32_t& kb) {
  ka = slot_key(keys, sa);
  kb = slot_key(keys, sb);
  const int ta = sa >= 0 ? rt_group_dict(sa / kCand) : 0;
  const int tb = sb >= 0 ? rt_group_dict(sb / kCand) : 0;
  const int32_t* da = t.table(ta);
  const int32_t* db = t.table(tb);
  const int la = t.length(ta), lb = t.length(tb);
  if (MATCH == kMatchBsearch) {
    const int na = sa >= 0 ? t.depth(ta) : 0;
    const int nb = sb >= 0 ? t.depth(tb) : 0;
    int lo_a = 0, hi_a = la - 1, lo_b = 0, hi_b = lb - 1;
    for (int s = 0; s < na || s < nb; ++s) {
      if (s < na) {
        const int mid = (lo_a + hi_a) >> 1;
        const bool ge = dict_at<SHARED>(da, imin(mid, la - 1)) >= ka;
        hi_a = ge ? mid : hi_a;
        lo_a = ge ? lo_a : mid + 1;
      }
      if (s < nb) {
        const int mid = (lo_b + hi_b) >> 1;
        const bool ge = dict_at<SHARED>(db, imin(mid, lb - 1)) >= kb;
        hi_b = ge ? mid : hi_b;
        lo_b = ge ? lo_b : mid + 1;
      }
    }
    ha = sa >= 0 && dict_at<SHARED>(da, imin(lo_a, la - 1)) == ka;
    hb = sb >= 0 && dict_at<SHARED>(db, imin(lo_b, lb - 1)) == kb;
  } else {
    ha = hb = false;
    const int n = sa < 0 ? 0 : sb < 0 ? la : la > lb ? la : lb;
    for (int i = 0; i < n && !ha; ++i) {
      ha = ha || (i < la && dict_at<SHARED>(da, i) == ka);
      hb = hb || (sb >= 0 && i < lb && dict_at<SHARED>(db, i) == kb);
    }
  }
}

// The round's first hit in slot order: its position in the round (-1: no
// hit), lane p % G's first (p < G) or second search. Bit j of votes_a
// (votes_b) is lane j's hit of the round's j-th ((G + j)-th) live slot.
RT_HD int round_winner(uint32_t votes_a, uint32_t votes_b, int lanes) {
  return votes_a != 0   ? lowest_bit(votes_a)
         : votes_b != 0 ? lanes + lowest_bit(votes_b)
                        : -1;
}

// The live slots left after a round of 2G.
RT_HD uint32_t drop_round(uint32_t rest, int lanes) {
  for (int i = 0; i < 2 * lanes && rest != 0; ++i) rest &= rest - 1u;
  return rest;
}

// Threads a SM (words x lanes) below which a launch splits its words: a
// launch with fewer than 4 warps of words a SM is latency-bound, and a
// word's slots spread over lanes finish sooner; past it the words hide
// each other's latency and a split only adds issue. Set from K1's times at
// each lane count (chip_smoke.py phase 9; PERF.md section 6).
constexpr int kFillThreadsPerSM = 128;

// The fewest lanes a word (a power of two up to kMaxLanes) whose threads,
// words x lanes, reach kFillThreadsPerSM on each of the card's SMs.
RT_HD int resident_lanes(long long words, int sms) {
  int g = 1;
  while (g < kMaxLanes && words * g < (long long)sms * kFillThreadsPerSM) {
    g *= 2;
  }
  return g;
}

// How a launch's blocks walk its tiles: items are `per` whole tiles
// (parts == 1) or one of a tile's `parts` pieces (per == 1); a block
// takes items blockIdx.x, + grid, ..., each in passes of `width` words,
// `stride` tiles a pass (parts == 1) or one piece.
struct Walk {
  int block_b;  // words a tile
  int lanes;    // lanes a word (G)
  int width;    // words a pass: threads / lanes
  int stride;   // tiles a pass: width / block_b, or 1 for pieces
  int per;      // tiles an item
  int parts;    // items a tile
  int n_tiles;
  int n_items;
};

// The walk of n_tiles tiles of block_b words on `threads` threads a block,
// `capacity` resident blocks, items of up to max_rounds passes (K3's
// kMaxRounds; K1, whose items are one pass a block, 1, and capacity is
// not read); n_items = -1 if it does not fit an int.
RT_HD Walk resident_walk(int n_tiles, int block_b, int threads, int lanes,
                         int capacity, int max_rounds) {
  Walk w{block_b, lanes, threads / lanes, 1, 1, 1, n_tiles, 0};
  long long items;
  if (block_b > w.width) {
    w.parts = (block_b - 1) / w.width + 1;
    items = (long long)n_tiles * w.parts;
  } else {
    w.stride = w.width / block_b;
    const long long rounds =
        max_rounds == 1
            ? 1
            : ((long long)n_tiles + w.stride - 1) / w.stride / capacity;
    w.per = w.stride * int(rounds < 1 ? 1 : rounds > max_rounds ? max_rounds
                                                                 : rounds);
    items = ((long long)n_tiles + w.per - 1) / w.per;
  }
  w.n_items = items > 0x7fffffffLL ? -1 : int(items);
  return w;
}

// K1's walk: its words are one tile (block_b only groups them), so an
// item is a pass of `width` words and word x of item i is row i * width
// + x.
RT_HD Walk fused_walk(int n_words, int lanes) {
  return resident_walk(1, n_words, kResidentThreads, lanes, 1, 1);
}

// Item i: tiles d0 .. d0 + nd - 1 from word lo of each (lo > 0 for a
// piece of a tile).
struct Item {
  int d0, nd, lo;
};

RT_HD Item walk_item(const Walk& w, int i) {
  const int d0 = (i / w.parts) * w.per;
  return {d0, imin(w.per, w.n_tiles - d0), (i % w.parts) * w.width};
}

// The word of a pass that a group of lanes takes, g = threadIdx.x / G:
// word `off` of the pass's tile `ts` (ts = -1: no word, where block_b
// does not divide the width). Fixed for the launch, so a word's row is a
// tile's first row plus off, with no division a word.
struct Place {
  int ts, off;
};

RT_HD Place walk_place(const Walk& w, int g) {
  if (w.parts > 1) return {0, g};
  const int ts = g / w.block_b;
  return {ts < w.stride ? ts : -1, g % w.block_b};
}

// Row of the place's word in tile d of the item: through the descriptor
// ring (row offsets desc[3d]) or, without one, tile d's rows d * block_b
// ...; -1 past the tile or the words.
RT_HD long long tile_word(const Walk& w, const Item& it, const Place& p,
                          int d, const int32_t* desc, int n_words) {
  const int x = it.lo + p.off;
  if (x >= w.block_b) return -1;
  const long long r =
      (desc != nullptr ? (long long)stream_at(desc + 3 * d)
                       : (long long)d * w.block_b) + x;
  return r < n_words ? r : -1;
}

// Dynamic shared memory a resident kernel asks for: the tables it reads,
// or none when they are read from global memory.
template <bool SHARED, int N_GROUPS>
RT_HD size_t resident_smem_bytes(int tri_n, int quad_n, int bi_n) {
  if (!SHARED) return 0;
  return sizeof(int32_t) *
         (size_t(tri_n) + quad_n + (N_GROUPS == 5 ? bi_n : 0));
}

#ifdef __CUDACC__

// Word row i as 16 ints (four 16-byte loads); rows past n_words read as
// the zero word, which has no valid candidate.
__device__ __forceinline__ void load_word(const int4* __restrict__ words,
                                          long long i, int n_words,
                                          int32_t w[kMaxLen]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = i < n_words ? __ldg(words + 4 * i + k)
                               : make_int4(0, 0, 0, 0);
    w[4 * k + 0] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store_root(int4* __restrict__ root,
                                           int32_t* __restrict__ source,
                                           long long i, int32_t chosen,
                                           int32_t src) {
  root[i] = make_int4((chosen >> 18) & 63, (chosen >> 12) & 63,
                      (chosen >> 6) & 63, chosen & 63);
  source[i] = src;
}

// Copy the tables the groups read into dynamic shared memory and repoint
// t at the copies; the copy is ready after stage_end (every padded length
// is a multiple of 128 ints, so it is whole 16-byte copies).
template <int N_GROUPS>
__device__ __forceinline__ void stage_tables_begin(Tables& t) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  int off = 0;
#pragma unroll
  for (int k = 0; k < n_tables<N_GROUPS>(); ++k) {
    stage_begin(smem + off, t.d[k], t.len[k]);
    t.d[k] = smem + off;
    off += t.len[k];
  }
}

// A word's first hit (its slot, -1: none; its key in chosen), the live
// slots searched by the thread's group of `lanes` lanes in rounds of 2G;
// the winning lane hands its key to the group. Every lane of the group
// calls it with the same word.
template <int MATCH, bool SHARED>
__device__ __forceinline__ int group_search(const int32_t keys[kSlots],
                                            uint32_t live, const Tables& t,
                                            int lanes, int32_t& chosen) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (lanes - 1);
  const int base = lane - j;
  const uint32_t own = (1u << lanes) - 1u;
  const uint32_t group = own << base;
  uint32_t rest = live;
  int win = -1;
  chosen = 0;
  while (rest != 0 && win < 0) {
    bool ha, hb;
    int32_t ka, kb;
    lane_hits<MATCH, SHARED>(keys, nth_slot(rest, j),
                             nth_slot(rest, lanes + j), t, ha, hb, ka, kb);
    const uint32_t va = (__ballot_sync(group, ha) >> base) & own;
    const uint32_t vb = (__ballot_sync(group, hb) >> base) & own;
    const int p = round_winner(va, vb, lanes);
    if (p >= 0) {
      chosen = __shfl_sync(group, p < lanes ? ka : kb,
                           base + (p & (lanes - 1)));
      win = nth_slot(rest, p);
    }
    rest = drop_round(rest, lanes);
  }
  return win;
}

// Items d0 .. d0 + nd - 1 of the ring are done: every thread's output
// writes are fenced device-wide before the barrier; then the first warp,
// after a system-scope fence (the flags may be host-mapped memory that the
// host polls while the launch runs), stores the flags (1 + the version
// slot) with volatile stores. A tile cut into parts counts its parts down
// from 0 in counts[d0], device memory the caller zeroes; the last to
// arrive, after a fence that orders it after the other parts' rows (each
// fenced before its count), stores the flag. A flag that reads set proves
// its tile's rows, to the device and to the host.
__device__ __forceinline__ void retire(const int32_t* __restrict__ desc,
                                       int d0, int nd, int parts,
                                       int32_t* counts, int32_t* flags) {
  __threadfence();
  __syncthreads();
  if (parts > 1) {
    if (threadIdx.x != 0 || atomicSub(counts + d0, 1) != 1 - parts) return;
  } else if (threadIdx.x >= 32) {
    return;
  }
  __threadfence_system();
  for (int k = threadIdx.x; k < nd; k += 32) {
    *reinterpret_cast<volatile int32_t*>(flags + d0 + k) =
        1 + __ldg(desc + 3 * (d0 + k) + 2);
  }
}

// Stage 5 of row r's word, one lane (first_live_hit) or the thread's
// group of lanes (group_search) a word, and its store by the group's
// first lane.
template <int MATCH, bool SHARED, int N_GROUPS, bool SPLIT>
__device__ __forceinline__ void resident_row(
    long long r, const int32_t keys[kSlots], uint32_t live, const Tables& t,
    int lanes, int4* __restrict__ root, int32_t* __restrict__ source) {
  int32_t chosen;
  const int win =
      SPLIT ? group_search<MATCH, SHARED>(keys, live, t, lanes, chosen)
            : first_live_hit<MATCH, SHARED, N_GROUPS>(keys, live, t, chosen);
  if (!SPLIT || (threadIdx.x & (lanes - 1)) == 0) {
    store_root(root, source, r, chosen,
               win < 0 ? 0 : rt_group_tag(win / kCand));
  }
}

// Both resident kernels: stages 1-5 for the words of the walk's tiles.
// SPLIT: the launch's G > 1 lanes a word; else one lane a word: separate
// instances, so neither carries the other's registers. The thread's first
// word goes through stages 1-4 while the tables are copied, except in
// K3's one-lane instance, where keeping its keys across the loop costs
// registers.
// K1 (!PERSISTENT): the words are one tile (fused_walk) and a block one
// pass of them, so a thread has at most one word, row blockIdx.x * width
// + its group, with no walk arithmetic and no loop (either costs the
// one-lane word registers, and blocks an SM, which at 1M words cost more
// than staging the tables once a resident block saves); desc, counts and
// flags are unused.
// K3 (PERSISTENT): the grid is at most the resident blocks, striding over
// the ring's items, and each item retires.
template <int MATCH, bool SHARED, int N_GROUPS, bool PERSISTENT, bool SPLIT>
__device__ __forceinline__ void resident_body(
    const int4* __restrict__ words, int n_words,
    const int32_t* __restrict__ desc, Tables t, const Walk& w,
    int4* __restrict__ root, int32_t* __restrict__ source, int32_t* counts,
    int32_t* flags) {
  if constexpr (SHARED) stage_tables_begin<N_GROUPS>(t);
  const int g = threadIdx.x / w.lanes;
  int32_t keys[kSlots];
  uint32_t live = 0;
  long long ready = -1;
  if constexpr (!PERSISTENT) {
    const long long r = (long long)blockIdx.x * w.width + g;
    if (r < n_words) {
      ready = r;
      live = load_word_keys<N_GROUPS>(words, r, keys);
    }
    if constexpr (SHARED) stage_end();
    if (ready >= 0) {
      resident_row<MATCH, SHARED, N_GROUPS, SPLIT>(ready, keys, live, t,
                                                   w.lanes, root, source);
    }
    return;
  }
  const Place p = walk_place(w, g);
  if (SPLIT && int(blockIdx.x) < w.n_items && p.ts >= 0) {
    const Item it = walk_item(w, blockIdx.x);
    if (p.ts < it.nd) {
      ready = tile_word(w, it, p, it.d0 + p.ts, desc, n_words);
      if (ready >= 0) live = load_word_keys<N_GROUPS>(words, ready, keys);
    }
  }
  if constexpr (SHARED) stage_end();
  for (int i = blockIdx.x; i < w.n_items; i += gridDim.x) {
    const Item it = walk_item(w, i);
    for (int d = it.d0 + p.ts; p.ts >= 0 && d < it.d0 + it.nd;
         d += w.stride) {
      const long long r = tile_word(w, it, p, d, desc, n_words);
      if (r < 0) continue;
      if (r != ready) live = load_word_keys<N_GROUPS>(words, r, keys);
      ready = -1;
      resident_row<MATCH, SHARED, N_GROUPS, SPLIT>(r, keys, live, t, w.lanes,
                                                   root, source);
    }
    retire(desc, it.d0, it.nd, w.parts, counts, flags);
  }
}

// The two kernels differ only in their launch bounds, each the faster
// one on an H100 (PERF.md section 6): K1 takes ptxas's own register
// choice, which fits its one-lane instance to 6 blocks an SM at the cost
// of a small spill, cheaper at 1M words than a spill-free instance on 5;
// K3's one-lane instance is held to 4 blocks an SM, spill-free (ptxas
// alone gives it 3); its G-lane instance takes what it needs.
template <int MATCH, bool SHARED, int N_GROUPS, bool SPLIT>
__global__ void __launch_bounds__(kResidentThreads)
fused_resident_kernel(const int4* __restrict__ words, int n_words,
                      const int32_t* __restrict__ desc, Tables t, Walk w,
                      int4* __restrict__ root, int32_t* __restrict__ source,
                      int32_t* counts, int32_t* flags) {
  resident_body<MATCH, SHARED, N_GROUPS, false, SPLIT>(words, n_words, desc,
                                                       t, w, root, source,
                                                       counts, flags);
}

template <int MATCH, bool SHARED, int N_GROUPS, bool SPLIT>
__global__ void __launch_bounds__(kResidentThreads, SPLIT ? 1 : 4)
persistent_resident_kernel(const int4* __restrict__ words, int n_words,
                           const int32_t* __restrict__ desc, Tables t, Walk w,
                           int4* __restrict__ root,
                           int32_t* __restrict__ source, int32_t* counts,
                           int32_t* flags) {
  resident_body<MATCH, SHARED, N_GROUPS, true, SPLIT>(words, n_words, desc,
                                                      t, w, root, source,
                                                      counts, flags);
}

// K1's or K3 resident's instance of a (match, residency, group count,
// split).
template <int MATCH, bool SHARED, int N_GROUPS, bool PERSISTENT, bool SPLIT>
inline auto resident_kernel() {
  if constexpr (PERSISTENT) {
    return persistent_resident_kernel<MATCH, SHARED, N_GROUPS, SPLIT>;
  } else {
    return fused_resident_kernel<MATCH, SHARED, N_GROUPS, SPLIT>;
  }
}

// Launch attributes a process looks up once a kernel instance and device
// (the launchers ran them on every launch): the blocks the card keeps
// resident at a block shape, and the largest shared-memory opt-in made.
struct LaunchAttrs {
  const void* fn;
  int dev;
  int threads;
  size_t smem;
  int blocks;      // resident blocks (occupancy x SMs); 0 for an opt-in
  size_t opt_in;   // dynamic shared memory opted into (threads = -1)
};

inline std::mutex& attrs_mutex() {
  static std::mutex m;
  return m;
}

inline std::vector<LaunchAttrs>& attrs_cache() {
  static std::vector<LaunchAttrs> v;
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(attrs_mutex());
  for (LaunchAttrs& a : attrs_cache()) {
    if (a.fn == fn && a.dev == dev && a.threads == -1) {
      if (a.opt_in >= smem) return cudaSuccess;
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e == cudaSuccess) a.opt_in = smem;
      return e;
    }
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e == cudaSuccess) attrs_cache().push_back({fn, dev, -1, 0, 0, smem});
  return e;
}

// Blocks of `kernel` the card keeps resident at once (occupancy x SMs),
// at most `want`.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem, int want,
                          int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = current_sms(&dev, &sms);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int blocks = 0;
  {
    std::lock_guard<std::mutex> hold(attrs_mutex());
    for (const LaunchAttrs& a : attrs_cache()) {
      if (a.fn == fn && a.dev == dev && a.threads == threads &&
          a.smem == smem) {
        blocks = a.blocks;
        break;
      }
    }
    if (blocks == 0) {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      blocks = per_sm * sms;
      attrs_cache().push_back({fn, dev, threads, smem, blocks, 0});
    }
  }
  *grid = blocks < want ? blocks : want;
  return cudaSuccess;
}

// What the last resident launch of this thread picked.
struct LaunchShape {
  int lanes, grid, capacity;
};

inline LaunchShape& last_shape() {
  static thread_local LaunchShape s{0, 0, 0};
  return s;
}

// A resident launch: n_tiles tiles of block_b words (the ring's
// descriptors when desc is set) over the words' n_words rows.
struct ResidentArgs {
  const int4* words;
  int n_words;
  const int32_t* desc;
  int n_tiles;
  const int32_t* tri;
  int tri_n;
  const int32_t* quad;
  int quad_n;
  const int32_t* bi;
  int bi_n;
  int4* root;
  int32_t* source;
  int32_t* counts;
  int32_t* flags;
  int block_b;
  cudaStream_t stream;
};

// The launch: the lanes by the rule, the chosen instance's resident
// blocks, the walk.
template <int MATCH, bool SHARED, int N_GROUPS, bool PERSISTENT>
int launch_resident(const ResidentArgs& a) {
  int dev = 0, sms = 0;
  cudaError_t e = current_sms(&dev, &sms);
  if (e != cudaSuccess) return int(e);
  const long long words =
      PERSISTENT ? (long long)a.n_tiles * a.block_b : a.n_words;
#ifdef RT_FORCED_LANES
  // a measurement build (build.forced_lanes_library): every launch takes
  // RT_FORCED_LANES lanes a word, whatever the rule would pick
  const int lanes = RT_FORCED_LANES;
#else
  const int lanes = resident_lanes(words, sms);
#endif
  auto kernel =
      lanes > 1 ? resident_kernel<MATCH, SHARED, N_GROUPS, PERSISTENT, true>()
                : resident_kernel<MATCH, SHARED, N_GROUPS, PERSISTENT, false>();
  const size_t smem =
      resident_smem_bytes<SHARED, N_GROUPS>(a.tri_n, a.quad_n, a.bi_n);
  int capacity = 0;                  // K1 takes a block an item
  e = allow_smem(kernel, smem);
  if (PERSISTENT && e == cudaSuccess) {
    e = resident_grid(kernel, kResidentThreads, smem, INT_MAX, &capacity);
  }
  if (e != cudaSuccess) return int(e);
  const Walk w = PERSISTENT ? resident_walk(a.n_tiles, a.block_b,
                                            kResidentThreads, lanes, capacity,
                                            kMaxRounds)
                            : fused_walk(a.n_words, lanes);
  if (w.n_items < 0) return int(cudaErrorInvalidValue);
  const int grid =
      PERSISTENT && capacity < w.n_items ? capacity : w.n_items;
  last_shape() = {lanes, grid, capacity};
  const Tables t =
      make_tables<MATCH>(a.tri, a.tri_n, a.quad, a.quad_n, a.bi, a.bi_n);
  kernel<<<grid, kResidentThreads, smem, a.stream>>>(
      a.words, a.n_words, a.desc, t, w, a.root, a.source, a.counts,
      a.flags);
  return int(cudaGetLastError());
}

// Launch the instance of a (match, residency, group count).
template <bool PERSISTENT>
int dispatch_resident(const ResidentArgs& a, int n_groups, int match,
                      int dict_in_shared) {
  if (match == kMatchBsearch) {
    if (dict_in_shared) {
      return n_groups == 5
                 ? launch_resident<kMatchBsearch, true, 5, PERSISTENT>(a)
                 : launch_resident<kMatchBsearch, true, 2, PERSISTENT>(a);
    }
    return n_groups == 5
               ? launch_resident<kMatchBsearch, false, 5, PERSISTENT>(a)
               : launch_resident<kMatchBsearch, false, 2, PERSISTENT>(a);
  }
  if (dict_in_shared) {
    return n_groups == 5 ? launch_resident<kMatchBank, true, 5, PERSISTENT>(a)
                         : launch_resident<kMatchBank, true, 2, PERSISTENT>(a);
  }
  return n_groups == 5 ? launch_resident<kMatchBank, false, 5, PERSISTENT>(a)
                       : launch_resident<kMatchBank, false, 2, PERSISTENT>(a);
}

// Checks of a resident launch's arguments.
inline bool bad_resident(int block_b, int n_groups, int match) {
  return block_b < 1 || (n_groups != 2 && n_groups != 5) ||
         (match != kMatchBsearch && match != kMatchBank);
}

#endif  // __CUDACC__

}  // namespace rt
