// The streamed Compare: stage 5 of one word tile against a visit list of
// sorted dictionary tiles, shared by the streamed megakernel
// (stem_streamed.cu, K2) and the persistent kernel's streamed variant
// (stem_persistent.cu, K3), as the reference shares _ladder_sweep.
//
// The dictionary is the DictTileSet stream of kernels/stem_match.py: the
// tri, quad and bi tables each cut into tiles of tile_n = dict_block_r *
// 128 ints, sorted, sentinel-padded, one after the other. A word keeps its
// 30 candidate keys in registers and a 30-bit mask of live slots; a tile
// can only hit the live slots of the table it belongs to, whose keys fall
// in [tile[0], tile[tile_n - 1]]. Hits are OR-ed into a 30-bit mask, and
// the first hit in slot order is the root.
//
// The per-tile functions are __host__ __device__: a g++ build of this
// header (host_datapath.cpp) runs the same compare on the CPU for the
// tests. The pipelined sweep at the end is device code: tiles are copied
// global -> shared with cp.async into a ring of NB buffers, the copy of
// visit k + NB - 1 issued before visit k is compared.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "stem_datapath.cuh"

namespace rt {

RT_HD int sweep_log2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Table of a global tile id: 0 tri, 1 quad, 2 bi. Told from the id, not
// from the visit number: the visit list skips tiles.
RT_HD int tile_table(int t, int tri_tiles, int quad_tiles) {
  return int(t >= tri_tiles) + int(t >= tri_tiles + quad_tiles);
}

// Live-slot mask of a word: bit s set when slot s is valid.
template <int N_GROUPS>
RT_HD uint32_t live_mask(const bool valid[kSlots]) {
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < N_GROUPS * kCand; ++s) m |= uint32_t(valid[s]) << s;
  return m;
}

// Does any live slot of the tile's table fall in [lo, hi]?
template <int N_GROUPS>
RT_HD bool tile_in_range(const int32_t keys[kSlots], uint32_t live, int table,
                         int32_t lo, int32_t hi) {
  bool any = false;
#pragma unroll
  for (int s = 0; s < N_GROUPS * kCand; ++s) {
    any = any || (((live >> s) & 1u) && rt_group_dict(s / kCand) == table &&
                  keys[s] >= lo && keys[s] <= hi);
  }
  return any;
}

// Membership of key in the sorted tile d[0..n): lower-bound bisection in
// ceil(log2 n) steps (exact for any n >= 1), or a linear bank scan.
template <int MATCH>
RT_HD bool tile_member(const int32_t* d, int n, int steps, int32_t key) {
  if (MATCH == kMatchBank) {
    for (int i = 0; i < n; ++i) {
      if (d[i] == key) return true;
    }
    return false;
  }
  int lo = 0, hi = n - 1;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool ge = d[mid] >= key;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  return d[lo] == key;
}

// Compare the word's live slots of the tile's table that fall in the
// tile's range and have not hit yet; OR the hits into mask.
template <int MATCH, int N_GROUPS>
RT_HD uint32_t tile_hits(const int32_t* tile, int n, int steps, int table,
                         const int32_t keys[kSlots], uint32_t live,
                         uint32_t mask) {
  const int32_t lo = tile[0], hi = tile[n - 1];
#pragma unroll
  for (int s = 0; s < N_GROUPS * kCand; ++s) {
    if (((live & ~mask) >> s & 1u) && rt_group_dict(s / kCand) == table &&
        keys[s] >= lo && keys[s] <= hi &&
        tile_member<MATCH>(tile, n, steps, keys[s])) {
      mask |= 1u << s;
    }
  }
  return mask;
}

// Stage 5b: the first hit in slot order -> (packed key, source tag), both
// 0 when nothing hit.
RT_HD void first_hit(const int32_t keys[kSlots], uint32_t mask,
                     int32_t& chosen, int32_t& src) {
  chosen = 0;
  src = 0;
  if (mask == 0) return;
  int s = 0;
  while (!((mask >> s) & 1u)) ++s;
  chosen = keys[s];
  src = rt_group_tag(s / kCand);
}

#ifdef __CUDACC__

// 16-byte global -> shared copy, asynchronous (cp.async, cache global).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The whole block copies one tile (tile_n ints, a multiple of 128).
__device__ __forceinline__ void copy_tile(int32_t* dst,
                                          const int32_t* __restrict__ src,
                                          int tile_n) {
  for (int c = threadIdx.x; c < tile_n / 4; c += blockDim.x) {
    cp_async16(dst + 4 * c, src + 4 * c);
  }
}

// Sweep n visits of the tile list vis[] through NB shared buffers of
// tile_n ints each (bufs, 16-byte aligned). Every thread of the block
// calls it with its own word's keys and live mask and gets back its hit
// mask. Pad threads (live = 0) take part in every copy and barrier.
//
// Copy group j always carries visit j (empty groups are committed past
// the end), so after visit k's commit, waiting until NB - 1 groups are
// pending means visit k has landed; the barrier after it makes every
// thread's copies visible. A tile is compared only if some thread of
// the block has a live key in its range (a block-wide vote); the
// trailing barrier frees its buffer for the copy issued next.
template <int MATCH, int N_GROUPS, int NB>
__device__ __forceinline__ uint32_t sweep(
    const int32_t* __restrict__ stream, const int32_t* __restrict__ vis,
    int n, int tile_n, int steps, int tri_tiles, int quad_tiles,
    int32_t* bufs, const int32_t keys[kSlots], uint32_t live) {
  uint32_t mask = 0;
#pragma unroll
  for (int s = 0; s < NB - 1; ++s) {
    if (s < n) {
      copy_tile(bufs + s * tile_n, stream + size_t(__ldg(vis + s)) * tile_n,
                tile_n);
    }
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    const int look = k + NB - 1;
    if (look < n) {
      copy_tile(bufs + (look % NB) * tile_n,
                stream + size_t(__ldg(vis + look)) * tile_n, tile_n);
    }
    cp_async_commit();
    cp_async_wait<NB - 1>();
    __syncthreads();
    const int32_t* tile = bufs + (k % NB) * tile_n;
    const int table = tile_table(__ldg(vis + k), tri_tiles, quad_tiles);
    const bool mine = tile_in_range<N_GROUPS>(keys, live, table, tile[0],
                                              tile[tile_n - 1]);
    if (__syncthreads_or(mine)) {
      mask = tile_hits<MATCH, N_GROUPS>(tile, tile_n, steps, table, keys,
                                        live, mask);
    }
    __syncthreads();
  }
  return mask;
}

// Stages 1-5 of one block_b-word tile starting at row tile0, against its
// visit list: a thread holds one word at a time, and a tile wider than
// the block is covered in passes of blockDim.x words, each a sweep of the
// whole visit list (every thread runs the same number of passes, so the
// sweep's barriers stay uniform). Holding two words a thread in one sweep
// instead was 1.7x slower at 1M words on an H100 (chip_ab.py).
// Rows past the tile or past n_words are zero words with no live slot.
template <int MATCH, int N_GROUPS, int NB>
__device__ __forceinline__ void streamed_tile(
    const int4* __restrict__ words, int n_words, long long tile0,
    int block_b, const int32_t* __restrict__ stream,
    const int32_t* __restrict__ vis, int n, int tile_n, int tri_tiles,
    int quad_tiles, int32_t* bufs, int4* __restrict__ root,
    int32_t* __restrict__ source) {
  const int steps = sweep_log2(tile_n);
  for (int pass = 0; pass < block_b; pass += blockDim.x) {
    const int w = pass + threadIdx.x;
    const long long row = w < block_b && tile0 + w < n_words ? tile0 + w
                                                             : -1;
    int32_t word[kMaxLen];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 v = row >= 0 ? __ldg(words + 4 * row + k)
                              : make_int4(0, 0, 0, 0);
      word[4 * k + 0] = v.x;
      word[4 * k + 1] = v.y;
      word[4 * k + 2] = v.z;
      word[4 * k + 3] = v.w;
    }
    int32_t keys[kSlots];
    bool valid[kSlots];
    candidate_columns(word, keys, valid);
    const uint32_t mask = sweep<MATCH, N_GROUPS, NB>(
        stream, vis, n, tile_n, steps, tri_tiles, quad_tiles, bufs, keys,
        live_mask<N_GROUPS>(valid));
    if (row >= 0) {
      int32_t chosen, src;
      first_hit(keys, mask, chosen, src);
      root[row] = make_int4((chosen >> 18) & 63, (chosen >> 12) & 63,
                            (chosen >> 6) & 63, chosen & 63);
      source[row] = src;
    }
  }
}

#endif  // __CUDACC__

}  // namespace rt
