// The streamed Compare: stage 5 of one word against the DictTileSet
// stream, searched key by key from a fence level. Shared by the streamed
// megakernel (stem_streamed.cu, K2) and the persistent kernel's streamed
// variant (stem_persistent.cu, K3).
//
// The dictionary is the tile stream of kernels/stem_match.py: the tri,
// quad and bi tables each sorted and padded with the sentinel to whole
// tiles of tile_n ints, one after the other, so each table's part of the
// stream (its region) is sorted. The fence level holds entries 0, F, 2F,
// ... of every region (F a power of two >= 8), few enough for one
// block's shared memory. A live candidate key is searched in its own
// table only:
//   1. a branchless bisection of the table's fences finds the last fence
//      <= key; if there is none the key is below the table;
//   2. for F > 8, a bisection over the 8-entry blocks of that F-entry
//      segment (one global read a step) finds the block the key can be
//      in;
//   3. one 32-byte read of those 8 entries from global memory (L2 holds
//      the whole stream: 1 MB at 262,144 keys) and a compare.
// A region is sorted, so the key is in the table iff it is in that
// block: the reference's answer, a search of the tile the key lands in.
// Keys equal to a fence, below a table's first entry, above its last or
// equal to the sentinel padding get the answer the plain version gives.
//
// The slots of one candidate group share a table, so their searches run
// together, step by step: a thread keeps up to kSearchBatch reads in
// flight. Batches and groups go in priority order and stop after the
// first with a hit, since the first hit in slot order is the root.
//
// A block copies the fence level into shared memory with asynchronous
// copies (stage_begin, which the resident kernels share) and computes its
// threads' first words (stages 1-4) while they are in flight. Every
// function but the launch helpers, the staging and the word loads is
// __host__ __device__: a g++ build of this header (host_datapath.cpp)
// runs the same search for the CPU tests.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <atomic>
#endif

#include "stem_datapath.cuh"

namespace rt {

// Where each table's region and fences lie (table 0 tri, 1 quad, 2 bi).
struct FenceLayout {
  int base[3];    // first stream entry of the region
  int len[3];     // entries of the region, a multiple of 128
  int fbase[3];   // first fence of the table
  int nf[3];      // fences of the table: ceil(len / F)
  int log2f;      // F = 1 << log2f, at least 8
  int n_fences;   // fences of all three tables
};

RT_HD FenceLayout fence_layout(int tri_tiles, int quad_tiles, int bi_tiles,
                               int tile_n, int log2f) {
  const int tiles[3] = {tri_tiles, quad_tiles, bi_tiles};
  FenceLayout l;
  int base = 0, fbase = 0;
  for (int t = 0; t < 3; ++t) {
    l.base[t] = base;
    l.len[t] = tiles[t] * tile_n;
    l.fbase[t] = fbase;
    l.nf[t] = (l.len[t] + (1 << log2f) - 1) >> log2f;
    base += l.len[t];
    fbase += l.nf[t];
  }
  l.log2f = log2f;
  l.n_fences = fbase;
  return l;
}

// Live-slot mask of a word: bit s set when slot s is valid.
template <int N_GROUPS>
RT_HD uint32_t live_mask(const bool valid[kSlots]) {
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < N_GROUPS * kCand; ++s) m |= uint32_t(valid[s]) << s;
  return m;
}

// One stream entry, through the read-only cache on the card.
RT_HD int32_t stream_at(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Eight entries from a 16-byte aligned address: two 16-byte reads.
RT_HD void stream_block8(const int32_t* p, int32_t v[8]) {
#ifdef __CUDA_ARCH__
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
#else
  for (int i = 0; i < 8; ++i) v[i] = p[i];
#endif
}

// Is key among the 8 sorted entries v? bsearch: a lower bound in three
// halvings (selects, no indexed register array), then one compare; the
// bank: any of the 8 equal. The same answer.
template <int MATCH>
RT_HD bool block8_member(const int32_t v[8], int32_t key) {
  if (MATCH == kMatchBank) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) any = any || v[i] == key;
    return any;
  }
  const bool up = v[3] < key;
  const int32_t w0 = up ? v[4] : v[0], w1 = up ? v[5] : v[1];
  const int32_t w2 = up ? v[6] : v[2], w3 = up ? v[7] : v[3];
  const bool up2 = w1 < key;
  const int32_t x0 = up2 ? w2 : w0, x1 = up2 ? w3 : w1;
  return (x0 < key ? x1 : x0) == key;
}

// Slots of a group searched together: their reads are in flight at once.
constexpr int kSearchBatch = 2;

// The hits of group g's live slots (bits g*6 .. g*6+5 of the result):
// the three steps above, kSearchBatch keys at once, batches in slot order
// up to the first with a hit. fences points at the whole fence level
// (shared memory on the card), stream at the whole stream.
template <int MATCH>
RT_HD uint32_t group_hits(int g, const int32_t keys[kSlots], uint32_t live,
                          const int32_t* fences,
                          const int32_t* __restrict__ stream,
                          const FenceLayout& l) {
  constexpr int kB = kSearchBatch;
  const int t = rt_group_dict(g);
  const int32_t* f = fences + l.fbase[t];
  const int32_t* region = stream + l.base[t];
  uint32_t hits = 0;
#pragma unroll
  for (int q0 = 0; q0 < kCand; q0 += kB) {
    const int s0 = g * kCand + q0;
    if (hits != 0 || ((live >> s0) & ((1u << kB) - 1u)) == 0) continue;
    int32_t key[kB];
    int at[kB];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      key[q] = keys[s0 + q];
      at[q] = 0;
    }
    // 1. the last fence <= key (fence 0 when there is none)
    for (int n = l.nf[t]; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int q = 0; q < kB; ++q) {
        at[q] = f[at[q] + half] <= key[q] ? at[q] + half : at[q];
      }
      n -= half;
    }
    bool ok[kB];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      ok[q] = ((live >> (s0 + q)) & 1u) && f[at[q]] <= key[q];
      at[q] <<= l.log2f;               // the segment's first entry
    }
    // 2. the 8-entry block of the segment (blocks past the region's end
    //    read as above every key)
    for (int n = 1 << (l.log2f - 3); n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int q = 0; q < kB; ++q) {
        const int p = at[q] + 8 * half;
        at[q] = ok[q] && p < l.len[t] && stream_at(region + p) <= key[q]
                    ? p
                    : at[q];
      }
      n -= half;
    }
    // 3. the block's 8 entries
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if (ok[q]) {
        int32_t v[8];
        stream_block8(region + at[q], v);
        hits |= uint32_t(block8_member<MATCH>(v, key[q])) << (s0 + q);
      }
    }
  }
  return hits;
}

// The hit mask of a word's live slots, the groups in priority order up to
// the first with a hit (later groups cannot change the first hit).
template <int MATCH, int N_GROUPS>
RT_HD uint32_t fence_hits(const int32_t keys[kSlots], uint32_t live,
                          const int32_t* fences,
                          const int32_t* __restrict__ stream,
                          const FenceLayout& l) {
  uint32_t mask = 0;
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g) {
    if (mask == 0 && ((live >> (g * kCand)) & 0x3fu)) {
      mask = group_hits<MATCH>(g, keys, live, fences, stream, l);
    }
  }
  return mask;
}

// Stage 5b: the first hit in slot order -> (packed key, source tag), both
// 0 when nothing hit. Selects over the slots, no indexed register array.
RT_HD void first_hit(const int32_t keys[kSlots], uint32_t mask,
                     int32_t& chosen, int32_t& src) {
  const uint32_t low = mask & (~mask + 1u);
  chosen = 0;
  src = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if ((low >> s) & 1u) {
      chosen = keys[s];
      src = rt_group_tag(s / kCand);
    }
  }
}

// Stages 1-4 of one word: its 30 keys and the mask of its live slots.
template <int N_GROUPS>
RT_HD uint32_t word_keys(const int32_t w[kMaxLen], int32_t keys[kSlots]) {
  bool valid[kSlots];
  candidate_columns(w, keys, valid);
  return live_mask<N_GROUPS>(valid);
}

// Stage 5 of one word's keys against the fence level and the stream.
template <int MATCH, int N_GROUPS>
RT_HD void search_word(const int32_t keys[kSlots], uint32_t live,
                       const int32_t* fences,
                       const int32_t* __restrict__ stream,
                       const FenceLayout& l, int32_t& chosen, int32_t& src) {
  first_hit(keys, fence_hits<MATCH, N_GROUPS>(keys, live, fences, stream, l),
            chosen, src);
}

#ifdef __CUDACC__

// Devices whose SM count a process remembers.
constexpr int kMaxDevices = 64;

// The current device and its SMs, the count looked up once a device (a
// launcher asks on every launch).
inline cudaError_t current_sms(int* dev, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  const bool kept = *dev >= 0 && *dev < kMaxDevices;
  int n = kept ? known[*dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
    if (kept) known[*dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

// Threads a streamed block runs, whatever block_b is (no barrier sits in
// the search, so blocks need not match word tiles): at most
// kFenceThreads, at least kMinFenceThreads.
constexpr int kFenceThreads = 1024;
constexpr int kMinFenceThreads = 256;

// Threads a block of a launch over `words` words runs: the fewest (a
// power of two from kMinFenceThreads) whose blocks, one word a thread,
// take every word in one wave on the card's SMs, else kFenceThreads. A
// small launch spreads over more SMs; a large one keeps more warps an SM
// to hide the search's latency (the fences allow one block an SM).
inline cudaError_t fence_threads(long long words, int* threads) {
  int dev = 0, sms = 0;
  const cudaError_t e = current_sms(&dev, &sms);
  if (e != cudaSuccess) return e;
  int t = kMinFenceThreads;
  while (t < kFenceThreads && (words + t - 1) / t > sms) t *= 2;
  *threads = t;
  return cudaSuccess;
}

// Start copying n ints from global memory (src 16-byte aligned) to
// shared memory (dst 16-byte aligned): every thread issues its 16-byte
// asynchronous copies (cp.async, all in flight at once, none waited for)
// as one commit group, and copies its share of the ragged tail; the block
// can compute meanwhile. The copy is ready after stage_end. The fence
// level here and the resident tables (stem_resident.cuh) are staged by
// it.
__device__ __forceinline__ void stage_begin(int32_t* dst,
                                            const int32_t* __restrict__ src,
                                            int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + 4 * i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

// Wait for this thread's copies, then for the whole block's.
__device__ __forceinline__ void stage_end() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Start copying the fence level into dynamic shared memory; returns the
// copy, which is ready after stage_end.
__device__ __forceinline__ const int32_t* stage_fences_begin(
    const int32_t* __restrict__ fences, int n) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  stage_begin(smem, fences, n);
  return smem;
}

// Stages 1-4 of word row i (16 ints, four 16-byte loads).
template <int N_GROUPS>
__device__ __forceinline__ uint32_t load_word_keys(
    const int4* __restrict__ words, long long i, int32_t keys[kSlots]) {
  int32_t w[kMaxLen];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = __ldg(words + 4 * i + k);
    w[4 * k + 0] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  return word_keys<N_GROUPS>(w, keys);
}

#endif  // __CUDACC__

}  // namespace rt
