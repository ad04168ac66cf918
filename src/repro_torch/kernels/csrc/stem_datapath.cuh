// Stages 1-4 of the stemmer datapath for ONE word, shared by the CUDA
// megakernel (stem_fused.cu) and a host build the CPU tests check.
//
// Counterpart of repro/kernels/stem_datapath.py:candidate_columns. For a
// word row w[16] of dense 6-bit letter codes (0 = pad) it writes the 30
// packed 24-bit candidate keys and their validity flags, in group order:
//   [ 0: 6)  trilateral                    (dict: tri)
//   [ 6:12)  quadrilateral                 (dict: quad)
//   [12:18)  restored alef -> waw          (dict: tri)
//   [18:24)  remove-infix quad -> tri      (dict: tri)
//   [24:30)  remove-infix tri -> bi        (dict: bi)
// Within a group, slot q is prefix cut p = q - 1 (the VHDL loop order,
// which is also the match priority).
//
// The affix code sets, letter codes and group tags come from
// "stem_codes.h", which the build generates from the Python tables
// (repro_torch/core/alphabet.py, repro_torch/kernels/stem_fused.py).
#pragma once

#include <stdint.h>

#include "stem_codes.h"

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif

namespace rt {

constexpr int kMaxLen = RT_MAXLEN;
constexpr int kCand = 6;
constexpr int kSlots = 30;
// stage 5 strategies, in kernels/stem_fused.py:MATCHES order
constexpr int kMatchBsearch = 0;
constexpr int kMatchBank = 1;

// Membership in a generated 64-bit code-set mask; codes outside 0..63
// are members of no set (the reference compares for equality).
RT_HD bool member(uint64_t mask, int32_t c) {
  return static_cast<uint32_t>(c) < 64u && ((mask >> c) & 1ull);
}

// ((c0*64 + c1)*64 + c2)*64 + c3 with int32 wraparound, as jnp computes it.
RT_HD int32_t pack(int32_t c0, int32_t c1, int32_t c2, int32_t c3) {
  uint32_t k = static_cast<uint32_t>(c0);
  k = k * 64u + static_cast<uint32_t>(c1);
  k = k * 64u + static_cast<uint32_t>(c2);
  k = k * 64u + static_cast<uint32_t>(c3);
  return static_cast<int32_t>(k);
}

// Valid suffix start s: s == n (no suffix), or the suffix run holds at s.
RT_HD bool valid_s(int s, int n, const bool ps[kMaxLen],
                   const int32_t w[kMaxLen]) {
  if (s >= kMaxLen) return n == s;
  return (n == s) || (s < n && ps[s] && w[s] != 0);
}

RT_HD void candidate_columns(const int32_t w[kMaxLen], int32_t keys[kSlots],
                             bool valid[kSlots]) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j) n += (w[j] != 0);

  // stage 1+2: prefix run, an AND chain that ends after the first yeh
  bool pp[5];
  bool run = true, seen_yeh = false;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    run = run && member(RT_PREFIX_MASK, w[i]) && !seen_yeh;
    pp[i] = run;
    seen_yeh = seen_yeh || (w[i] == RT_YEH);
  }

  // stage 1+2: suffix run anchored at the word end (pads do not break it)
  bool ps[kMaxLen];
  run = true;
#pragma unroll
  for (int j = kMaxLen - 1; j >= 0; --j) {
    run = run && (member(RT_SUFFIX_MASK, w[j]) || w[j] == 0);
    ps[j] = run;
  }

  // stages 3+4: truncation grid, size filter, infix transforms, packing
#pragma unroll
  for (int q = 0; q < kCand; ++q) {
    const int p = q - 1;
    const bool p_ok = (p == -1) ? true : pp[p];
    const int32_t c0 = w[q], c1 = w[q + 1], c2 = w[q + 2], c3 = w[q + 3];
    const bool tv = p_ok && valid_s(p + 4, n, ps, w);
    const bool qv = p_ok && valid_s(p + 5, n, ps, w);
    const bool is_inf = member(RT_INFIX_MASK, c1);
    keys[q] = pack(c0, c1, c2, 0);
    valid[q] = tv;
    keys[6 + q] = pack(c0, c1, c2, c3);
    valid[6 + q] = qv;
    keys[12 + q] = pack(c0, RT_WAW, c2, 0);
    valid[12 + q] = tv && (c1 == RT_ALEF);
    keys[18 + q] = pack(c0, c2, c3, 0);
    valid[18 + q] = qv && is_inf;
    keys[24 + q] = pack(c0, c2, 0, 0);
    valid[24 + q] = tv && is_inf;
  }
}

// ---------------------------------------------------------------------------
// The same 30 slots split across a group of LANES lanes a word, for the
// standalone datapath (stem_candidates.cu, K6), whose output rows are 32
// columns: the 30 slots, then two zero pads. Lane j computes only the
// columns [j * 32 / LANES, (j + 1) * 32 / LANES), with no branch on the
// lane, so a warp's lanes run one instruction stream. The terms every
// slot reads (the length, the prefix and suffix runs, the alef and infix
// tests) come from a few bits a position; lane j classifies only the
// positions j, j + LANES, ... (lane_terms), the group ORs its lanes' bits
// (two words, log2 LANES shuffles on the card, the lanes in order on the
// host), and each lane folds them into one mask of valid slots
// (valid_mask). A slot's key is a sum of its window's codes shifted by
// its group (lane_columns). candidate_columns stays as it is: K1-K3 run
// it.

constexpr int kOutCols = 32;     // a K6 row: 30 slots + 2 zero pads
constexpr int kLead = 7;         // positions 0..6: the prefix run's five
                                 // and the six cuts' second letters
static_assert(kMaxLen <= 16, "two position masks fit one 32-bit word");

RT_HD int count_bits(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// 1 + the highest set bit's position; 0 for 0.
RT_HD int bit_length(uint32_t m) {
#ifdef __CUDA_ARCH__
  return 32 - __clz(m);
#else
  return m ? 32 - __builtin_clz(m) : 0;
#endif
}

// The lowest set bit's position of a nonzero mask.
RT_HD int low_zeros(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// A word's bits by position: pos = nz | suf << 16 (bit p: w[p] != 0;
// w[p] a suffix letter or a pad); lead = pre | yeh << 5 | alef << 10 |
// inf << 16 (bit p < 5: w[p] a prefix letter; w[p] == yeh; bit q < 6:
// w[q + 1] == alef; w[q + 1] an infix letter).
struct TermBits {
  uint32_t pos;
  uint32_t lead;
};

RT_HD TermBits merge(TermBits a, TermBits b) {
  return TermBits{a.pos | b.pos, a.lead | b.lead};
}

// The bits of positions lane, lane + LANES, ... of a word, whose codes
// are codes[m] = w[m * LANES + lane].
template <int LANES>
RT_HD TermBits lane_terms(const int32_t codes[kMaxLen / LANES], int lane) {
  TermBits t{0u, 0u};
#pragma unroll
  for (int m = 0; m < kMaxLen / LANES; ++m) {
    const int p = m * LANES + lane;
    const int32_t c = codes[m];
    t.pos |= (uint32_t(c != 0) |
              uint32_t(member(RT_SUFFIX_MASK, c) || c == 0) << 16) << p;
    if (m * LANES < kLead) {               // only the first positions lead
      const uint32_t pre = p < 5 ? (uint32_t(member(RT_PREFIX_MASK, c)) |
                                    uint32_t(c == RT_YEH) << 5) << p
                                 : 0u;
      const uint32_t cut = p >= 1 && p < kLead
                               ? (uint32_t(c == RT_ALEF) |
                                  uint32_t(member(RT_INFIX_MASK, c)) << 6)
                                     << (p - 1 + 10)
                               : 0u;
      t.lead |= pre | cut;
    }
  }
  return t;
}

// Bit s = 6 g + q set iff slot s is valid: candidate_columns' flags, from
// the whole word's bits.
RT_HD uint32_t valid_mask(TermBits t) {
  const uint32_t nz = t.pos & 0xffffu, suf = t.pos >> 16;
  const int n = count_bits(nz);
  // the suffix run holds at s iff s is past every code that breaks it
  const int after = bit_length(~suf & 0xffffu);
  // valid_s: bit s for s == n, or s < n with the run holding and w[s] != 0
  const uint32_t vs =
      (1u << n) | (nz & ((1u << n) - 1u) & ~((1u << after) - 1u));
  // the prefix run holds at i iff codes 0..i are prefix letters and none
  // before i is yeh: i < run_end; cut q's prefix is whole iff q <= run_end
  // (q = 0 has none)
  const uint32_t pre = t.lead & 31u, yeh = (t.lead >> 5) & 31u;
  const int other = low_zeros(~pre);                 // <= 5
  const int after_yeh = low_zeros(yeh | 32u) + 1;    // <= 6
  const int run_end = other < after_yeh ? other : after_yeh;
  const uint32_t p_ok = (2u << run_end) - 1u;        // bits 0..run_end
  const uint32_t tv = p_ok & (vs >> 3) & 63u;        // valid_s(q + 3)
  const uint32_t qv = p_ok & (vs >> 4) & 63u;        // valid_s(q + 4)
  const uint32_t alef = (t.lead >> 10) & 63u, inf = (t.lead >> 16) & 63u;
  return tv | qv << 6 | (tv & alef) << 12 | (qv & inf) << 18 |
         (tv & inf) << 24;
}

// The key of group g's slot on the window c0..c3 (= w[q..q+3]): pack()'s
// c0 * 2^18 + c1 * 2^12 + c2 * 2^6 + c3 with int32 wraparound, each group
// putting its own codes in those places; g 5 is a pad column, 0.
RT_HD int32_t slot_key(int g, int32_t c0, int32_t c1, int32_t c2,
                       int32_t c3) {
  const uint32_t hi = g <= 1 ? uint32_t(c1)
                             : (g == 2 ? uint32_t(RT_WAW) : uint32_t(c2));
  const uint32_t mid = g <= 2 ? uint32_t(c2) : (g == 3 ? uint32_t(c3) : 0u);
  const uint32_t lo = g == 1 ? uint32_t(c3) : 0u;
  const uint32_t k = (uint32_t(c0) << 18) + (hi << 12) + (mid << 6) + lo;
  return g < kSlots / kCand ? int32_t(k) : 0;
}

// One of three values by a lane's first cut q0 (0, 2 or 4).
RT_HD int32_t by_cut(int q0, int32_t a, int32_t b, int32_t c) {
  return q0 == 0 ? a : (q0 == 2 ? b : c);
}

// Lane `lane` of LANES (1, 2, 4 or 8)'s columns of a K6 row, from the
// word's first codes w[0..8] and its valid_mask v: keys and valid (0/1)
// of columns lane * C .. lane * C + C - 1, C = 32 / LANES. Column c is
// slot (g, q) = (c / 6, c % 6). The lane's first column is even and so is
// 6, so its first cut q0 is 0, 2 or 4; for each of the three, column k's
// window sits at fixed positions, so a lane picks its codes with two
// selects and indexes no register array.
template <int LANES>
RT_HD void lane_columns(const int32_t w[kMaxLen], uint32_t v, int lane,
                        int32_t keys[kOutCols / LANES],
                        int32_t valid[kOutCols / LANES]) {
  static_assert(LANES == 1 || LANES == 2 || LANES == 4 || LANES == 8,
                "1, 2, 4 or 8 lanes a word");
  constexpr int C = kOutCols / LANES;
  const int first = lane * C;
  const int q0 = first % kCand, g0 = first / kCand;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    int32_t c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = by_cut(q0, w[k % kCand + i], w[(k + 2) % kCand + i],
                    w[(k + 4) % kCand + i]);
    }
    const int g = g0 + by_cut(q0, k / kCand, (k + 2) / kCand,
                              (k + 4) / kCand);
    keys[k] = slot_key(g, c[0], c[1], c[2], c[3]);
    valid[k] = int32_t((v >> (first + k)) & 1u);
  }
}

// K6's lanes a word for `words` words on a card of `sms` SMs: 8 at every
// size. With the terms shared by shuffles, 8 lanes won at every shape
// timed on an H100, from a pipeline tick (128 words) to 1,048,576 words
// (PERF.md section 6): a warp store writes whole 512-byte runs of rows,
// and a lane's share of a word is the shortest. 1, 2 and 4 lanes store
// 16-byte pieces of rows 128, 64 and 32 bytes apart; the measurement
// builds still take them.
RT_HD int candidate_lanes(long long words, int sms) {
  (void)words;
  (void)sms;
  return 8;
}

}  // namespace rt
