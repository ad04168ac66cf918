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

}  // namespace rt
