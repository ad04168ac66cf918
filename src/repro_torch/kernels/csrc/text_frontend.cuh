// The text front end's per-word rules, shared by the CUDA kernel
// (text_frontend.cu, K4) and a host build the CPU tests check bit for bit
// against the plain version (kernels/text_frontend.py).
//
// Counterpart of the body of repro/kernels/text_frontend.py:
// _frontend_kernel and of repro/core/textnorm.py:strip_and_pack. For one
// word, given its first codepoint's index and its raw length in the
// codepoint tile: read at most MAX_RAW raw codepoints, classify each
// through CLASS_LUT (anything off the 0x0600 page is a separator), keep
// the first CMAX letters left-aligned (marks, class -1, are deleted, not
// split on), then strip one proclitic and one enclitic (first match in
// the longest-first pattern lists, each only if MIN_STEM letters remain;
// never from a function word, found by bisection over FW_FLAT) and keep
// at most 15 letters of the stem in the int32[16] word row.
//
// Every array is indexed by compile-time constants once the loops are
// unrolled (compaction by a shift register, reads at a data-dependent
// column by a one-hot select), so nothing spills to local memory. The
// clitic tables, windows and codes come from "text_codes.h", which the
// build generates from repro_torch/core/textnorm.py.
#pragma once

#include <stdint.h>

#include "stem_codes.h"
#include "text_codes.h"

#ifdef __CUDACC__
#define TF_HD __host__ __device__ __forceinline__
#else
#define TF_HD inline
#endif

namespace tf {

constexpr int kMaxRaw = RT_TEXT_MAX_RAW;
constexpr int kCmax = RT_TEXT_CMAX;
constexpr int kMinStem = RT_TEXT_MIN_STEM;
constexpr int kFwMaxLen = RT_TEXT_FW_MAXLEN;
constexpr int kMaxPro = RT_TEXT_MAX_PRO;
constexpr int kRow = RT_MAXLEN;
constexpr int kLutSize = 256;
static_assert(kRow - 1 + kMaxPro < kCmax, "every shifted window must fit");

// Read-only load: through the read-only data cache on the card.
TF_HD int32_t load(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Codepoint at index pos of a tile of t codepoints, 0-padded to tp (a
// multiple of 128): pos is clamped into [0, tp - 1] as the reference's
// take(mode="clip") over the lane-padded tile clamps it, and the padding
// reads 0.
TF_HD int32_t window_at(const int32_t* chars, long long t, long long tp,
                        long long pos) {
  pos = pos < 0 ? 0 : pos > tp - 1 ? tp - 1 : pos;
  return pos < t ? load(chars + pos) : 0;
}

// Class of a codepoint: the letter's dense code (> 0), -1 for a mark, 0
// for a separator; only the 0x0600 page is looked up.
TF_HD int32_t classify(int32_t cp, const int32_t* lut) {
  const int32_t off = cp - 0x0600;
  return off >= 0 && off < kLutSize ? lut[off] : 0;
}

TF_HD int ceil_log2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Branchless bisection over the sorted, sentinel-padded pow2 table fw
// (fw_n entries, steps = ceil(log2 fw_n)), each probe clamped into
// [0, fw_n - 1]: the port's stem_match.bsearch_hit.
TF_HD bool fw_hit(const int32_t* fw, int fw_n, int steps, int32_t key) {
  int lo = 0, hi = fw_n - 1;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const int m = mid < 0 ? 0 : mid > fw_n - 1 ? fw_n - 1 : mid;
    const bool ge = fw[m] >= key;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  const int l = lo < 0 ? 0 : lo > fw_n - 1 ? fw_n - 1 : lo;
  return fw[l] == key;
}

// codes[pos], 0 for a column outside [0, kCmax): the reference reads it
// as a one-hot sum, so a negative or past-the-end column reads 0. The
// select keeps codes[] in registers.
TF_HD int32_t code_at(const int32_t codes[kCmax], int pos) {
  int32_t v = 0;
#pragma unroll
  for (int q = 0; q < kCmax; ++q) v = q == pos ? codes[q] : v;
  return v;
}

// Letters -> the stripped, packed word row (strip_and_pack for one row).
TF_HD void strip_and_pack(const int32_t codes[kCmax], int n,
                          const int32_t* fw, int fw_n, int fw_steps,
                          int32_t out[kRow]) {
  const int32_t key5 =
      (((codes[0] * 64 + codes[1]) * 64 + codes[2]) * 64 + codes[3]) * 64 +
      codes[4];
  const bool exempt = n <= kFwMaxLen && fw_hit(fw, fw_n, fw_steps, key5);

  // {length, code 0, code 1, code 2}, longest first (match priority)
  constexpr int8_t kPro[RT_TEXT_N_PRO][4] = RT_TEXT_PROCLITICS;
  constexpr int8_t kEnc[RT_TEXT_N_ENC][4] = RT_TEXT_ENCLITICS;

  int pro = 0;
  bool found = exempt;
#pragma unroll
  for (int p = 0; p < RT_TEXT_N_PRO; ++p) {
    const int ln = kPro[p][0];
    bool m = n - ln >= kMinStem;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < ln) m = m && codes[k] == kPro[p][1 + k];
    }
    pro = m && !found ? ln : pro;
    found = found || m;
  }

  // an enclitic of length ln has its letter k at column n - ln + k,
  // counted from the left whatever the proclitic cut: tail[d] is the
  // letter d columns from the end
  const int32_t tail[4] = {0, code_at(codes, n - 1), code_at(codes, n - 2),
                           code_at(codes, n - 3)};
  const int rem = n - pro;
  int enc = 0;
  found = exempt;
#pragma unroll
  for (int e = 0; e < RT_TEXT_N_ENC; ++e) {
    const int ln = kEnc[e][0];
    bool m = rem - ln >= kMinStem;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < ln) m = m && tail[ln - k] == kEnc[e][1 + k];
    }
    enc = m && !found ? ln : enc;
    found = found || m;
  }

  const int keep = rem - enc < kRow - 1 ? rem - enc : kRow - 1;
#pragma unroll
  for (int q = 0; q < kRow; ++q) {
    int32_t v = codes[q];
#pragma unroll
    for (int p = 1; p <= kMaxPro; ++p) v = pro == p ? codes[q + p] : v;
    out[q] = q < keep ? v : 0;
  }
}

// One word of the tile: raw window at [start, start + len) -> word row.
// The window is walked from its end and each letter pushed in at the
// front, so the first kCmax letters stay, left-aligned, in registers.
TF_HD void word_row(const int32_t* chars, long long t, long long tp,
                    int32_t start, int32_t len, const int32_t* lut,
                    const int32_t* fw, int fw_n, int fw_steps,
                    int32_t out[kRow]) {
  const int live = len < 0 ? 0 : len < kMaxRaw ? len : kMaxRaw;
  int32_t codes[kCmax];
#pragma unroll
  for (int q = 0; q < kCmax; ++q) codes[q] = 0;
  int n = 0;
#pragma unroll
  for (int j = kMaxRaw - 1; j >= 0; --j) {
    const int32_t cls =
        j < live ? classify(window_at(chars, t, tp, (long long)start + j),
                            lut)
                 : 0;
    const bool letter = cls > 0;
    n += letter;
#pragma unroll
    for (int q = kCmax - 1; q > 0; --q) codes[q] = letter ? codes[q - 1] : codes[q];
    codes[0] = letter ? cls : codes[0];
  }
  strip_and_pack(codes, n < kCmax ? n : kCmax, fw, fw_n, fw_steps, out);
}

}  // namespace tf
