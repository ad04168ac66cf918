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
// Two forms of the same rules:
//   - one lane a word (word_row): the window walked from its end through
//     a CMAX-entry shift register, every array indexed by compile-time
//     constants once the loops are unrolled, so nothing spills;
//   - G = 8 lanes a word (lane_word, MAX_RAW / G positions a lane): one
//     body over a group policy, WarpLanes on the card (a thread a lane,
//     __ballot_sync and __shfl_sync) and HostLanes in the host build
//     (every lane's value at once, the vote and the shuffle over the
//     lanes in order), so the CPU tests run the code the card runs.
// Which G a launch takes, and how a launch's blocks split and write its
// rows, are here too (frontend_lanes, the piece walk, list_rows,
// clear_lane), so the host build runs the launch as the card does. The
// clitic tables, windows and codes come from "text_codes.h", which the
// build generates from repro_torch/core/textnorm.py.
#pragma once

#include <stdint.h>

#include "stem_codes.h"
#include "text_codes.h"

#ifdef __CUDACC__
#define TF_HD __host__ __device__ __forceinline__
#define TF_CX __host__ __device__ constexpr
#else
#define TF_HD inline
#define TF_CX constexpr
#endif

namespace tf {

constexpr int kMaxRaw = RT_TEXT_MAX_RAW;
constexpr int kCmax = RT_TEXT_CMAX;
constexpr int kMinStem = RT_TEXT_MIN_STEM;
constexpr int kFwMaxLen = RT_TEXT_FW_MAXLEN;
constexpr int kMaxPro = RT_TEXT_MAX_PRO;
constexpr int kRow = RT_MAXLEN;
constexpr int kLutSize = 256;
constexpr int kNPro = RT_TEXT_N_PRO;
constexpr int kNEnc = RT_TEXT_N_ENC;
static_assert(kRow - 1 + kMaxPro < kCmax, "every shifted window must fit");
static_assert(kMaxRaw == 32, "a word's raw window is one warp of lanes");

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
// The window is walked from its end (from its last position, not
// MAX_RAW's) and each letter pushed in at the front, so the first kCmax
// letters stay, left-aligned, in registers.
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
    if (j >= live) continue;           // past the word: nothing to shift in
    const int32_t cls =
        classify(window_at(chars, t, tp, (long long)start + j), lut);
    const bool letter = cls > 0;
    n += letter;
#pragma unroll
    for (int q = kCmax - 1; q > 0; --q) codes[q] = letter ? codes[q - 1] : codes[q];
    codes[0] = letter ? cls : codes[0];
  }
  strip_and_pack(codes, n < kCmax ? n : kCmax, fw, fw_n, fw_steps, out);
}

// ---------------------------------------------------------------------------
// G lanes a word
// ---------------------------------------------------------------------------
// Threads of a K4 block, whatever G; rows come in pieces of kPieceRows
// (a piece's rows are one warp store of 512 bytes), kThreads / G pieces a
// block (one a group of lanes). G is 1 or 8: at the tiles timed G = 16
// and 32 took longer than 8 (more shuffles and votes a word) and G = 4
// longer than 1 or 8, and no launch of the port has fewer rows than a
// served request's tile, where 8 wins.
constexpr int kThreads = 256;
constexpr int kPieceRows = 8;

// The launch's lanes a word: 8 below sms x kFillRowLanes rows, else 1:
// G = 8 at a served request's 32,896 rows, G = 1 from 135,168 rows on
// 132 SMs (an index chunk's tile, the 1M-word tile), where one lane a
// word has words enough to hide its latency and issues the fewest
// instructions a word. Set from K4 timed at both G on either side of the
// threshold (chip_smoke.py phase 9, through
// build.forced_text_lanes_library).
constexpr long long kFillRowLanes = 1024;

TF_HD int frontend_lanes(long long rows, int sms) {
  return rows >= sms * kFillRowLanes ? 1 : 8;
}

// The piece walk: block b of `grid` takes pieces b, b + grid, ...
// (kThreads / G of them), so the words of a tile whose live rows form a
// prefix spread over every block.
TF_HD long long n_pieces(long long rows) {
  return (rows + kPieceRows - 1) / kPieceRows;
}

TF_HD long long frontend_grid(long long rows, int lanes) {
  const long long per = kThreads / lanes;
  return (n_pieces(rows) + per - 1) / per;
}

TF_HD long long piece_of(long long block, int k, long long grid) {
  return block + k * grid;
}

// Piece p's rows: bit i of the result set when row 8p + i exists and has
// a length > 0, whose start and length go to start[i], len[i]; a whole
// piece of 16-byte aligned geometry is four 16-byte loads, issued
// together.
TF_HD uint32_t piece_rows(const int32_t* starts, const int32_t* lens,
                          long long rows, long long p,
                          int32_t start[kPieceRows], int32_t len[kPieceRows]) {
  const long long r0 = p * kPieceRows;
#ifdef __CUDA_ARCH__
  if (r0 + kPieceRows <= rows &&
      (reinterpret_cast<uintptr_t>(lens) | reinterpret_cast<uintptr_t>(starts)) %
              16 == 0) {
    const int4* l4 = reinterpret_cast<const int4*>(lens + r0);
    const int4* s4 = reinterpret_cast<const int4*>(starts + r0);
    const int4 la = __ldg(l4), lb = __ldg(l4 + 1);
    const int4 sa = __ldg(s4), sb = __ldg(s4 + 1);
    const int32_t lv[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
    const int32_t sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
    for (int i = 0; i < kPieceRows; ++i) len[i] = lv[i], start[i] = sv[i];
  } else
#endif
  {
#pragma unroll
    for (int i = 0; i < kPieceRows; ++i) {
      const bool in = r0 + i < rows;
      len[i] = in ? load(lens + r0 + i) : 0;
      start[i] = in ? load(starts + r0 + i) : 0;
    }
  }
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < kPieceRows; ++i) m |= uint32_t(len[i] > 0) << i;
  return m;
}

TF_HD int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Position of set bit k (0-based, k < popc(m)) of m: the card's find-nth
// (__fns), on the host a bisection over the counts of the low halves.
TF_HD int nth_set_bit(uint32_t m, int k) {
#ifdef __CUDA_ARCH__
  return int(__fns(m, 0, k + 1));
#endif
  int p = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = popc(m & ((1u << w) - 1u));
    const bool up = k >= c;
    k = up ? k - c : k;
    m = up ? m >> w : m;
    p = up ? p + w : p;
  }
  return p;
}

// The per-lane shape of a G-lane word.
template <int G>
struct Lanes {
  static constexpr int kPos = kMaxRaw / G;              // positions a lane
  static constexpr int kSlots = (kCmax + G - 1) / G;    // letter columns
  static constexpr int kOut = (kRow + G - 1) / G;       // row columns
  static constexpr int kPro = (kNPro + G - 1) / G;      // proclitics
  static constexpr int kEnc = (kNEnc + G - 1) / G;      // enclitics
  static constexpr uint32_t kLow = G == 32 ? 0xffffffffu : (1u << G) - 1u;
};

// Raw length clamped into [0, kMaxRaw].
TF_HD int live_len(int32_t len) {
  return len < 0 ? 0 : len < kMaxRaw ? len : kMaxRaw;
}

// Class of position pos of the window (0 past the word's length).
TF_HD int32_t lane_class(const int32_t* chars, long long t, long long tp,
                         int32_t start, int live, const int32_t* lut,
                         int pos) {
  return pos < live
             ? classify(window_at(chars, t, tp, (long long)start + pos), lut)
             : 0;
}

// Letter count (at most kCmax) of a window's letter mask.
TF_HD int letters(uint32_t mask) {
  const int n = popc(mask);
  return n < kCmax ? n : kCmax;
}

// Window position of letter column k, -1 past the kept letters.
TF_HD int letter_pos(uint32_t mask, int k, int n) {
  return k < n ? nth_set_bit(mask, k) : -1;
}

// Clitic p as one word: length | code 0 << 8 | code 1 << 16 | code 2 << 24
// (codes < 64), by selects over the generated table; 0 past the list.
TF_HD uint32_t pro_pattern(int p) {
  constexpr int8_t kPro[kNPro][4] = RT_TEXT_PROCLITICS;
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < kNPro; ++q) {
    const uint32_t v = uint32_t(kPro[q][0]) | uint32_t(kPro[q][1]) << 8 |
                       uint32_t(kPro[q][2]) << 16 | uint32_t(kPro[q][3]) << 24;
    w = q == p ? v : w;
  }
  return w;
}

TF_HD uint32_t enc_pattern(int e) {
  constexpr int8_t kEnc[kNEnc][4] = RT_TEXT_ENCLITICS;
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < kNEnc; ++q) {
    const uint32_t v = uint32_t(kEnc[q][0]) | uint32_t(kEnc[q][1]) << 8 |
                       uint32_t(kEnc[q][2]) << 16 | uint32_t(kEnc[q][3]) << 24;
    w = q == e ? v : w;
  }
  return w;
}

// Do a clitic's letters match (w its pattern word, pro_pattern or
// enc_pattern; 0 for none)? A proclitic's letter k is column k (c0 c1 c2
// the word's first letters), an enclitic's letter k of ln is column n -
// ln + k, tail d = ln - k (t1 the word's last letter, t2, t3). Letters
// only: whether the cut leaves kMinStem letters is fitting()'s.
TF_HD bool pro_letters(uint32_t w, int32_t c0, int32_t c1, int32_t c2) {
  const int ln = int(w & 0xff);
  return ln > 0 && c0 == int32_t((w >> 8) & 0xff) &&
         (ln < 2 || c1 == int32_t((w >> 16) & 0xff)) &&
         (ln < 3 || c2 == int32_t((w >> 24) & 0xff));
}

TF_HD bool enc_letters(uint32_t w, int32_t t1, int32_t t2, int32_t t3) {
  const int ln = int(w & 0xff);
  // letter k is tail ln - k: scalars picked by the length (an indexed
  // array would go to local memory)
  const int32_t first = ln == 1 ? t1 : ln == 2 ? t2 : t3;
  const int32_t second = ln == 2 ? t1 : t2;
  return ln > 0 && first == int32_t((w >> 8) & 0xff) &&
         (ln < 2 || second == int32_t((w >> 16) & 0xff)) &&
         (ln < 3 || t1 == int32_t((w >> 24) & 0xff));
}

// The patterns of a table exactly (exact) or at most `len` letters long,
// as a mask over the table (evaluated at compile time).
template <int N>
TF_CX uint32_t len_mask(const int8_t (&t)[N][4], int len, bool exact) {
  uint32_t m = 0;
  for (int q = 0; q < N; ++q) {
    m |= uint32_t(exact ? t[q][0] == len : t[q][0] <= len) << q;
  }
  return m;
}

// The cut: the length of the first clitic (in the list's longest-first
// order) whose letters match (letter_bits) and that leaves kMinStem of
// `left` letters, 0 for none: the lowest bit of the matches that fit,
// its length told by the table's masks of each length (le_k: at most k
// letters, eq_k: exactly k).
TF_HD int cut(uint32_t letter_bits, int left, uint32_t le1, uint32_t le2,
              uint32_t le3, uint32_t eq2, uint32_t eq3) {
  const int most = left - kMinStem;
  const uint32_t fit = most >= 3   ? le3
                       : most == 2 ? le2
                       : most == 1 ? le1
                                   : 0u;
  const uint32_t bits = letter_bits & fit;
  const uint32_t low = bits & (~bits + 1u);
  return (low & eq3) ? 3 : (low & eq2) ? 2 : low ? 1 : 0;
}

TF_HD int pro_cut(uint32_t letter_bits, int left) {
  constexpr int8_t kPro[kNPro][4] = RT_TEXT_PROCLITICS;
  constexpr uint32_t le1 = len_mask(kPro, 1, false);
  constexpr uint32_t le2 = len_mask(kPro, 2, false);
  constexpr uint32_t le3 = len_mask(kPro, 3, false);
  constexpr uint32_t eq2 = len_mask(kPro, 2, true);
  constexpr uint32_t eq3 = len_mask(kPro, 3, true);
  return cut(letter_bits, left, le1, le2, le3, eq2, eq3);
}

TF_HD int enc_cut(uint32_t letter_bits, int left) {
  constexpr int8_t kEnc[kNEnc][4] = RT_TEXT_ENCLITICS;
  constexpr uint32_t le1 = len_mask(kEnc, 1, false);
  constexpr uint32_t le2 = len_mask(kEnc, 2, false);
  constexpr uint32_t le3 = len_mask(kEnc, 3, false);
  constexpr uint32_t eq2 = len_mask(kEnc, 2, true);
  constexpr uint32_t eq3 = len_mask(kEnc, 3, true);
  return cut(letter_bits, left, le1, le2, le3, eq2, eq3);
}

// Is key one of the function-word table's entries i = lane, lane + G, ...
// (fw_n of them, sorted)? The group's vote over its lanes is fw_hit's
// answer.
TF_HD bool fw_slice_hit(const int32_t* fw, int fw_n, int lane, int g,
                        int32_t key) {
  bool hit = false;
  for (int i = lane; i < fw_n; i += g) hit = hit || fw[i] == key;
  return hit;
}

// The packed 5-letter key the function-word table holds.
TF_HD int32_t fw_key(int32_t c0, int32_t c1, int32_t c2, int32_t c3,
                     int32_t c4) {
  return (((c0 * 64 + c1) * 64 + c2) * 64 + c3) * 64 + c4;
}

// The letters kept: the stem after both cuts, at most kRow - 1.
TF_HD int kept(int n, int pro, int enc) {
  const int k = n - pro - enc;
  return k < kRow - 1 ? k : kRow - 1;
}

// ---------------------------------------------------------------------------
// A block's rows
// ---------------------------------------------------------------------------
// Append piece p's live rows (mask m, their starts and lengths) to the
// block's list at `at` on: the list holds the live rows in piece order.
TF_HD void list_rows(uint32_t m, long long p, const int32_t start[kPieceRows],
                     const int32_t len[kPieceRows], int at, int32_t* list,
                     int32_t* list_start, int32_t* list_len) {
#pragma unroll
  for (int i = 0; i < kPieceRows; ++i) {
    if ((m >> i) & 1) {
      list[at] = int32_t(p * kPieceRows + i);
      list_start[at] = start[i];
      list_len[at] = len[i];
      ++at;
    }
  }
}

// Lane `lane` of the warp that writes piece p's empty rows: the lane's
// 16 bytes of the piece's 512 (row lane / 4), zeroed unless that row is
// live (bit lane / 4 of m) or past the launch's rows.
TF_HD void clear_lane(int32_t* words, long long rows, long long pieces,
                      long long p, uint32_t m, int lane) {
  const long long r = p * kPieceRows + lane / 4;
  if (p >= pieces || r >= rows || ((m >> (lane / 4)) & 1)) return;
  int32_t* q = words + 4 * (p * 4 * kPieceRows + lane);
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(q) = make_int4(0, 0, 0, 0);
#else
  q[0] = q[1] = q[2] = q[3] = 0;
#endif
}

// ---------------------------------------------------------------------------
// A word by a group of G lanes
// ---------------------------------------------------------------------------
// v[i] by selects (v stays in registers); 0 outside [0, N). The card's
// group policy reads a lane's letter columns through it: the same selects
// written inside a lambda became an indexed load from a local array.
template <int N>
TF_HD int32_t pick(const int32_t (&v)[N], int i) {
  int32_t out = 0;
#pragma unroll
  for (int q = 0; q < N; ++q) out = q == i ? v[q] : out;
  return out;
}

// The group policies lane_word runs on. A lane value (Val<T>) is one T a
// lane; each(f) is f(l) on lane l, at(v, l) lane l's entry of v (inside
// each), vote(v) the lanes' predicates as bits (lane l's as bit l),
// shfl(v, src) on lane l the value of v on lane src(l), from(v, src) the
// value of v on lane src, the same on every lane, pick(a, i) each lane's
// entry i of its array a (0 outside it), run(f) f(l) for its effects.
#ifdef __CUDACC__
// On the card: a thread is one lane of its group (G consecutive lanes of
// a warp), a lane value is the thread's own; every lane of the warp
// calls each vote and shuffle together.
template <int G>
struct WarpLanes {
  static constexpr int kG = G;
  template <class T>
  using Val = T;
  int lane, base;
  __device__ __forceinline__ WarpLanes()
      : lane(int(threadIdx.x) % G), base(int(threadIdx.x) % 32 - lane) {}
  template <class F>
  __device__ __forceinline__ auto each(F f) const {
    return f(lane);
  }
  template <class F>
  __device__ __forceinline__ void run(F f) const {
    f(lane);
  }
  template <class T>
  static __device__ __forceinline__ T at(const T& v, int) {
    return v;
  }
  __device__ __forceinline__ uint32_t vote(bool v) const {
    return (__ballot_sync(0xffffffffu, v) >> base) & Lanes<G>::kLow;
  }
  template <class T>
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, G);
  }
  template <class T>
  __device__ __forceinline__ T from(T v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, G);
  }
  template <int N>
  __device__ __forceinline__ int32_t pick(const int32_t (&a)[N],
                                          int i) const {
    return tf::pick<N>(a, i);
  }
};
#else
// On the host: a lane value holds every lane's value, and each step runs
// the lanes in order.
template <int G>
struct HostLanes {
  static constexpr int kG = G;
  template <class T>
  struct Val {
    T v[G];
  };
  template <class F>
  auto each(F f) const {
    Val<decltype(f(0))> r;
    for (int l = 0; l < G; ++l) r.v[l] = f(l);
    return r;
  }
  template <class F>
  void run(F f) const {
    for (int l = 0; l < G; ++l) f(l);
  }
  template <class T>
  static T at(const Val<T>& v, int l) {
    return v.v[l];
  }
  uint32_t vote(const Val<bool>& v) const {
    uint32_t m = 0;
    for (int l = 0; l < G; ++l) m |= uint32_t(v.v[l]) << l;
    return m;
  }
  template <class T>
  Val<T> shfl(const Val<T>& v, const Val<int>& src) const {
    Val<T> r;
    for (int l = 0; l < G; ++l) r.v[l] = v.v[src.v[l]];
    return r;
  }
  template <class T>
  T from(const Val<T>& v, int src) const {
    return v.v[src];
  }
  template <int N>
  Val<int32_t> pick(const Val<int32_t> (&a)[N], int i) const {
    Val<int32_t> r;
    for (int l = 0; l < G; ++l) {
      r.v[l] = 0;
      for (int q = 0; q < N; ++q) r.v[l] = q == i ? a[q].v[l] : r.v[l];
    }
    return r;
  }
};
#endif

// Letter column c of a G-lane word (the same c on every lane), 0 for c <
// 0: code[c / G] of lane c % G.
template <class Grp, int S>
TF_HD int32_t column(const Grp& g,
                     const typename Grp::template Val<int32_t> (&code)[S],
                     int c) {
  constexpr int G = Grp::kG;
  const int cc = c < 0 ? 0 : c;
  const int32_t v = g.from(g.pick(code, cc / G), cc % G);
  return c < 0 ? 0 : v;
}

// One word by the G lanes of a group (G > 1; on the card every lane of
// the warp calls it together, a group without a word with len 0 and
// store false): the row of the word at [start, start + len) into row.
//   1. lane l reads window positions l + G i and classifies them; a vote
//      a round gives the letters' mask, n its count (at most kCmax);
//   2. letter column l + G s is gathered from the lane that read its
//      position (the mask's set bit of that rank), a shuffle a round;
//   3. the clitic letters are tested a pattern a lane (lane l patterns l
//      + G i, longest first), each list's matches a vote, and the
//      function-word table a slice a lane (one step of independent loads
//      for the bisection's seven dependent ones), its answer a vote;
//   4. the cuts are the lowest matches that fit (pro_cut, enc_cut), and
//      row column l + G i (letter column + pro) is shuffled from its
//      lane and stored: a row's 16 columns by 16 stores of the group,
//      one 64-byte segment.
template <class Grp>
TF_HD void lane_word(const Grp& g, const int32_t* chars, long long t,
                     long long tp, int32_t start, int32_t len,
                     const int32_t* lut, const int32_t* fw, int fw_n,
                     bool store, int32_t* row) {
  constexpr int G = Grp::kG;
  using L = Lanes<G>;
  using VI = typename Grp::template Val<int32_t>;
  const int live = live_len(len);
  // 1. the window, and the letters' mask
  VI cls[L::kPos];
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < L::kPos; ++i) {
    cls[i] = g.each([&](int l) {
      return lane_class(chars, t, tp, start, live, lut, l + G * i);
    });
    mask |= g.vote(g.each([&](int l) { return g.at(cls[i], l) > 0; }))
            << (G * i);
  }
  const int n = letters(mask);
  // 2. letter column l + G s, from the lane that read its position
  VI code[L::kSlots];
#pragma unroll
  for (int s = 0; s < L::kSlots; ++s) {
    const VI pos =
        g.each([&](int l) { return letter_pos(mask, l + G * s, n); });
    const VI src = g.each([&](int l) {
      const int p = g.at(pos, l);
      return p < 0 ? 0 : p;
    });
    const VI src_lane = g.each([&](int l) { return g.at(src, l) % G; });
    VI v = g.each([](int) { return int32_t(0); });
#pragma unroll
    for (int i = 0; i < L::kPos; ++i) {
      const VI w = g.shfl(cls[i], src_lane);
      v = g.each([&](int l) {
        return g.at(src, l) / G == i ? g.at(w, l) : g.at(v, l);
      });
    }
    code[s] = g.each([&](int l) { return g.at(pos, l) < 0 ? 0 : g.at(v, l); });
  }
  const int32_t c0 = column(g, code, 0), c1 = column(g, code, 1);
  const int32_t c2 = column(g, code, 2), t1 = column(g, code, n - 1);
  const int32_t t2 = column(g, code, n - 2), t3 = column(g, code, n - 3);
  // 3. the clitics' letters, a pattern a lane, and the function words
  uint32_t pro_bits = 0, enc_bits = 0;
#pragma unroll
  for (int i = 0; i < L::kPro; ++i) {
    pro_bits |= g.vote(g.each([&](int l) {
                  return pro_letters(pro_pattern(l + G * i), c0, c1, c2);
                }))
                << (G * i);
  }
#pragma unroll
  for (int i = 0; i < L::kEnc; ++i) {
    enc_bits |= g.vote(g.each([&](int l) {
                  return enc_letters(enc_pattern(l + G * i), t1, t2, t3);
                }))
                << (G * i);
  }
  const int32_t key5 =
      fw_key(c0, c1, c2, column(g, code, 3), column(g, code, 4));
  const bool fw_word =
      g.vote(g.each([&](int l) {
        return fw_slice_hit(fw, fw_n, l, G, key5);
      })) != 0;
  // 4. the cuts, and the row
  const bool exempt = n <= kFwMaxLen && fw_word;
  const int pro = exempt ? 0 : pro_cut(pro_bits, n);
  const int enc = exempt ? 0 : enc_cut(enc_bits, n - pro);
  const int keep = kept(n, pro, enc);
#pragma unroll
  for (int i = 0; i < L::kOut; ++i) {
    const VI c = g.each([&](int l) { return l + G * i + pro; });
    const VI c_lane = g.each([&](int l) { return g.at(c, l) % G; });
    VI v = g.each([](int) { return int32_t(0); });
#pragma unroll
    for (int s = 0; s < L::kSlots; ++s) {
      const VI w = g.shfl(code[s], c_lane);
      v = g.each([&](int l) {
        return g.at(c, l) / G == s ? g.at(w, l) : g.at(v, l);
      });
    }
    g.run([&](int l) {
      const int q = l + G * i;
      if (store && q < kRow) row[q] = q < keep ? g.at(v, l) : 0;
    });
  }
}

}  // namespace tf
