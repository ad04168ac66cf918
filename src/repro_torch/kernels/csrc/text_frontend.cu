// Text front end for Hopper (sm_90a): a codepoint tile in, the stemmer's
// int32[16] word rows out, one launch.
//
// Replaces repro/kernels/text_frontend.py:_frontend_kernel (behind
// text_frontend_pallas). The word geometry (starts, lengths, byte spans)
// comes from the plain PyTorch pre-pass textnorm.segment_geometry, as the
// reference computes it in jnp before its kernel. Per word row: read its
// raw window, classify, compact the letters, strip the clitics and pack
// (text_frontend.cuh). A row with length <= 0 comes out zero.
//
// What bounds it on an H100: bytes. The word capacity is T / 2 + 1 rows
// for a T-codepoint tile (the most words it can hold) and every row is
// written: 8 B of geometry in and 64 B out a row, against about 4 B of
// codepoints a word character. A served request's tile (65,536
// codepoints, about 4096 words, 32,896 rows) is 1 in 8 rows live; the
// integer work of a word (some 1,200 operations on one lane) is what the
// first port, a thread a row, ran on the 32 SMs whose blocks held
// the live rows, and its empty rows went out as four 16-byte stores at a
// 64-byte thread stride.
//
// What the design does about it:
//   - rows come in pieces of 8 (512 output bytes); block b of the grid
//     takes pieces b, b + grid, ... (256 / G of them), so live rows that
//     form a prefix of the tile spread over every block;
//   - a block reads its pieces' lengths and starts (a piece's 16 loads
//     at once), compacts the live rows in piece order (a block scan of the
//     pieces' counts) and writes the empty rows with a warp a piece,
//     consecutive lanes on consecutive 16-byte pieces: whole 128-byte
//     lines;
//   - CLASS_LUT and FW_FLAT are staged with cp.async (rt::stage_begin)
//     while the lengths load;
//   - the live rows go to groups of G lanes, one word a group: at G = 8
//     lane j reads window positions j, j + 8, ... (coalesced across the
//     group), the letters are compacted by a vote (__ballot_sync) and
//     gathered from the lane of each column's set bit (__shfl_sync), the
//     clitic patterns are tested a pattern a lane and the first match is
//     the lowest bit of a vote (letters first, the cut's length after),
//     the function-word table is searched a slice a lane (one step of
//     independent loads in place of the bisection's seven dependent
//     ones), and the group stores the row as one 64-byte segment
//     (text_frontend.cuh:lane_word, which the host build runs too); G = 1
//     runs a word on one lane (text_frontend.cuh:word_row) and stores it
//     as four 16-byte stores.
// The launcher picks G by the launch's rows on the host, without a sync
// (tf::frontend_lanes); a measurement build (-DRT_FORCED_LANES) fixes it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_fences.cuh"
#include "text_frontend.cuh"

namespace {

// Exclusive prefix of v over the block's threads, and the total; ends
// with a barrier. warp_sums holds a word a warp.
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < tf::kThreads / 32; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + inc - v;
}

template <int G>
__global__ void __launch_bounds__(tf::kThreads)
text_frontend_kernel(const int32_t* __restrict__ chars, long long t,
                     long long tp, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens, long long rows,
                     const int32_t* __restrict__ lut,
                     const int32_t* __restrict__ fw, int fw_n,
                     int32_t* __restrict__ words) {
  constexpr int kGroups = tf::kThreads / G;      // pieces a block
  extern __shared__ int4 smem4[];
  int32_t* s_lut = reinterpret_cast<int32_t*>(smem4);
  int32_t* s_fw = s_lut + tf::kLutSize;
  // the live rows, their starts and lengths, in piece order
  __shared__ int32_t list[kGroups * tf::kPieceRows];
  __shared__ int32_t list_start[kGroups * tf::kPieceRows];
  __shared__ int32_t list_len[kGroups * tf::kPieceRows];
  __shared__ uint8_t live[kGroups];
  __shared__ int warp_sums[tf::kThreads / 32];
  rt::stage_begin(s_lut, lut, tf::kLutSize);
  rt::stage_begin(s_fw, fw, fw_n);

  // 1. this block's pieces' live rows, compacted in piece order
  const long long grid = gridDim.x, pieces = tf::n_pieces(rows);
  const int tid = threadIdx.x;
  long long p = 0;
  uint32_t m = 0;
  int32_t start[tf::kPieceRows], len[tf::kPieceRows];
  if (tid < kGroups) {
    p = tf::piece_of(blockIdx.x, tid, grid);
    if (p < pieces) m = tf::piece_rows(starts, lens, rows, p, start, len);
    live[tid] = uint8_t(m);
  }
  int total = 0;
  const int at = block_scan(__popc(m), warp_sums, &total);
  tf::list_rows(m, p, start, len, at, list, list_start, list_len);
  rt::stage_end();                 // the tables, the list and the masks

  // 2. the empty rows: a warp a piece, a lane a 16-byte piece of it
  for (int k = tid / 32; k < kGroups; k += tf::kThreads / 32) {
    tf::clear_lane(words, rows, pieces, tf::piece_of(blockIdx.x, k, grid),
                   live[k], tid % 32);
  }

  // 3. the live rows, a word a group: G = 1 a word a thread; else a warp's
  //    groups take items together, every lane in every round
  if constexpr (G == 1) {
    const int fw_steps = tf::ceil_log2(fw_n);
    for (int i = tid; i < total; i += kGroups) {
      int32_t out[tf::kRow];
      tf::word_row(chars, t, tp, list_start[i], list_len[i], s_lut, s_fw,
                   fw_n, fw_steps, out);
      int4* row4 = reinterpret_cast<int4*>(words + (long long)tf::kRow *
                                                       list[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        row4[k] = make_int4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                            out[4 * k + 3]);
      }
    }
  } else {
    const tf::WarpLanes<G> g;
    for (int i0 = tid / 32 * (32 / G); i0 < total; i0 += kGroups) {
      const int i = i0 + tid % 32 / G;
      const bool has = i < total;
      tf::lane_word(g, chars, t, tp, has ? list_start[i] : 0,
                    has ? list_len[i] : 0, s_lut, s_fw, fw_n, has,
                    words + (long long)tf::kRow * (has ? list[i] : 0));
    }
  }
}

// What the last launch of this thread took.
thread_local int last_lanes = 0, last_grid = 0;

template <int G>
int launch(const int32_t* chars, long long t, const int32_t* starts,
           const int32_t* lens, int wp, const int32_t* lut, const int32_t* fw,
           int fw_n, int32_t* words, cudaStream_t stream) {
  const long long tp = (t + 127) / 128 * 128;
  const long long grid = tf::frontend_grid(wp, G);
  const size_t smem = sizeof(int32_t) * (tf::kLutSize + size_t(fw_n));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        text_frontend_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  last_lanes = G;
  last_grid = int(grid);
  text_frontend_kernel<G><<<unsigned(grid), tf::kThreads, smem, stream>>>(
      chars, t, tp, starts, lens, wp, lut, fw, fw_n, words);
  return int(cudaGetLastError());
}

}  // namespace

// chars int32[t] (a tile of codepoints, 0 = separator; read as if padded
// with 0 to a multiple of 128), starts/lens int32[wp] from
// segment_geometry (wp a multiple of block_w), lut int32[256]
// (CLASS_LUT), fw int32[fw_n] (FW_FLAT), both 16-byte aligned -> words
// int32[wp, 16], 16-byte aligned. Launches on `stream` and returns the
// CUDA error code (0 on success) of the launch.
extern "C" int text_frontend_launch(const void* chars, long long t,
                                    const void* starts, const void* lens,
                                    int wp, const void* lut, const void* fw,
                                    int fw_n, void* words, int block_w,
                                    void* stream) {
  if (wp <= 0) return 0;
  if (t < 1 || block_w < 1 || wp % block_w || fw_n < 1 ||
      reinterpret_cast<uintptr_t>(lut) % 16 ||
      reinterpret_cast<uintptr_t>(fw) % 16 ||
      reinterpret_cast<uintptr_t>(words) % 16) {
    return int(cudaErrorInvalidValue);
  }
#ifdef RT_FORCED_LANES
  // a measurement build (build.forced_text_lanes_library): every launch
  // takes RT_FORCED_LANES lanes a word, whatever the rule would pick
  const int lanes = RT_FORCED_LANES;
#else
  int dev = 0, sms = 0;
  const cudaError_t e = rt::current_sms(&dev, &sms);
  if (e != cudaSuccess) return int(e);
  const int lanes = tf::frontend_lanes(wp, sms);
#endif
  const auto* c = static_cast<const int32_t*>(chars);
  const auto* s = static_cast<const int32_t*>(starts);
  const auto* l = static_cast<const int32_t*>(lens);
  const auto* lu = static_cast<const int32_t*>(lut);
  const auto* f = static_cast<const int32_t*>(fw);
  auto* w = static_cast<int32_t*>(words);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch<1>(c, t, s, l, wp, lu, f, fw_n, w, st);
    case 8: return launch<8>(c, t, s, l, wp, lu, f, fw_n, w, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The lanes a word and blocks of this thread's last launch.
extern "C" void text_frontend_last_shape(int* lanes, int* grid) {
  *lanes = last_lanes;
  *grid = last_grid;
}

extern "C" const char* text_frontend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
