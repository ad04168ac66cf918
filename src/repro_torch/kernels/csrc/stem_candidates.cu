// Standalone stemmer datapath for Hopper (sm_90a): stages 1-4 only, the
// candidates written to device memory for the staged Compare path.
//
// Replaces repro/kernels/stem_datapath.py:_datapath_kernel (behind
// stem_datapath_pallas). Per word: the 30 packed candidate keys and
// validity flags of stem_datapath.cuh, written as two int32[32] rows,
// keys and valid (0/1), each with two zero pad columns: 64 B of word in,
// 256 B out.
//
// What bounds it on an H100: bytes at a large launch, latency at a small
// one. The datapath is about 430 int32 operations a word, far under the
// card's rate for 320 B of traffic, and the 256 B written per word
// dominate: 335.5 MB at 1,048,576 words. A pipeline tick (128 words) or a
// served request (4096) is a few microseconds of dependent operations on
// a few SMs, next to the launch itself.
//
// What the design does about it:
//   - a word is computed by a group of G lanes (G in {1, 2, 4, 8}, picked
//     per launch by rt::candidate_lanes, which takes 8 at every size: it
//     won at every shape timed), lane j the 32 / G consecutive
//     output columns j * 32 / G on, through stem_datapath.cuh's
//     lane_columns, which branches on no lane: at 4096 words G = 8
//     spreads the launch over 128 blocks, not 16. The terms every slot
//     reads are shared: lane j classifies only positions j, j + G, ...
//     (lane_terms), and the group ORs its lanes' bits with log2 G
//     shuffles of two words;
//   - each lane stores its columns from registers as 16-byte stores, keys
//     then valid, with no shared staging and no barrier: at G = 8 one warp
//     store writes 4 whole rows, 512 contiguous bytes;
//   - blocks are 256 threads over words x G, whatever block_b is (block_b
//     only groups the words, as in K1).
// A measurement build (-DRT_FORCED_LANES) fixes G for every launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block

thread_local int last_lanes = 0, last_grid = 0;

template <int LANES>
__global__ void __launch_bounds__(kThreads)
stem_candidates_kernel(const int4* __restrict__ words, int n_words,
                       int4* __restrict__ keys, int4* __restrict__ valid) {
  constexpr int kCols = rt::kOutCols / LANES;   // columns a lane
  constexpr int kVecs = kCols / 4;              // its 16-byte stores a row
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / LANES;
  if (row >= n_words) return;
  const int lane = int(threadIdx.x) % LANES;
  int32_t w[rt::kMaxLen];
  rt::load_word(words, row, n_words, w);
  rt::TermBits t;
  if constexpr (LANES == 1) {
    t = rt::lane_terms<1>(w, 0);
  } else {
    // this lane's positions, then the group's bits ORed across its lanes
    const int32_t* codes_of = reinterpret_cast<const int32_t*>(words) +
                              row * rt::kMaxLen + lane;
    int32_t codes[rt::kMaxLen / LANES];
#pragma unroll
    for (int m = 0; m < rt::kMaxLen / LANES; ++m) {
      codes[m] = __ldg(codes_of + m * LANES);
    }
    t = rt::lane_terms<LANES>(codes, lane);
    const unsigned group = ((1u << LANES) - 1u)
                           << (int(threadIdx.x) % 32 / LANES * LANES);
#pragma unroll
    for (int d = 1; d < LANES; d *= 2) {
      t.pos |= __shfl_xor_sync(group, t.pos, d);
      t.lead |= __shfl_xor_sync(group, t.lead, d);
    }
  }
  int32_t k[kCols], v[kCols];
  rt::lane_columns<LANES>(w, rt::valid_mask(t), lane, k, v);
  int4* kr = keys + row * (rt::kOutCols / 4) + lane * kVecs;
  int4* vr = valid + row * (rt::kOutCols / 4) + lane * kVecs;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    kr[i] = make_int4(k[4 * i], k[4 * i + 1], k[4 * i + 2], k[4 * i + 3]);
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    vr[i] = make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int LANES>
int launch(const int4* words, int n_words, int4* keys, int4* valid,
           cudaStream_t stream) {
  const long long threads = (long long)n_words * LANES;
  const int grid = int((threads + kThreads - 1) / kThreads);
  stem_candidates_kernel<LANES><<<grid, kThreads, 0, stream>>>(
      words, n_words, keys, valid);
  last_lanes = LANES;
  last_grid = grid;
  return int(cudaGetLastError());
}

}  // namespace

// words int32[n_words, 16] -> keys int32[n_words, 32], valid
// int32[n_words, 32], all 16-byte aligned: the 30 candidate slots in
// stem_datapath.cuh's group order, then two zero columns. Launches on
// `stream` and returns the CUDA error code (0 on success) of the launch.
extern "C" int stem_candidates_launch(const void* words, int n_words,
                                      void* keys, void* valid,
                                      void* stream) {
  if (n_words <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(words) % 16 ||
      reinterpret_cast<uintptr_t>(keys) % 16 ||
      reinterpret_cast<uintptr_t>(valid) % 16) {
    return int(cudaErrorInvalidValue);
  }
#ifdef RT_FORCED_LANES
  // a measurement build (build.forced_candidates_lanes_library): every
  // launch takes RT_FORCED_LANES lanes a word, whatever the rule would pick
  const int lanes = RT_FORCED_LANES;
#else
  int dev = 0, sms = 0;
  const cudaError_t e = rt::current_sms(&dev, &sms);
  if (e != cudaSuccess) return int(e);
  const int lanes = rt::candidate_lanes(n_words, sms);
#endif
  const auto* w = static_cast<const int4*>(words);
  auto* k = static_cast<int4*>(keys);
  auto* v = static_cast<int4*>(valid);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch<1>(w, n_words, k, v, st);
    case 2: return launch<2>(w, n_words, k, v, st);
    case 4: return launch<4>(w, n_words, k, v, st);
    case 8: return launch<8>(w, n_words, k, v, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The lanes a word and blocks of this thread's last launch.
extern "C" void stem_candidates_last_shape(int* lanes, int* grid) {
  *lanes = last_lanes;
  *grid = last_grid;
}

extern "C" const char* stem_candidates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
