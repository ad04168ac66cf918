// Dictionary membership for Hopper (sm_90a): the paper's comparator bank
// (K7) and the sorted search (K8), the two Compare kernels of the staged
// stemmer path. Keys int32[n] in, flags bool[n] (one byte each) out.
//
// K7, dict_match_bank_kernel, replaces
// repro/kernels/stem_match.py:_match_kernel (behind dict_match_pallas):
// the all-pairs comparator bank. One block per key tile of
// block_n * 128 keys, one thread per key (min(tile, 512) threads, in
// passes past that). The block walks the padded dictionary in tiles of
// block_r * 128 entries staged in shared memory; each thread compares its
// key with every entry of the tile (broadcast reads, no bank conflicts)
// and ORs the results. The TPU kernel's second grid axis is this loop
// inside the block, so nothing is carried between blocks.
//
// What bounds K7 on an H100: the function it computes is membership,
// which needs only the keys read once, the flags written once and the
// table read once, so its bound is bytes (about 0.0094 ms for 6.3M keys).
// The bank's own cost is the all-pairs compare, n x padded R equality
// tests (12.9G at 6.3M keys against 2048 entries): integer instructions, 4
// compares per 16-byte shared-memory read. The design keeps that cost on
// purpose: the bank is the paper's baseline Compare, and the sorted
// search (K8) is the upgrade.
//
// K8, dict_match_bsearch_kernel, replaces
// repro/kernels/stem_match.py:_bsearch_kernel (behind
// dict_match_bsearch_pallas): ceil(log2 Rp) branchless bisection steps a
// key against the sorted table padded to a power of two Rp >= 128 with
// the sentinel, the same rt::bsearch_hit that K1's stage 5 runs. One
// block per tile of block_n * 128 keys, one thread per key (min(tile,
// 512) threads). The table is copied into shared memory once per block
// while it fits (Rp up to 32,768); a larger one (the 262,144-key tables
// that stream in K2) is read through __ldg from global memory, where the
// first probes of every key hit the same few L2 lines.
//
// What bounds K8: bytes as well (keys in, flags out, the table once);
// its own work is ceil(log2 Rp) dependent probes a key, each a load.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_resident.cuh"

namespace {

using rt::kMaxThreads;

__global__ void __launch_bounds__(kMaxThreads)
dict_match_bank_kernel(const int32_t* __restrict__ keys, int n,
                       const int4* __restrict__ dict, int rp, int tile_n,
                       uint8_t* __restrict__ out, int tile_keys) {
  extern __shared__ int4 sdict[];
  // the grid covers n, so base < n
  const long long base = (long long)blockIdx.x * tile_keys;
  const int rows = int(min((long long)tile_keys, n - base));
  for (int k0 = 0; k0 < rows; k0 += blockDim.x) {
    const int i = k0 + threadIdx.x;
    const int32_t key = i < rows ? __ldg(keys + base + i) : 0;
    bool hit = false;
    for (int d0 = 0; d0 < rp; d0 += tile_n) {
      const int quads = min(tile_n, rp - d0) / 4;   // rp is a 128 multiple
      __syncthreads();                   // the last tile's reads are done
      for (int j = threadIdx.x; j < quads; j += blockDim.x) {
        sdict[j] = __ldg(dict + d0 / 4 + j);
      }
      __syncthreads();
      for (int j = 0; j < quads; ++j) {
        const int4 e = sdict[j];
        hit |= (e.x == key) | (e.y == key) | (e.z == key) | (e.w == key);
      }
    }
    if (i < rows) out[base + i] = hit;
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(kMaxThreads)
dict_match_bsearch_kernel(const int32_t* __restrict__ keys, int n,
                          const int32_t* __restrict__ dict, int rp,
                          uint8_t* __restrict__ out, int tile_keys) {
  const int32_t* table[3] = {dict, nullptr, nullptr};
  const int len[3] = {rp, 0, 0};
  // stage_tables<2> copies tables 0 and 1; table 1 is empty
  if constexpr (SHARED) rt::stage_tables<2>(table, len);
  const int steps = rt::ceil_log2(rp);
  const long long base = (long long)blockIdx.x * tile_keys;
  const int rows = int(min((long long)tile_keys, n - base));
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int32_t key = __ldg(keys + base + i);
    out[base + i] = rt::bsearch_hit<SHARED>(table[0], rp, steps, key);
  }
}

int grid_for(int n, int tile_keys) {
  return int((n + (long long)tile_keys - 1) / tile_keys);
}

}  // namespace

// K7: keys int32[n]; dict int32[rp] padded with -2 to a multiple of 128
// (the caller pads to block_r * 128; the padding is part of the result),
// 16-byte aligned; tile_keys = block_n * 128; tile_n entries (a multiple
// of 128) staged a step -> out uint8[n], 1 where the key equals an entry.
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int dict_match_bank_launch(const void* keys, int n,
                                      const void* dict, int rp, void* out,
                                      int tile_keys, int tile_n,
                                      void* stream) {
  if (n <= 0) return 0;
  if (tile_keys < 1 || rp < 0 || rp % 128 || tile_n < 128 || tile_n % 128) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int32_t) * size_t(tile_n);
  const cudaError_t e = rt::allow_smem(dict_match_bank_kernel, smem);
  if (e != cudaSuccess) return int(e);
  dict_match_bank_kernel<<<grid_for(n, tile_keys),
                           rt::block_threads(tile_keys), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, static_cast<const int4*>(dict),
      rp, tile_n, static_cast<uint8_t*>(out), tile_keys);
  return int(cudaGetLastError());
}

// K8: keys int32[n]; dict int32[rp] sorted, padded with the sentinel to a
// power of two rp >= 128, 16-byte aligned; tile_keys = block_n * 128 ->
// out uint8[n]. dict_in_shared copies the table into shared memory once
// per block (4 * rp bytes), else it is read from global memory.
extern "C" int dict_match_bsearch_launch(const void* keys, int n,
                                         const void* dict, int rp, void* out,
                                         int tile_keys, int dict_in_shared,
                                         void* stream) {
  if (n <= 0) return 0;
  if (tile_keys < 1 || rp < 128 || (rp & (rp - 1))) {
    return int(cudaErrorInvalidValue);
  }
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* d = static_cast<const int32_t*>(dict);
  auto* o = static_cast<uint8_t*>(out);
  const int grid = grid_for(n, tile_keys);
  const int threads = rt::block_threads(tile_keys);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = dict_in_shared ? dict_match_bsearch_kernel<true>
                               : dict_match_bsearch_kernel<false>;
  const size_t smem = dict_in_shared ? sizeof(int32_t) * size_t(rp) : 0;
  const cudaError_t e = rt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<grid, threads, smem, s>>>(k, n, d, rp, o, tile_keys);
  return int(cudaGetLastError());
}

extern "C" const char* dict_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
