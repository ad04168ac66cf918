// Dictionary membership for Hopper (sm_90a): the paper's comparator bank
// (K7) and the sorted search (K8), the two Compare kernels of the staged
// stemmer path. Keys int32[n] in, flags bool[n] (one byte each) out.
//
// K7, dict_bank_kernel, replaces repro/kernels/stem_match.py:_match_kernel
// (behind dict_match_pallas). What the reference computes is membership
// of each key in the table padded with -2 to a multiple of block_r * 128
// entries: bool[N]. Its all-pairs compare (6.3M keys x 2048 entries, 12.9G
// equality tests at 1M words) is how a TPU's vector unit gets there, not
// the function; on an H100 it costs about the card's int32 issue rate.
//
// What bounds K7 on an H100: bytes. Membership needs the keys read once
// (4 B a key), the flags written once (1 B a key) and the table read once:
// about 0.0094 ms for 6.3M keys.
//
// What the design does about it (a banked comparator bank, the banks'
// steps in dict_bank.cuh): the table is split into 2^bits banks by a
// multiplicative hash of the value, and a key meets only the entries of
// its own bank, about one on average instead of 2048. A persistent grid
// (one 1024-thread block an SM, fewer for few keys) reads the table once
// a block and banks it in shared memory: bank sizes by shared atomics, an
// exclusive scan across the block, a scatter (a repeat of the previous
// entry, such as the -2 padding's run, is left out; the padding itself is
// read as -2 past the dictionary's r entries, not stored). Each thread
// issues its first four 16-byte key loads before the banking, so about a
// third of the key stream (at 6.3M keys) is in flight while the banks are
// built. Then each thread probes its keys four at a time, the four
// bank words and the first two entries of each bank loaded together
// (dict_bank.cuh:probe4), and writes the four flags as one 32-bit store
// (the ragged tail of n % 4 keys one byte each). On the card, 1024
// threads and four loads a thread beat 256 or 512 threads and two or
// eight (the banking is shorter with more threads). A table larger than
// one block's budget (8192 entries) is banked chunk by chunk, and later
// chunks OR their hits into the flags. Any order, duplicates and any
// int32 value are exact; an adversarial table with every entry in one
// bank only costs compares.
//
// K8, dict_bsearch_kernel, replaces
// repro/kernels/stem_match.py:_bsearch_kernel (behind
// dict_match_bsearch_pallas): membership in the sorted table padded to a
// power of two rp >= 128 with the sentinel, which the reference finds by
// ceil(log2 rp) bisection probes a key.
//
// What bounds K8 on an H100: bytes as well (keys in, flags out, the table
// once), about 0.0094 ms for 6.3M keys. The first port was 7x
// that: a block a 1024-key tile, 6144 blocks at 6.3M keys, each staging
// the whole table (50 MB of L2 -> shared copies, more than the keys), then
// 12 dependent scalar probes a key whose first levels all fall in one
// shared-memory bank; and its wrapper queued two more kernels to pad the
// table.
//
// What the design does about it (the search's steps in dict_search.cuh):
// one kernel a call, reading the unpadded table and its padding
// virtually; a persistent grid (the blocks that fit the SMs, fewer when
// one pass covers the keys; 128-1024 threads by the launch's keys), each
// block staging the table once, as a breadth-first tree, with 4-byte
// cp.async copies while its first keys load; a thread reads 4 keys as
// one 16-byte load (the next 4 in flight meanwhile), walks their 4 trees
// together (one contiguous run of nodes a level, so the first six levels
// are one wavefront each) and writes the 4 flags as one 32-bit store; the
// ragged tail of n % 4 keys one at a time. A table past kSharedMaxRp (the
// 262,144-key dictionaries) stages only a tree of every S-th entry (S by
// the launch) and reads one 8-entry block a key from L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dict_bank.cuh"
#include "dict_search.cuh"
#include "stem_resident.cuh"

namespace {

constexpr int kBankThreads = 1024;
// 16-byte key loads a thread issues at once: the first pass's are in
// flight while the block banks the table
constexpr int kBankQuads = 4;

// The banks' exclusive scan, by the whole block: each bank word's low
// half becomes the sum of the sizes (high halves) of the banks before it.
// Each thread takes a run of ceil(n / threads) words, then the warps, then
// their totals; warp_sums holds 32 ints. Ends with a barrier.
__device__ void scan_banks(uint32_t* banks, int n, uint32_t* warp_sums) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int warps = blockDim.x / 32;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  uint32_t own = 0;
  for (int i = lo; i < hi; ++i) own += banks[i] >> 16;
  uint32_t inc = own;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < warps ? warp_sums[lane] : 0;
    uint32_t winc = w;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += y;
    }
    if (lane < warps) warp_sums[lane] = winc - w;
  }
  __syncthreads();
  uint32_t run = inc - own + warp_sums[warp];
  for (int i = lo; i < hi; ++i) {
    const uint32_t w = banks[i];
    banks[i] = db::bank_start(w, run);
    run += w >> 16;
  }
  __syncthreads();
}

// Bank entries [c0, c0 + len) of the padded table in shared memory: each
// kept entry adds to its bank's size (a shared atomic), the scan sets the
// starts, and the scatter places each entry at its bank's cursor, which
// leaves the bank's end (dict_bank.cuh). Ends with a barrier.
__device__ void build_banks(const int32_t* __restrict__ dict, int r,
                            long long c0, int len, int bits, uint32_t* banks,
                            int32_t* entries, uint32_t* warp_sums) {
  for (int b = threadIdx.x; b < (1 << bits); b += blockDim.x) banks[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    if (db::kept(dict, r, c0, c0 + i)) {
      atomicAdd(&banks[db::bank_of(db::entry(dict, r, c0 + i), bits)],
                1u << 16);
    }
  }
  __syncthreads();
  scan_banks(banks, 1 << bits, warp_sums);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    if (db::kept(dict, r, c0, c0 + i)) {
      const int32_t v = db::entry(dict, r, c0 + i);
      entries[atomicAdd(&banks[db::bank_of(v, bits)], 1u) & 0xffffu] = v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load_quads(const int4* __restrict__ keys4,
                                           long long quads, long long q,
                                           long long stride, int4* k) {
#pragma unroll
  for (int u = 0; u < kBankQuads; ++u) {
    const long long qq = q + u * stride;
    k[u] = qq < quads ? __ldg(keys4 + qq) : make_int4(0, 0, 0, 0);
  }
}

// keys 16-byte aligned, out 4-byte aligned. A pass covers gridDim.x *
// blockDim.x * kBankQuads quads, kBankQuads a thread (strided by the
// grid's thread count, so each load of a warp is coalesced); the same
// thread owns the same flags in every chunk.
__global__ void __launch_bounds__(kBankThreads)
dict_bank_kernel(const int32_t* __restrict__ keys, int n,
                 const int32_t* __restrict__ dict, int r, int rp, int chunk,
                 uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem_banks[];
  __shared__ uint32_t warp_sums[32];
  const int bits = db::bank_bits(chunk);
  uint32_t* banks = smem_banks;
  int32_t* entries = reinterpret_cast<int32_t*>(smem_banks + (1 << bits));
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
  const long long quads = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int4 k[kBankQuads];
  load_quads(keys4, quads, first, stride, k);   // in flight while banking
  for (int c0 = 0; c0 == 0 || c0 < rp; c0 += chunk) {
    build_banks(dict, r, c0, min(chunk, rp - c0), bits, banks, entries,
                warp_sums);
    for (long long q0 = first; q0 < quads; q0 += kBankQuads * stride) {
      if (c0 > 0 || q0 > first) load_quads(keys4, quads, q0, stride, k);
#pragma unroll
      for (int u = 0; u < kBankQuads; ++u) {
        const long long q = q0 + u * stride;
        if (q < quads) {
          const int32_t four[4] = {k[u].x, k[u].y, k[u].z, k[u].w};
          uint32_t flags = db::probe4(entries, banks, bits, four);
          if (c0 > 0) flags |= out4[q];
          out4[q] = flags;
        }
      }
    }
    const long long tail = 4 * quads + first;     // the last n % 4 keys
    if (tail < n) {
      bool hit = db::probe(entries, banks, bits, __ldg(keys + tail));
      if (c0 > 0) hit |= out[tail] != 0;
      out[tail] = hit;
    }
    __syncthreads();              // every probe done before the next chunk
  }
}

// Threads a K8 block runs: the fewest from kMinSearchThreads whose blocks,
// a quad of keys a thread, take every key in one pass on the card's SMs,
// else kSearchThreads.
constexpr int kSearchThreads = 1024;
constexpr int kMinSearchThreads = 128;

// Stage the tree of every 2^log2s-th entry of the padded table into
// shared memory: node j <- its entry, an asynchronous 4-byte copy
// (cp.async) for the dictionary's entries, the sentinel stored for the
// padding's. The copy is ready after rt::stage_end.
__device__ __forceinline__ void stage_tree(int32_t* tree, int fences,
                                           int levels, int log2s,
                                           const int32_t* __restrict__ dict,
                                           int r) {
  for (int j = threadIdx.x; j < fences; j += blockDim.x) {
    const int i = ds::node_entry(j, levels, log2s);
    if (i < r) {
      const unsigned to =
          static_cast<unsigned>(__cvta_generic_to_shared(tree + j));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                   "l"(dict + i)
                   : "memory");
    } else {
      tree[j] = ds::kSentinel;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// keys 16-byte aligned, out 4-byte aligned; INST ds::kShared (log2s 0: the
// tree is the whole table) or ds::kGlobal. A pass covers gridDim.x *
// blockDim.x quads, one a thread.
template <int INST>
__global__ void __launch_bounds__(kSearchThreads)
dict_bsearch_kernel(const int32_t* __restrict__ keys, int n,
                    const int32_t* __restrict__ dict, int r, int rp,
                    int log2s, uint8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int32_t* tree = reinterpret_cast<int32_t*>(smem4);
  const int levels = ds::log2_of(rp) - log2s;
  const ds::GlobalTable table{dict, r,
                              reinterpret_cast<uintptr_t>(dict) % 16 == 0};
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
  const long long quads = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int4 k = first < quads ? __ldg(keys4 + first) : make_int4(0, 0, 0, 0);
  stage_tree(tree, 1 << levels, levels, log2s, dict, r);
  rt::stage_end();
  for (long long q = first; q < quads; q += stride) {
    const int4 next =
        q + stride < quads ? __ldg(keys4 + q + stride) : make_int4(0, 0, 0, 0);
    const int32_t four[4] = {k.x, k.y, k.z, k.w};
    out4[q] = ds::search<4, INST>(tree, levels, log2s, table, four);
    k = next;
  }
  const long long tail = 4 * quads + first;       // the last n % 4 keys
  if (tail < n) {
    const int32_t one[1] = {__ldg(keys + tail)};
    out[tail] = uint8_t(ds::search<1, INST>(tree, levels, log2s, table, one));
  }
}

}  // namespace

// K7: keys int32[n], 16-byte aligned; dict int32[r] in any order, read as
// the table padded with -2 to rp >= r entries, a multiple of 128 (the
// caller pads to block_r * 128; the padding is part of the result); chunk
// entries (a multiple of 128, at most db::kChunkMax) banked at a time ->
// out uint8[n] (4-byte aligned), 1 where the key equals an entry.
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int dict_match_bank_launch(const void* keys, int n,
                                      const void* dict, int r, int rp,
                                      void* out, int chunk, void* stream) {
  if (n <= 0) return 0;
  if (r < 0 || rp < r || rp % 128 || chunk < 128 || chunk % 128 ||
      chunk > db::kChunkMax || reinterpret_cast<uintptr_t>(keys) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = db::smem_bytes(chunk);
  cudaError_t e = rt::allow_smem(dict_bank_kernel, smem);
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dict_bank_kernel, kBankThreads, smem)) != cudaSuccess) {
    return int(e);
  }
  // a persistent grid: the blocks that fit the SMs, fewer when one pass
  // of kBankQuads loads a thread covers the keys
  const long long quads = n / 4;
  const long long per_block = (long long)kBankThreads * kBankQuads;
  const long long want = (quads + per_block - 1) / per_block;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = int(want < 1 ? 1 : want < fit ? want : fit);
  dict_bank_kernel<<<grid, kBankThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, static_cast<const int32_t*>(dict),
      r, rp, chunk, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

namespace {
// What the last K8 launch of this thread took.
thread_local int last_bsearch[4] = {0, 0, 0, 0};
}  // namespace

// K8: keys int32[n], 16-byte aligned; dict int32[r] sorted, read as the
// table padded with the sentinel to rp entries (a power of two >= 128,
// at least r) -> out uint8[n] (4-byte aligned), 1 where the key is an
// entry. One kernel on `stream`; returns the CUDA error code (0 on
// success).
extern "C" int dict_match_bsearch_launch(const void* keys, int n,
                                         const void* dict, int r, int rp,
                                         void* out, void* stream) {
  if (n <= 0) return 0;
  if (r < 0 || rp < 128 || (rp & (rp - 1)) || rp < r ||
      reinterpret_cast<uintptr_t>(keys) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4 ||
      reinterpret_cast<uintptr_t>(dict) % 4) {
    return int(cudaErrorInvalidValue);
  }
  const int inst = ds::instance(rp);
  auto kernel = inst == ds::kShared ? dict_bsearch_kernel<ds::kShared>
                                    : dict_bsearch_kernel<ds::kGlobal>;
  int dev = 0, sms = 0;
  cudaError_t e = rt::current_sms(&dev, &sms);
  if (e != cudaSuccess) return int(e);
  const long long quads = (n + 3) / 4;
  int threads = kMinSearchThreads;
  while (threads < kSearchThreads && (quads + threads - 1) / threads > sms) {
    threads *= 2;
  }
  const long long want = (quads + threads - 1) / threads;
  // the largest tree first: the step depends on the grid it sizes
  const size_t max_smem = size_t(ds::smem_bytes(
      rp, ds::log2_step(rp, inst, n, 1)));
  int grid = 0;
  if ((e = rt::allow_smem(kernel, max_smem)) != cudaSuccess ||
      (e = rt::resident_grid(kernel, threads, max_smem,
                             int(want < INT_MAX ? want : INT_MAX), &grid)) !=
          cudaSuccess) {
    return int(e);
  }
  const int log2s = ds::log2_step(rp, inst, n, grid);
  const size_t smem = size_t(ds::smem_bytes(rp, log2s));
  last_bsearch[0] = inst;
  last_bsearch[1] = threads;
  last_bsearch[2] = grid;
  last_bsearch[3] = log2s;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, static_cast<const int32_t*>(dict),
      r, rp, log2s, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

// The instance, threads a block, blocks and log2 of the tree's step of
// this thread's last K8 launch.
extern "C" void dict_bsearch_last_shape(int* inst, int* threads, int* grid,
                                        int* log2s) {
  *inst = last_bsearch[0];
  *threads = last_bsearch[1];
  *grid = last_bsearch[2];
  *log2s = last_bsearch[3];
}

extern "C" const char* dict_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
