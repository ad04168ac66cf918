// Causal (or full) softmax attention for Hopper (sm_90a): K9.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (behind
// flash_attention, the pallas_call at :94). q, k, v, o are [B*H, T, D],
// row-major, fp32 or bf16; o = softmax(q k^T * scale [+ causal]) v, with
// scores, the running max m, the denominator l and the accumulator in fp32,
// -1e30 as the causal fill and o = acc / max(l, 1e-30) cast to the input
// type, as the TPU kernel computes it.
//
// One library, two hand-written instances, chosen by dtype and head_dim
// alone (flash_attention_instance; kernels/flash_attention.py:_instance is
// the same rule):
//   * "wgmma": bf16 with D in {64, 128, 256}, on the tensor cores
//     (flash_sm90.cuh: TMA, a producer warp, two consumer warpgroups).
//   * "fma": everything else, register-tiled on the fp32 FMA units (this
//     file). fp32 stays off the tensor cores because its 1e-5 tolerance
//     rules out TF32; bf16 of other head dims converts at staging.
//
// The FMA instance, tiled the way an SGEMM is:
//   * One block of 256 threads per (b*h, 128 query rows, chunk of DC <= 128
//     output columns); heaviest causal tiles launch first and the loop over
//     64-key tiles stops at the block's diagonal. A thread owns rows
//     rg + 32 i (i < 4) and, of each tile, keys kg + 8 j (j < 8): a 4 x 8
//     score micro-tile, and of O the columns kg * 4 + 32 jj + (0..3): a
//     4 x DC/8 micro-tile in registers. The 8 threads of a row sit in one
//     8-lane group, so the row max and sum cross lanes once a tile.
//   * Q and K sit in shared memory row-major with an odd number of float4s
//     a row (rows one apart hit distinct banks), so each depth-4 step of
//     the score product is 4 + 8 float4 loads for 128 FMAs; P goes to
//     shared memory as [key][row group][4] and each key of P V is one
//     float4 of P and DC/32 float4s of V for DC/2 FMAs.
//   * fp32 tiles move with cp.async (rows 16-byte aligned): V of tile n
//     loads while its scores compute, K of tile n + 1 while P V of tile n
//     computes. Two buffers of each beside Q and P would pass 227 KB at
//     D = 128, so each has one buffer and a copy is always in flight.
//   * Head dims past 128 take several output chunks, each block recomputing
//     the scores over the full D in depth chunks of 128 (staged then, not
//     prefetched): exact, and every chunk sums in the same order. So any D
//     runs; entries past D and keys or rows past T are zeros, masked keys
//     -1e30.
//
// What bounds it on an H100: attention at T = 4096 does 4*D*T(T+1)/2
// flops a (b, h) causal, far more than the bytes it must move (q, k, v read
// once, o written once), so the bound is operations: 989 TFLOP/s of bf16
// tensor cores for the wgmma instance, 67 TFLOP/s of plain fp32 for fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 128;      // query rows a block: 32 row groups x 4
constexpr int kBK = 64;       // keys a tile: 8 key groups x 8
constexpr int kDK = 128;      // depth chunk of the score product
constexpr int kPS = kBQ + 4;  // P's row stride (floats): odd float4 count

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Row stride (floats) of the Q and K tiles for a depth chunk of w columns:
// w rounded up to float4s, then to an odd number of float4s.
__host__ __device__ inline int row_stride(int w) {
  const int wp = (w + 3) & ~3;
  return ((wp / 4) & 1) ? wp : wp + 4;
}

// Q [kBQ][sq], K [kBK][sq], V [kBK][dc], P [kBK][kPS]
__host__ __device__ inline size_t smem_floats(int sq, int dc) {
  return size_t(kBQ + kBK) * sq + size_t(kBK) * dc + size_t(kBK) * kPS;
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) and columns [col0, col0 + w4) (w4 a multiple of
// 4) of a [t, d] matrix into dst[rows][stride] as fp32, entries past t or d
// zero. fp32 with vec (d % 4 == 0, 16-byte aligned) goes by cp.async; the
// rest converts and stores at once.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const T* __restrict__ src, int row0,
                                      int rows, int t, int col0, int w4,
                                      int d, bool vec) {
  const int n4 = w4 / 4;
  for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
    const int r = e / n4;
    const int c = (e - r * n4) * 4;
    float* dp = dst + r * stride + c;
    const int row = row0 + r, col = col0 + c;
    if constexpr (std::is_same<T, float>::value) {
      if (vec && row < t && col < d) {
        cp16(dp, src + (long long)row * d + col);
        continue;
      }
    }
    const T* sp = src + (long long)row * d + col;
    const bool in = row < t;
    float4 x;
    x.x = in && col < d ? to_f32(sp[0]) : 0.f;
    x.y = in && col + 1 < d ? to_f32(sp[1]) : 0.f;
    x.z = in && col + 2 < d ? to_f32(sp[2]) : 0.f;
    x.w = in && col + 3 < d ? to_f32(sp[3]) : 0.f;
    *reinterpret_cast<float4*>(dp) = x;
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads, 1)
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int bh, int t,
                 int d, int n_qtiles, int n_chunks, float scale, int causal,
                 int vec) {
  constexpr int NJ = DC / 32;  // float4 column groups of O a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_dchunks = (d + kDK - 1) / kDK;
  const int dk4 = (min(d, kDK) + 3) & ~3;
  const int sq = row_stride(dk4);
  float* qs = smem;              // [kBQ][sq]
  float* ks = qs + kBQ * sq;     // [kBK][sq]
  float* vs = ks + kBK * sq;     // [kBK][DC]
  float* ps = vs + kBK * DC;     // [kBK][kPS]

  const int per_tile = n_chunks * bh;
  const int tile = blockIdx.x / per_tile;
  const int rest = blockIdx.x - tile * per_tile;
  const int chunk = rest / bh;
  const int head = rest - chunk * bh;
  const int qt = causal ? n_qtiles - 1 - tile : tile;
  const int q0 = qt * kBQ;
  const int c0 = chunk * DC;
  const long long base = (long long)head * t * d;
  const T* qh = q + base;
  const T* kh = k + base;
  const T* vh = v + base;
  const int lane = threadIdx.x % 32;
  const int kg = lane % 8;                            // key group
  const int rg = (threadIdx.x / 32) * 4 + lane / 8;   // row group

  float acc[4][4 * NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) acc[i][e] = 0.f;
  }

  const int kend = causal ? min(t, q0 + kBQ) : t;
  const int n_tiles = (kend + kBK - 1) / kBK;
  const int w_last = d - (n_dchunks - 1) * kDK;  // the last depth chunk
  if (n_dchunks == 1) {
    stage(qs, sq, qh, q0, kBQ, t, 0, dk4, d, vec);
    stage(ks, sq, kh, 0, kBK, t, 0, dk4, d, vec);
  }
  cp_commit();

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kBK;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    for (int dc = 0; dc < n_dchunks; ++dc) {
      const int w4 = ((dc + 1 < n_dchunks ? kDK : w_last) + 3) & ~3;
      if (n_dchunks > 1) {
        __syncthreads();  // the last chunk's reads are done
        stage(qs, sq, qh, q0, kBQ, t, dc * kDK, w4, d, vec);
        stage(ks, sq, kh, k0, kBK, t, dc * kDK, w4, d, vec);
        cp_commit();
      }
      cp_wait<0>();
      __syncthreads();  // Q and K in place; every thread is past P V
      if (dc == 0) {
        stage(vs, DC, vh, k0, kBK, t, c0, DC, d, vec);
        cp_commit();
      }
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      const float4* k4 = reinterpret_cast<const float4*>(ks);
      const int s4 = sq / 4;
#pragma unroll 2
      for (int c = 0; c < w4 / 4; ++c) {
        float4 kk[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) kk[j] = k4[(kg + 8 * j) * s4 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qq = q4[(rg + 32 * i) * s4 + c];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
            s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
            s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
            s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
          }
        }
      }
    }

    // online softmax: the 8 lanes of a row group hold its 64 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 32 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + kg + 8 * j;
        float x = s[i][j] * scale;
        if (key >= t || (causal && key > row)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off));
      }
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        sum += __shfl_xor_sync(~0u, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < 4 * NJ; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(ps + (kg + 8 * j) * kPS + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();  // P in place; every thread is done with K
    if (n_dchunks == 1 && n + 1 < n_tiles) {
      stage(ks, sq, kh, k0 + kBK, kBK, t, 0, dk4, d, vec);
      cp_commit();
      cp_wait<1>();   // V of this tile, not the next K
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // V in place

    // acc += P V over the tile's keys (keys past t carry p = 0, v = 0)
    const float4* p4 = reinterpret_cast<const float4*>(ps);
    const float4* v4 = reinterpret_cast<const float4*>(vs);
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pp = p4[j * (kPS / 4) + rg];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vv = v4[j * (DC / 4) + kg + 8 * jj];
        const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(pr[i], vv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pr[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pr[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pr[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 32 * i;
    if (row >= t) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + base + (long long)row * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + kg * 4 + 32 * jj + e;
        if (col < d) store(orow + col, acc[i][4 * jj + e] / denom);
      }
    }
  }
}

template <typename T, int DC>
int launch_fma(const void* q, const void* k, const void* v, void* o, int bh,
               int t, int d, int causal, float scale, cudaStream_t stream) {
  const int sq = row_stride(min(d, kDK));
  const size_t smem = smem_floats(sq, DC) * sizeof(float);
  auto kernel = flash_fma_kernel<T, DC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int n_qtiles = (t + kBQ - 1) / kBQ;
  const int n_chunks = (d + DC - 1) / DC;
  const long long blocks = (long long)n_qtiles * n_chunks * bh;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int vec = std::is_same<T, float>::value && d % 4 == 0 && aligned;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, t, d, n_qtiles,
      n_chunks, scale, causal, vec);
  return int(cudaGetLastError());
}

template <typename T>
int launch_fma_dtype(const void* q, const void* k, const void* v, void* o,
                     int bh, int t, int d, int causal, float scale,
                     cudaStream_t stream) {
  // output columns a block owns: the head dim rounded up, at most 128
  if (d <= 32) return launch_fma<T, 32>(q, k, v, o, bh, t, d, causal, scale, stream);
  if (d <= 64) return launch_fma<T, 64>(q, k, v, o, bh, t, d, causal, scale, stream);
  return launch_fma<T, 128>(q, k, v, o, bh, t, d, causal, scale, stream);
}

}  // namespace

// The instance a launch takes: 1 = the tensor-core ("wgmma") one, 0 = the
// FMA one; by dtype and head_dim alone.
extern "C" int flash_attention_instance(int d, int is_bf16) {
  return is_bf16 && (d == 64 || d == 128 || d == 256);
}

// q, k, v, o: [bh, t, d] contiguous, fp32 (is_bf16 = 0) or bf16 (1), the
// output allocated by the caller; any d >= 1 (the wgmma instance needs q, k
// and v 16-byte aligned). scale multiplies the fp32 scores. Launches on
// `stream` and returns the CUDA error code (0 on success; nothing is
// launched for bh = 0 or t = 0).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int t,
                                      int d, int is_bf16, int causal,
                                      float scale, void* stream) {
  if (bh == 0 || t == 0) return 0;
  if (bh < 0 || t < 0 || d < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_instance(d, is_bf16)) {
    if (d == 64) return sm90::launch<64>(q, k, v, o, bh, t, causal, scale, s);
    if (d == 128) return sm90::launch<128>(q, k, v, o, bh, t, causal, scale, s);
    return sm90::launch<256>(q, k, v, o, bh, t, causal, scale, s);
  }
  return is_bf16 ? launch_fma_dtype<__nv_bfloat16>(q, k, v, o, bh, t, d,
                                                   causal, scale, s)
                 : launch_fma_dtype<float>(q, k, v, o, bh, t, d, causal,
                                           scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
