// Causal (or full) softmax attention for Hopper (sm_90a): K9.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (behind
// flash_attention, the pallas_call at :94). q, k, v, o are [B*H, T, D],
// row-major, fp32 or bf16; o = softmax(q k^T * scale [+ causal]) v, with
// scores, the running max m, the denominator l and the accumulator in fp32,
// -1e30 as the causal fill and o = acc / max(l, 1e-30) cast to the input
// type, as the TPU kernel computes it.
//
// Design (a first, simple one that is right):
//   * One block per (b*h, tile of BQ = warps * 8 query rows); the TPU grid's
//     sequential k axis is a loop inside the block over 32-key tiles of K
//     and V staged in shared memory as fp32. Under causal masking the loop
//     stops at the block's diagonal, so tiles above it are never loaded,
//     and a warp skips a tile wholly above its own rows (both exact: such a
//     tile adds p = 0 and leaves m and l as they were).
//   * Scores: lane j of a warp owns key j of the tile and computes its dot
//     product with each of the warp's 8 query rows, reading its K row as
//     float4 (rows padded so a quarter-warp's float4 reads hit distinct
//     banks) and the query rows as broadcast float4 reads.
//   * Online softmax per row with warp shuffles (max, sum); p goes to a
//     small per-warp shared buffer.
//   * P V: lane l owns output columns l, l + 32, ... (NPL of them in
//     registers for each of the 8 rows); each key's p is a broadcast read.
//   * Heaviest query tiles (the last, under causal masking) launch first.
//
// What bounds it on an H100: attention at T = 4096 does 4*D*T(T+1)/2
// flops a (b, h), far more than the bytes it must move (q, k, v read once,
// o written once), so the bound is operations: the tensor cores' 989
// TFLOP/s in bf16, the 67 TFLOP/s of plain fp32 in fp32 (the reference's
// 1e-5 tolerance rules out TF32). This kernel runs both products on the
// fp32 FMA units (CUDA cores) from shared memory, so in bf16 it is far from
// its bound by design; tensor cores (mma.sync / wgmma), TMA and a
// producer/consumer ring are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;          // query rows a warp owns
constexpr int kBK = 32;           // keys a tile: one per lane
constexpr int kMaxWarps = 8;
constexpr float kNeg = -1e30f;
constexpr size_t kSmemMax = 232448;   // 227 KB a block on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Shared-memory row stride (floats) of the Q and K tiles: D rounded up to
// a multiple of 4 for float4 reads, then to an odd number of float4s, so
// the 8 lanes of a quarter-warp reading 8 different rows hit distinct banks.
__host__ __device__ inline int row_stride(int d) {
  const int dp = (d + 3) & ~3;
  return ((dp / 4) & 1) ? dp : dp + 4;
}

__host__ __device__ inline size_t smem_floats(int warps, int d) {
  const int s = row_stride(d);
  return size_t(warps * kRows) * s + size_t(kBK) * s + size_t(kBK) * d +
         size_t(warps) * kRows * kBK;
}

// Rows [row0, row0 + rows) of a [t, d] matrix into dst[rows][stride] as fp32;
// rows at or past t are zeros. Columns >= d are never written here.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const T* __restrict__ src, int row0,
                                      int rows, int t, int d) {
  const int n = rows * d;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * stride + c] =
        row0 + r < t ? to_f32(src[(long long)(row0 + r) * d + c]) : 0.f;
  }
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int bh, int t,
             int d, int n_qtiles, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x / 32;
  const int bq = warps * kRows;
  const int stride = row_stride(d);
  float* qs = smem;                       // [bq][stride]
  float* ks = qs + bq * stride;           // [kBK][stride]
  float* vs = ks + kBK * stride;          // [kBK][d]
  float* ps = vs + kBK * d;               // [warps][kRows][kBK]

  const int tile = blockIdx.x / bh;
  const int head = blockIdx.x - tile * bh;
  const int qt = causal ? n_qtiles - 1 - tile : tile;
  const int q0 = qt * bq;
  const long long base = (long long)head * t * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + warp * kRows;       // this warp's first query row

  // zero the Q and K tiles once: their pad columns stay zero for good
  for (int e = threadIdx.x; e < (bq + kBK) * stride; e += blockDim.x) {
    smem[e] = 0.f;
  }
  __syncthreads();
  stage(qs, stride, q + base, q0, bq, t, d);

  float m[kRows], l[kRows], acc[kRows][NPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[r][i] = 0.f;
  }

  const int kend = causal ? min(t, q0 + bq) : t;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                      // the last tile's reads are done
    stage(ks, stride, k + base, k0, kBK, t, d);
    stage(vs, d, v + base, k0, kBK, t, d);
    __syncthreads();
    if (r0 >= t || (causal && k0 > r0 + kRows - 1)) continue;

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * stride);
    const float4* qrow =
        reinterpret_cast<const float4*>(qs + warp * kRows * stride);
    const int s4 = stride / 4;
    for (int c = 0; c < (d + 3) / 4; ++c) {
      const float4 kk = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = qrow[r * s4 + c];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    const int key = k0 + lane;
    float* pw = ps + warp * kRows * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float x = s[r] * scale;
      if (key >= t || (causal && key > r0 + r)) x = kNeg;
      const float mn = fmaxf(m[r], warp_max(x));
      const float p = expf(x - mn);
      const float alpha = expf(m[r] - mn);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[r][i] *= alpha;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc += p v over the tile's keys (keys past t carry p = 0, v = 0)
    const float4* pw4 = reinterpret_cast<const float4*>(pw);
    for (int j = 0; j < kBK; j += 4) {
      float4 pp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pp[r] = pw4[r * (kBK / 4) + j / 4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NPL];
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int c = lane + 32 * i;
          vv[i] = c < d ? vs[(j + jj) * d + c] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = jj == 0 ? pp[r].x
                        : jj == 1 ? pp[r].y
                        : jj == 2 ? pp[r].z
                                  : pp[r].w;
#pragma unroll
          for (int i = 0; i < NPL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();                         // p reads done before next writes
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    if (row >= t) break;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + base + (long long)row * d;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store(orow + c, acc[r][i] / denom);
    }
  }
}

template <typename T, int NPL>
int launch_typed(const void* q, const void* k, const void* v, void* o, int bh,
                 int t, int d, int causal, float scale, cudaStream_t stream) {
  int warps = kMaxWarps;
  while (warps > 1 && smem_floats(warps, d) * sizeof(float) > kSmemMax) {
    warps /= 2;
  }
  const size_t smem = smem_floats(warps, d) * sizeof(float);
  if (smem > kSmemMax) return int(cudaErrorInvalidValue);
  auto kernel = flash_kernel<T, NPL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int bq = warps * kRows;
  const int n_qtiles = (t + bq - 1) / bq;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, t, d, n_qtiles,
      scale, causal);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int bh,
                 int t, int d, int causal, float scale, cudaStream_t stream) {
  // output columns a lane owns, rounded up to an instantiated width
  const int npl = (d + 31) / 32;
  if (npl <= 1) return launch_typed<T, 1>(q, k, v, o, bh, t, d, causal, scale, stream);
  if (npl <= 2) return launch_typed<T, 2>(q, k, v, o, bh, t, d, causal, scale, stream);
  if (npl <= 4) return launch_typed<T, 4>(q, k, v, o, bh, t, d, causal, scale, stream);
  if (npl <= 8) return launch_typed<T, 8>(q, k, v, o, bh, t, d, causal, scale, stream);
  return launch_typed<T, 16>(q, k, v, o, bh, t, d, causal, scale, stream);
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, fp32 (is_bf16 = 0) or bf16 (1), the
// output allocated by the caller; 1 <= d <= 512 (FLASH_MAX_HEAD_DIM). scale
// multiplies the fp32 scores. Launches on `stream` and returns the CUDA
// error code (0 on success; nothing is launched for bh = 0 or t = 0).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int t,
                                      int d, int is_bf16, int causal,
                                      float scale, void* stream) {
  if (bh == 0 || t == 0) return 0;
  if (bh < 0 || t < 0 || d < 1 || d > 512) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_dtype<__nv_bfloat16>(q, k, v, o, bh, t, d, causal,
                                           scale, s)
             : launch_dtype<float>(q, k, v, o, bh, t, d, causal, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
