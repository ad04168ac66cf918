// Text front end for Hopper (sm_90a): a codepoint tile in, the stemmer's
// int32[16] word rows out, one launch.
//
// Replaces repro/kernels/text_frontend.py:_frontend_kernel (behind
// text_frontend_pallas). The word geometry (starts, lengths, byte spans)
// comes from the plain PyTorch pre-pass textnorm.segment_geometry, as the
// reference computes it in jnp before its kernel. Per word row: read its
// raw window, classify, compact the letters, strip the clitics and pack
// (text_frontend.cuh). Rows past the tile's word count have length 0 and
// come out zero.
//
// What bounds it on an H100: bytes. The word capacity is T / 2 + 1 rows
// for a T-codepoint tile (the most words it can hold), and every row is
// written, the empty ones too: per row 8 B of geometry in and 64 B out,
// against about 4 B of codepoints in per word character; the integer work
// (about a thousand selects a word: the 32 x 20 compaction, the one-hot
// reads, a 7-probe bisection) stays under the bytes bound.
//
// What the design does about it: one thread per word row, block_w rows a
// block (min(block_w, 512) threads striding over them); the row goes out
// as four 16-byte stores, neighbouring threads on neighbouring rows; an
// empty row is stored without running the rules; CLASS_LUT and the
// function-word table are copied into shared memory once a block; the
// codepoints are read through the read-only cache, only the word's own
// (at most MAX_RAW of them).
#include <cuda_runtime.h>
#include <stdint.h>

#include "text_frontend.cuh"

namespace {

constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
text_frontend_kernel(const int32_t* __restrict__ chars, long long t,
                     long long tp, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ lut,
                     const int32_t* __restrict__ fw, int fw_n,
                     int4* __restrict__ words, int block_w) {
  extern __shared__ int32_t smem[];
  int32_t* s_lut = smem;
  int32_t* s_fw = smem + tf::kLutSize;
  for (int i = threadIdx.x; i < tf::kLutSize; i += blockDim.x) {
    s_lut[i] = __ldg(lut + i);
  }
  for (int i = threadIdx.x; i < fw_n; i += blockDim.x) s_fw[i] = __ldg(fw + i);
  __syncthreads();
  const int fw_steps = tf::ceil_log2(fw_n);

  const long long base = (long long)blockIdx.x * block_w;
  for (int w = threadIdx.x; w < block_w; w += blockDim.x) {
    const long long r = base + w;
    const int32_t len = __ldg(lens + r);
    int32_t out[tf::kRow];
    if (len > 0) {
      tf::word_row(chars, t, tp, __ldg(starts + r), len, s_lut, s_fw, fw_n,
                   fw_steps, out);
    } else {
#pragma unroll
      for (int q = 0; q < tf::kRow; ++q) out[q] = 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      words[4 * r + k] =
          make_int4(out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
    }
  }
}

}  // namespace

// chars int32[t] (a tile of codepoints, 0 = separator; tp = t rounded up
// to a multiple of 128), starts/lens int32[wp] from segment_geometry (wp
// a multiple of block_w), lut int32[256] (CLASS_LUT), fw int32[fw_n]
// (FW_FLAT) -> words int32[wp, 16], 16-byte aligned. Launches on `stream`
// and returns the CUDA error code (0 on success) of the launch.
extern "C" int text_frontend_launch(const void* chars, long long t,
                                    const void* starts, const void* lens,
                                    int wp, const void* lut, const void* fw,
                                    int fw_n, void* words, int block_w,
                                    void* stream) {
  if (wp <= 0) return 0;
  if (t < 1 || block_w < 1 || wp % block_w || fw_n < 1) {
    return int(cudaErrorInvalidValue);
  }
  const long long tp = (t + 127) / 128 * 128;
  const int threads = block_w < kMaxThreads ? block_w : kMaxThreads;
  const size_t smem = sizeof(int32_t) * (tf::kLutSize + size_t(fw_n));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        text_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  text_frontend_kernel<<<wp / block_w, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chars), t, tp,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(fw), fw_n,
      static_cast<int4*>(words), block_w);
  return int(cudaGetLastError());
}

extern "C" const char* text_frontend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
