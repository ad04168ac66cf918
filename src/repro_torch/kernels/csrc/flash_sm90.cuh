// The bf16 instance of K9 on Hopper's tensor cores: wgmma, TMA and a
// warp-specialised ring. Included by flash_attention.cu, which picks it for
// bf16 with head_dim 64, 128 or 256 (flash_attention_instance); every other
// dtype and head_dim goes to the register-tiled FMA instance there.
//
// Shape of the kernel (one block per (b*h, 128-row query tile), heaviest
// causal tiles first; 384 threads = 3 warpgroups):
//   * warpgroup 0 gives up registers (setmaxnreg 24) and one of its threads
//     is the producer: it loads the Q tile once, then K and V tiles of BK
//     keys (128 for D <= 128, 64 for D = 256) with TMA into a ring of
//     kStages stages. Each stage has a full mbarrier for K and one for V
//     (TMA completes their bytes on them, so S starts before V lands) and
//     an empty one (each of the 8 consumer warps arrives once it is done
//     with the stage). The K/V loop stops at the block's diagonal under
//     causal masking.
//   * warpgroups 1 and 2 take registers (setmaxnreg 240) and own 64 query
//     rows each. Per tile: S = Q K^T with wgmma m64nBKk16 (A = Q and B = K,
//     both in shared memory, K-major, 128-byte swizzle); the online softmax
//     on the accumulator fragment (a row's values sit in 4 lanes: 2
//     shuffles); O += P V with wgmma m64nDk16, A = P from registers (the
//     S accumulator layout is the A fragment layout once packed to bf16),
//     B = the V tile read MN-major through the transpose bit.
//   * Rows are loaded as 64-column boxes (128 bytes, the 128-byte swizzle's
//     width) through a 3-D tensor map [b*h][T][D], so rows past T are zero
//     filled per head; such keys are masked, such rows never written.
//
// Numerics: scores are exact bf16 products summed in fp32 (in the tensor
// cores' order); the scale, m and l stay fp32 (m in raw score units, each
// p = 2^(s * scale * log2(e) - m * scale * log2(e)): one FFMA and one ex2);
// the -1e30 causal fill is applied on diagonal and ragged tiles only
// (other tiles have nothing to mask). P is rounded to bf16 for
// P V, as every tensor-core flash kernel does; the reference keeps it in
// fp32 (repro/kernels/flash_attention.py:58). That rounding adds at most
// 2^-9 relative per weight, inside the 2e-2 the bf16 checks hold.
//
// What bounds it: operations, at 989 TFLOP/s bf16 (4 B H D T(T+1)/2 flops
// causal against 4 B H T D elements moved).
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float kNeg = -1e30f;

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  static constexpr int kBQ = 128;                  // 2 consumer warpgroups
  static constexpr int kBK = D <= 128 ? 128 : 64;  // keys a tile
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kBoxes = D / 64;            // 128-byte boxes a row
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBars = 1 + 3 * kStages;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte atom
  static constexpr size_t kSmem =
      1024 + kQBytes + 2ull * kStages * kTileBytes + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: the start address,
// the leading and stride byte offsets (16-byte units) and layout type 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// wgmma m64nNk16, fp32 += bf16 x bf16, overloaded on the accumulator's
// N / 2 registers. _ss: A and B K-major in shared memory, scale_d = 0
// overwrites d. _rs: A from registers, B MN-major (transposed) in shared
// memory, accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int bh, int t, int n_qtiles,
                  float scale_log2, int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::kQBytes;                  // [kStages][kTileBytes]
  uint8_t* vs = ks + C::kStages * C::kTileBytes;  // [kStages][kTileBytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs +
                                                 C::kStages * C::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  const int tile = blockIdx.x / bh;
  const int head = blockIdx.x - tile * bh;
  const int qt = causal ? n_qtiles - 1 - tile : tile;
  const int q0 = qt * C::kBQ;
  const int kend = causal ? min(t, q0 + C::kBQ) : t;
  const int n_tiles = (kend + C::kBK - 1) / C::kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        tma_load(qs + b * C::kBQ * 128, &tq, q_full, b * 64, q0, head);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % C::kStages;
        // a fresh barrier counts as released once: round 0 passes
        mbar_wait(&empty[s], ((n / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], C::kTileBytes);
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load(ks + s * C::kTileBytes + b * C::kBK * 128, &tk, &k_full[s],
                   b * 64, n * C::kBK, head);
        }
        mbar_expect_tx(&v_full[s], C::kTileBytes);
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load(vs + s * C::kTileBytes + b * C::kBK * 128, &tv, &v_full[s],
                   b * 64, n * C::kBK, head);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [q0 + 64 cw, q0 + 64 cw + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid % 32;
  const int rbase = q0 + 64 * cw;
  const int r0 = rbase + 16 * (tid / 32) + lane / 4;  // rows r0 and r0 + 8
  const int cq = 2 * (lane % 4);  // first column in each 8-column group
  const uint32_t q_addr = smem_u32(qs) + cw * 64 * 128;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % C::kStages;
    const int k0 = n * C::kBK;
    const uint32_t phase = (n / C::kStages) & 1;
    mbar_wait(&k_full[s], phase);
    // a tile wholly above this warpgroup's rows adds nothing: skip it
    if (!causal || k0 <= rbase + 63) {
      const uint32_t k_addr = smem_u32(ks + s * C::kTileBytes);
      const uint32_t v_addr = smem_u32(vs + s * C::kTileBytes);
      float sacc[C::kBK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            desc(q_addr + (kk / 4) * C::kBQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            desc(k_addr + (kk / 4) * C::kBK * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss(sacc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sacc);

      // online softmax on the fragment: sacc[i] is row r0 + 8 * ((i >> 1) & 1),
      // column 8 * (i / 4) + cq + (i & 1) of the tile. m is kept in raw
      // score units (the scale is positive), p = 2^(s * scale_log2 - m').
      const bool edge = k0 + C::kBK > t || (causal && k0 + C::kBK - 1 > rbase);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int i = 0; i < C::kBK / 2; ++i) {
        float x = sacc[i];
        if (edge) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = (i & 2) ? r0 + 8 : r0;
          if (key >= t || (causal && key > row)) x = kNeg;
        }
        sacc[i] = x;
        if (i & 2) {
          mx1 = fmaxf(mx1, x);
        } else {
          mx0 = fmaxf(mx0, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = ex2((m0 - mn0) * scale_log2);
      const float a1 = ex2((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
      float s0 = 0.f, s1 = 0.f;
      uint32_t pa[C::kBK / 16][4];
#pragma unroll
      for (int i = 0; i < C::kBK / 2; i += 2) {
        const float mm = (i & 2) ? ms1 : ms0;
        const float p0 = ex2(fmaf(sacc[i], scale_log2, -mm));
        const float p1 = ex2(fmaf(sacc[i + 1], scale_log2, -mm));
        if (i & 2) {
          s1 += p0 + p1;
        } else {
          s0 += p0 + p1;
        }
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
      l0 = l0 * a0 + s0;  // this lane's share of the row sums
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? a1 : a0;

      fence_regs(oacc);
      mbar_wait(&v_full[s], phase);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk) {
        wgmma_rs(oacc, pa[kk],
                 desc(v_addr + kk * 16 * 128, C::kBK * 128, 1024));
      }
      wg_commit();
      wg_wait0();
      fence_regs(oacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, off);
    l1 += __shfl_xor_sync(~0u, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = (i & 2) ? r0 + 8 : r0;
    if (row < t) {
      const float dn = (i & 2) ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((long long)head * t + row) * D + 8 * (i / 4) + cq) =
          __floats2bfloat162_rn(oacc[i] / dn, oacc[i + 1] / dn);
    }
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// A 3-D map of x = [bh][t][d] bf16 with boxes of 64 columns x `rows` rows,
// 128-byte swizzle; reads past t fill zeros.
inline int make_map(CUtensorMap* map, const void* x, int bh, int t, int d,
                    int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(x) % 16) {
    return int(cudaErrorMisalignedAddress);
  }
  cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(t), cuuint64_t(bh)};
  cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(t) * d * 2};
  cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int t, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, bh, t, D, C::kBQ);
  if (e == 0) e = make_map(&mk, k, bh, t, D, C::kBK);
  if (e == 0) e = make_map(&mv, v, bh, t, D, C::kBK);
  if (e) return e;
  auto kernel = flash_sm90_kernel<D>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmem));
  if (a != cudaSuccess) return int(a);
  const int n_qtiles = (t + C::kBQ - 1) / C::kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), 384, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), bh, t, n_qtiles,
      scale * 1.4426950408889634f, causal);
  return int(cudaGetLastError());
}

}  // namespace sm90
