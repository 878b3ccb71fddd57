// Device helpers shared by the flash-attention kernels that run their
// products on Hopper's tensor cores with warp-level mma.sync
// (flash_fwd.cu, flash_bwd_dkv.cu): asynchronous 16- and 4-byte copies
// into shared memory, ldmatrix, the bf16 and TF32 products, the 3xTF32
// split that gives f32 precision on TF32 tensor cores, the base-2
// exponential, the attention keep mask and the staging of a padded tile.
//
// Fragment layouts are PTX's for mma.m16n8k16 (bf16) and mma.m16n8k8
// (TF32): lane = 4 g + t; an accumulator holds rows g and g + 8, columns
// 2t and 2t + 1 of its 16 x 8 tile.
//
// Each kernel source is its own translation unit and shared library, so
// the helpers sit in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Elements of padding per shared-memory row: 16 bytes of bf16 (ldmatrix
// rows then start on distinct bank quads), 4 floats for f32 (the 32-bit
// fragment reads of a warp then hit 32 distinct banks).
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<bf16> { static constexpr int value = 8; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16 or 4) with zero fill: `src_bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: 16 x 8 x 16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: 16 x 8 x 8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small: big = tf32(x), rounded to nearest with ties away from
// zero as cvt.rna.tf32.f32 rounds (half of the last kept bit added to the
// magnitude, the 13 dropped bits cleared), and small = x - big, exact in
// f32, whose low 13 bits the tensor core drops. Integer adds and masks,
// because cvt.rna compiles to a longer sequence of compares and selects
// (SASS for sm_90a), and at several splits a product the f32 path is
// bound by issued instructions.
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = round_tf32(__float_as_uint(x));
  small = __float_as_uint(x - __uint_as_float(big));
}

// 3xTF32: d += a b in about f32 precision, from split operands (the
// small * small term is below f32's rounding).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the special-function unit (relative error about 2^-22); inputs
// below -126 give 0, which is what a masked or negligible p is anyway.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// _keep_mask plus the ragged edge: query row qi may use key row kj.
__device__ __forceinline__ bool keep(int qi, int kj, int S, int causal,
                                     int window) {
  bool k = qi < S && kj < S;
  if (causal) k = k && qi >= kj && (window <= 0 || qi - kj < window);
  return k;
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ bf16 zero_of(bf16) { return __float2bfloat16(0.f); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copies rows [row0, row0 + ROWS) of one head's (S, D) slice with row
// stride ss into a ROWS x (DP + pad) tile, with the NT threads of the
// block; rows past S and columns past D are zero, so they add nothing to
// the products. `vec`: 16-byte cp.async (the pointer, ss and D are whole
// 16-byte units); else scalar loads.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int S, int D,
                                          long long ss, bool vec) {
  constexpr int LD = DP + Pad<T>::value;
  if (vec) {
    constexpr int V = 16 / sizeof(T);   // elements per 16-byte chunk
    constexpr int CH = DP / V;          // chunks per row
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * V;
      const int s = row0 + r;
      const bool ok = s < S && c < D;
      cp_async16(dst + r * LD + c, ok ? src + s * ss + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const int s = row0 + r;
      dst[r * LD + c] = (s < S && c < D) ? src[s * ss + c] : zero_of(T());
    }
  }
}

}  // namespace
