// Device helpers shared by the flash-attention kernels that run their
// products on Hopper's tensor cores with warp-level mma.sync
// (flash_fwd.cu, flash_bwd_dkv.cu, flash_bwd_dq.cu): asynchronous 16- and
// 4-byte copies into shared memory, ldmatrix, the bf16 and TF32 products,
// the 3xTF32 split that gives f32 precision on TF32 tensor cores, the
// base-2 exponential, the attention keep mask, the staging of a padded
// tile, and the two warp-level tile products of the backward kernels
// (abt: A B^T for a warp's 16-row m-tiles; add_xb: acc += X B with X in
// registers).
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

// The warp's MT 16-row m-tiles of A B^T over head_dim (DP, padded rows):
// m-tile mt takes A rows wrow + 16 mt.. of sa; B rows 0.. of sb.
// acc[mt][j] holds B rows 8j..8j+7 as the columns of an m16n8
// accumulator fragment. Each B fragment a warp loads feeds MT products.
template <int DP, int MT, int NJ>
__device__ __forceinline__ void abt(float (&acc)[MT][NJ][4], const bf16* sa,
                                    const bf16* sb, int wrow, int lane) {
  constexpr int LD = DP + Pad<bf16>::value;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], sa + (wrow + mt * 16 + (lane & 15)) * LD + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, sb + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * jj], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * jj + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// f32 as 3xTF32: A and B split into big and small at each fragment load.
template <int DP, int MT, int NJ>
__device__ __forceinline__ void abt(float (&acc)[MT][NJ][4], const float* sa,
                                    const float* sb, int wrow, int lane) {
  constexpr int LD = DP + Pad<float>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ra = sa + (wrow + mt * 16 + g) * LD + kk * 8 + t;
      split(ra[0], ab[mt][0], as[mt][0]);
      split(ra[8 * LD], ab[mt][1], as[mt][1]);
      split(ra[4], ab[mt][2], as[mt][2]);
      split(ra[8 * LD + 4], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* rb = sb + (j * 8 + g) * LD + kk * 8 + t;
      uint32_t bb[2], bs[2];
      split(rb[0], bb[0], bs[0]);
      split(rb[4], bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(acc[mt][j], ab[mt], as[mt], bb, bs);
    }
  }
}

// acc += X B for the warp's MT m-tiles: X (16 x 8 NJ an m-tile, the
// accumulator fragments of abt(), never leaving the registers) as the A
// operand, B the 8 NJ x DP tile sb. acc[mt][n] holds columns 8n..8n+7.
// For bf16 the accumulators of two adjacent 8-column tiles, packed to
// bf16 pairs, are the A fragment of one 16-deep step; B is read with
// ldmatrix .trans.
template <int DP, int MT, int NJ>
__device__ __forceinline__ void add_xb(float (&acc)[MT][DP / 8][4],
                                       const float (&x)[MT][NJ][4],
                                       const bf16* sb, int lane) {
  constexpr int LD = DP + Pad<bf16>::value;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(x[mt][2 * kk][0], x[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(x[mt][2 * kk][2], x[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(x[mt][2 * kk + 1][0], x[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(x[mt][2 * kk + 1][2], x[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int nn = 0; nn < DP / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_trans(b, sb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + nn * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * nn], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * nn + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// f32 as 3xTF32. The m16n8k8 accumulator holds columns 2t and 2t + 1
// where the A operand wants depth t and t + 4, so the depth index is
// permuted (t <-> 2t, t + 4 <-> 2t + 1) in both X and B's rows, which
// leaves the sum as it is. The tensor cores round their f32 sums toward
// zero; over the 16384 rows a long-lived accumulator sums, that bias
// reached 1.2e-4 of the largest gradient on an H100 (against a 5e-5
// bound), so each call's product is summed from zero and then added to
// acc with round-to-nearest adds.
template <int DP, int MT, int NJ>
__device__ __forceinline__ void add_xb(float (&acc)[MT][DP / 8][4],
                                       const float (&x)[MT][NJ][4],
                                       const float* sb, int lane) {
  constexpr int LD = DP + Pad<float>::value;
  constexpr int ND = DP / 8;
  constexpr int NG = ND < 4 ? ND : 4;   // accumulator tiles per pass
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += NG) {
    float part[MT][NG][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // A's k = t is B row 8j + 2t, k = t + 4 is 8j + 2t + 1.
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(x[mt][j][0], ab[mt][0], as[mt][0]);
        split(x[mt][j][2], ab[mt][1], as[mt][1]);
        split(x[mt][j][1], ab[mt][2], as[mt][2]);
        split(x[mt][j][3], ab[mt][3], as[mt][3]);
      }
      const float* rb = sb + (j * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bb[2], bs[2];
        split(rb[(n0 + n) * 8], bb[0], bs[0]);
        split(rb[LD + (n0 + n) * 8], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(part[mt][n], ab[mt], as[mt], bb, bs);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n0 + n][e] += part[mt][n][e];
  }
}

}  // namespace
