// Device helpers for the flash-attention kernels that run their products on
// Hopper's warpgroup-level tensor-core instruction, wgmma, with their tiles
// copied by the Tensor Memory Accelerator (TMA): the shared-memory matrix
// descriptor of the 128-byte swizzle, wgmma's fence, commit and wait, the
// bf16 and f16 products m64nNk16 with A in shared memory (N 32, 64, 80,
// 128) and with A in registers (N 64, 128, 256; B MN-major), the 3-D TMA
// tile load and the host's tensor map of a (S, heads, head_dim) tensor,
// mbarrier init, arrive, arrive.expect_tx and a wait on a phase, and
// setmaxnreg. sm_90a only (wgmma and setmaxnreg exist for no other target).
//
// Layouts. TMA's CU_TENSOR_MAP_SWIZZLE_128B writes a box of 64 16-bit
// columns (128 bytes) and R rows as R rows of 128 bytes, the 16-byte unit
// u of row r at position u ^ (r % 8); every tile here starts on a
// 1024-byte boundary, so the pattern starts with its row 0. wgmma reads
// such a tile as a K-major operand (rows = M or N, 64 columns of depth
// K): 8-row groups 1024 bytes apart (the descriptor's stride byte
// offset), and each 16-deep step 32 bytes further along the row (the
// start address advanced inside the swizzle atom). It reads a tile whose
// rows are K (V's keys) and whose 64 columns are N as an MN-major operand
// (the transpose bit of a 16-bit product): 8 rows of K 1024 bytes apart
// (stride byte offset), the next 64 columns of N the leading byte offset
// further (the next TMA box).
//
// Fragments: a warp's share of an m64nN accumulator is rows 16 w + g and
// 16 w + g + 8 (w its warp in the warpgroup, lane = 4 g + t), and d[j][e]
// is column 8 j + 2 t + (e & 1) of row g + 8 (e >> 1): mma.sync's m16n8
// fragment repeated over N / 8. A from registers is mma.sync m16n8k16's A
// fragment of the warp's 16 rows.

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// The descriptor of a wgmma operand in shared memory at `addr` (the
// shared window's byte address), laid out in the 128-byte swizzle, with
// leading and stride byte offsets `lbo` and `sbo`.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the registers of an
// asynchronous product (its accumulators, A from registers) across the
// product: each register passes through an empty asm before wgmma_fence
// and after wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// The products, one function per shape and type: inline PTX names every
// accumulator register. SS: both operands in shared memory, K-major
// (transpose bits 0). RS_..._TB: A in registers, B MN-major (transpose
// bit 1, which 16-bit types allow).
#define FIBER_WGMMA_SS_N80(NAME, TY)                                       \
  __device__ __forceinline__ void NAME(float (&d)[10][4], uint64_t da,       \
                                       uint64_t db, int scale_d) {          \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39}, "   \
      "%40, %41, p, 1, 1, 0, 0;\n}\n"                                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]) \
      : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define FIBER_WGMMA_RS_N256_TB(NAME, TY)                                    \
  __device__ __forceinline__ void NAME(float (&d)[32][4],                   \
                                       const uint32_t (&a)[4], uint64_t db, \
                                       int scale_d) {                        \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "   \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"             \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), \
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), \
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), \
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), \
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), \
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), \
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), \
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), \
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), \
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), \
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), \
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), \
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), \
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), \
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), \
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), \
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

#define FIBER_WGMMA_SS_N32(NAME, TY)                                      \
  __device__ __forceinline__ void NAME(float (&d)[4][4], uint64_t da,        \
                                       uint64_t db, int scale_d) {          \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]) \
      : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define FIBER_WGMMA_SS_N64(NAME, TY)                                      \
  __device__ __forceinline__ void NAME(float (&d)[8][4], uint64_t da,        \
                                       uint64_t db, int scale_d) {          \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define FIBER_WGMMA_SS_N128(NAME, TY)                                      \
  __device__ __forceinline__ void NAME(float (&d)[16][4], uint64_t da,        \
                                       uint64_t db, int scale_d) {          \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define FIBER_WGMMA_RS_N64_TB(NAME, TY)                                   \
  __device__ __forceinline__ void NAME(float (&d)[8][4],                    \
                                       const uint32_t (&a)[4], uint64_t db, \
                                       int scale_d) {                        \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"             \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

#define FIBER_WGMMA_RS_N128_TB(NAME, TY)                                  \
  __device__ __forceinline__ void NAME(float (&d)[16][4],                   \
                                       const uint32_t (&a)[4], uint64_t db, \
                                       int scale_d) {                        \
    asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"             \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

FIBER_WGMMA_SS_N80(wgmma_ss_bf16_n80, "bf16")
FIBER_WGMMA_SS_N80(wgmma_ss_f16_n80, "f16")
FIBER_WGMMA_RS_N256_TB(wgmma_rs_bf16_n256_tb, "bf16")
FIBER_WGMMA_RS_N256_TB(wgmma_rs_f16_n256_tb, "f16")
FIBER_WGMMA_SS_N32(wgmma_ss_bf16_n32, "bf16")
FIBER_WGMMA_SS_N32(wgmma_ss_f16_n32, "f16")
FIBER_WGMMA_SS_N64(wgmma_ss_bf16_n64, "bf16")
FIBER_WGMMA_SS_N64(wgmma_ss_f16_n64, "f16")
FIBER_WGMMA_SS_N128(wgmma_ss_bf16_n128, "bf16")
FIBER_WGMMA_SS_N128(wgmma_ss_f16_n128, "f16")
FIBER_WGMMA_RS_N64_TB(wgmma_rs_bf16_n64_tb, "bf16")
FIBER_WGMMA_RS_N64_TB(wgmma_rs_f16_n64_tb, "f16")
FIBER_WGMMA_RS_N128_TB(wgmma_rs_bf16_n128_tb, "bf16")
FIBER_WGMMA_RS_N128_TB(wgmma_rs_f16_n128_tb, "f16")

// d (+)= A B, m64 x 256 x k16 of 16-bit type T: A the warp's fragment in
// registers, B (k16 x n256) MN-major in shared memory (descriptor db).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, bf16>)
    wgmma_rs_bf16_n256_tb(d, a, db, scale_d);
  else
    wgmma_rs_f16_n256_tb(d, a, db, scale_d);
}

// d (+)= A B^T, m64 x 8 NJ x k16 of 16-bit type T (NJ 4, 8, 10 or 16: 32,
// 64, 80 or 128 columns), both operands in shared memory, K-major
// (descriptors da, db); scale_d 0 overwrites d.
template <typename T, int NJ>
__device__ __forceinline__ void wgmma_ss(float (&d)[NJ][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(NJ == 4 || NJ == 8 || NJ == 10 || NJ == 16,
                "m64n32, n64, n80 or n128");
  constexpr bool B16 = std::is_same_v<T, bf16>;
  if constexpr (NJ == 4) {
    if constexpr (B16) wgmma_ss_bf16_n32(d, da, db, scale_d);
    else wgmma_ss_f16_n32(d, da, db, scale_d);
  } else if constexpr (NJ == 8) {
    if constexpr (B16) wgmma_ss_bf16_n64(d, da, db, scale_d);
    else wgmma_ss_f16_n64(d, da, db, scale_d);
  } else if constexpr (NJ == 10) {
    if constexpr (B16) wgmma_ss_bf16_n80(d, da, db, scale_d);
    else wgmma_ss_f16_n80(d, da, db, scale_d);
  } else {
    if constexpr (B16) wgmma_ss_bf16_n128(d, da, db, scale_d);
    else wgmma_ss_f16_n128(d, da, db, scale_d);
  }
}

// d (+)= A B, m64 x 64 x k16 of 16-bit type T: A the warp's fragment in
// registers, B (k16 x n64) MN-major in shared memory (descriptor db).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, bf16>)
    wgmma_rs_bf16_n64_tb(d, a, db, scale_d);
  else
    wgmma_rs_f16_n64_tb(d, a, db, scale_d);
}

// d (+)= A B, m64 x 128 x k16 of 16-bit type T: A the warp's fragment in
// registers, B (k16 x n128) MN-major in shared memory (descriptor db).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, bf16>)
    wgmma_rs_bf16_n128_tb(d, a, db, scale_d);
  else
    wgmma_rs_f16_n128_tb(d, a, db, scale_d);
}

// d (+)= A B, m64 x 8 ND x k16 of 16-bit type T (ND 8, 16 or 32: 64, 128
// or 256 columns), A from registers, B MN-major in shared memory.
template <typename T, int ND>
__device__ __forceinline__ void wgmma_rs(float (&d)[ND][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(ND == 8 || ND == 16 || ND == 32, "m64n64, n128 or n256");
  if constexpr (ND == 8) wgmma_rs_n64<T>(d, a, db, scale_d);
  else if constexpr (ND == 16) wgmma_rs_n128<T>(d, a, db, scale_d);
  else wgmma_rs_n256<T>(d, a, db, scale_d);
}

// The mbarrier at `bar` (shared window address) expects `count` arrivals
// a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Makes the initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Arrives and adds `bytes` to the transactions the phase waits for (the
// TMA copies that complete on this barrier).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
// (No time limit that traps: a trap block shared by the warpgroups of a
// warp-specialized kernel keeps ptxas from giving each role its own
// register budget, and the consumers then spill.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copies the box at coordinates (c0, c1, c2) of the 3-D tensor map
// into shared memory at `dst`; its bytes complete on barrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Register budgets of a warp-specialized block: the producer warpgroup
// gives registers back, the consumer warpgroups take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Columns of a TMA box: 128 bytes of a 16-bit type, the swizzle's width.
constexpr int TMA_COLS = 64;

// cuTensorMapEncodeTiled, CUDA's encoder of a TMA tensor map, resolved
// once through the runtime's entry-point query, so that a library needs no
// -lcuda; null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one (S, heads, D) tensor of 16-bit type T with row and
// head strides ss and sh (elements), as 3-D (D, heads, S), with boxes of
// TMA_COLS columns, one head and `rows` rows, in the 128-byte swizzle;
// reads past S or D give zeros.
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int D, int heads,
                     int S, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)sh * sizeof(T),
                                 (cuuint64_t)ss * sizeof(T)};
  const cuuint32_t box[3] = {TMA_COLS, 1, (cuuint32_t)rows};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same_v<T, bf16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
