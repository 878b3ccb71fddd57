// Flash-attention forward for Hopper (sm_90a) on the tensor cores: plain
// CUDA C++ with a C interface, loaded with ctypes by
// fiber_tpu_torch/ops/flash_attention.py.
//
// Replaces fiber_tpu/ops/pallas_attention.py:_fwd_kernel, with its block
// skip _run_window and its elementwise mask _keep_mask: exact causal or
// non-causal attention by online softmax, grouped-query heads (KV head =
// h / (H / KVH)), an optional causal sliding window, -1e30 as the masked
// score, l = 0 -> 1 for a fully masked row, and lse = m + log l written
// as (H, S) f32 beside O.
//
// What bounds it on this card: two S x S x D products (halved by
// causality) for O(S D) bytes, so operations. bf16 and f16 inputs run
// them at the 16-bit tensor-core rate (989 TFLOP/s dense), with f32
// sums, m, l and lse, as the Pallas kernel upcasts every block to f32.
// f32 inputs run each
// product as three TF32 products (3xTF32, mma_sm90.cuh), at a third of
// the 495 TFLOP/s TF32 rate: 165 TFLOP/s, against the 67 TFLOP/s of f32
// FMA on the CUDA cores that the previous version of this kernel used.
// One TF32 product per f32 product is not enough: an emulation of this
// kernel's f32 arithmetic on the CPU (S = 2048, D = 32, against an f64
// recomputation; tests/test_torch_flash_attention.py keeps it) puts
// plain TF32 above the 2e-5 parity bound of O and 3xTF32 far below it.
//
// Design (FlashAttention-2's forward, warp-level mma.sync):
//
// - One block of 4 warps owns one (query head, query tile); each warp
//   owns two 16-row m-tiles (a 128-row query tile), so that every K and V
//   fragment it loads feeds two products, or one (64 rows) where two
//   would spill: f32 from head_dim 64 on, bf16 and f16 from 128. The
//   tiles of the last query rows, which see the most keys under
//   causality, are scheduled first. The block sweeps the KV tiles with
//   _run_window's predicate as its loop bounds; m, l and the output
//   accumulator stay in registers.
// - Q is staged in shared memory once. 16-bit Q fragments stay in
//   registers for the whole sweep up to head_dim 128; f32 ones (big and
//   small) are split again from shared memory at each tile, which beside
//   two m-tiles' accumulators measured faster than one m-tile with Q in
//   registers. 64-row K and V tiles are double-buffered by cp.async (16
//   bytes a thread): the next tile's copy runs while the current one
//   computes, one wait and one barrier a tile.
// - head_dim 129-256 pads to one 256 instance with one m-tile a warp:
//   its output accumulator alone is 128 registers a thread, so 16-bit Q
//   fragments are read from shared memory at each use as f32's are, and
//   f32 K and V tiles are 32 rows: their 16 x 32 score tile is 16
//   registers fewer than 64 rows' (which spilled 32 bytes a thread), and
//   two buffers of each fit in 199,680 bytes of shared memory, where
//   64-row ones would take 333 KB against the block's 227 KB.
// - bf16 and f16 at head_dim 33-256 whose q, k and v are whole 16-byte
//   units take the wgmma route instead (flash_fwd_wgmma_kernel<type, DP>,
//   head_dim padded to DP = 64, 128 or 256; wgmma_sm90.cuh): the instances
//   above are issue-bound on ldmatrix and mma.sync with nothing to hide
//   their latency, each warp reading the whole K and V tiles for its rows
//   (and at 256 Q again at every use); at 64 they ran at 20-22% of their
//   bound, at 256 at 20%. Here one block of a producer and NC consumer
//   warpgroups owns 64 NC query rows of one head (GTile: 3 consumers at 64
//   and 128, 2 at 256). The producer (its registers given back by
//   setmaxnreg) has one thread issue the TMA copies, in the 128-byte
//   swizzle: Q once (DP / 64 boxes of 64 columns), then each KV tile's K
//   and V (128 keys at 64, 64 at 128, 80 at 256) into a ring of stages (3 at
//   64 and 128, 2 at 256), each copy completing on a full mbarrier and each
//   stage handed back by an empty one (K as soon as the scores are
//   computed, V after P V). Each consumer owns 64 query rows and all DP
//   output columns (an m64nDP f32 accumulator): per KV tile S = Q K^T by
//   wgmma m64nBKVk16 with both operands in shared memory (DP / 16 steps of
//   depth 16), the online softmax of the instances on the accumulator in
//   registers (a warp's share of it is the m16n8 layout softmax_step
//   takes), O rescaled, P packed to the input's type as the A fragment,
//   and O += P V by wgmma m64nDPk16, A from registers and V read in place
//   as an MN-major operand. At 256 the two products of a tile run in turn.
//   At 64 and 128 the exponentials cost as much as the products (at D = 64
//   one ex2 for every 256 product FLOPs, against the H100's 989 / 3.9
//   TFLOP/s of products over special functions), so they must run under
//   products: S of tile j is issued with P V of tile j - 1 (O rescaled
//   first, so the sums keep the instances' order), and the consumers take
//   turns to issue them on named barriers (ping-pong), one's softmax under
//   another's products; a consumer's own softmax of tile j also runs while
//   its P V of tile j - 1 does. There the grid is one dimension
//   of blocks in order of their work, every head's heaviest causal tiles
//   first, so that the lightest fill the last wave. Whether a tile has a
//   masked entry is decided before its products are issued, so that no branch
//   sits between a product and its wait. Each product is computed once per
//   (warpgroup, KV tile), its operands read from shared memory by the
//   tensor cores themselves; a tile none of a warpgroup's rows may use
//   (past the causal diagonal, before the window) computes nothing. TMA
//   fills rows past S and columns past head_dim with zeros, as the copy
//   path does. f32 stays on mma.sync: a TF32 wgmma takes both operands
//   K-major, and V as P V's B operand is not; head_dim 32 and less stays
//   on the instances too.
// - head_dim 257-576 takes the wide route (flash_fwd_wide_kernel<type, DP>,
//   head_dim padded to DP = 512 or 576): no instance of the design above
//   fits, as the output accumulator of 256 columns is already 128 registers a
//   thread. One block of 8 warps owns one (query head, query tile) and all DP
//   output columns, and computes each score product once per (query tile, KV
//   tile): the WPM warps that share an m-tile (16 query rows) split the tile's
//   keys for S = Q K^T, each over the full depth, and its output columns for
//   O += P V. A 16-bit type takes 64-row query tiles, 2 warps an m-tile, each
//   owning DP / 2 output columns (128 f32 registers at 512, the 256 instance's
//   accumulator) and scoring 32 of a 64-key tile (16 of a 32-key tile at 576);
//   f32 takes 32-row query tiles, 4 warps an m-tile, each owning DP / 4
//   columns (64 registers) and scoring 8 of a 32-key tile, in four partial
//   sums of interleaved depth steps (one chain of 3 DP / 8 products, whose
//   sums the tensor cores round toward zero, measured 2.5x the error at 512 on
//   an H100). Per KV tile the warps of an m-tile exchange their rows' maxima
//   through shared memory under one named barrier of their own (bar.sync over
//   64 or 128 threads), write P (packed to a 16-bit input's type, f32 as it
//   is) and each thread's part of the row sums to shared memory, and after the
//   block's next barrier every warp reads the whole of its rows' P as the A
//   operand of P V and sums l from all the parts in one order. So m, l and lse
//   agree bit for bit across an m-tile's warps, and its first warp writes lse.
//   No f32 partial of a score crosses a warp. Q is staged once a block; K and
//   V, one full-depth tile each in shared memory, are copied in turn by
//   cp.async: V of tile j while S of tile j computes, K of tile j + 1 while
//   P V of tile j does. One wait and one block barrier cover each copy, plus
//   the m-tile's barrier a tile. At head_dim 512 the forward thus runs 1 + 1
//   products a tile (the streamed route below, one block a 128-column slice of
//   O, runs 4 + 1: each slice recomputes the full-depth scores). In a 16-bit
//   type, per 64 query rows x 64 keys, it copies K and V once (128 KB from L2
//   into shared memory, where the slices copied 576 KB: Q, K and a V slice
//   each, four times), and its warps read 656 KB of operands from shared
//   memory (Q 16 KB, K 32 KB, V 32 KB and P 2 KB a warp), where the streamed
//   slices read 1.5 MB. Shared memory: Q, K and V at DP + pad columns and P,
//   211,456 bytes at 512 in a 16-bit type and 205,312 in f32 (one block an
//   SM); at 576, 157,184 (32-key tiles) and 229,888.
// - head_dim above 576 takes the streamed route (flash_fwd_stream_kernel): Q,
//   K and V tiles of that width do not fit in shared memory beside P. Each
//   block owns one 128-column slice of O (the 128 instance's accumulators),
//   and the depth of S = Q K^T is streamed through shared memory in chunks of
//   256 bytes a row (64 f32 or 128 16-bit columns of Q and of K), two buffers
//   whatever head_dim: 69,632 bytes a block in every type, so any head_dim
//   runs. Each slice's block computes the full-width scores again, and every
//   slice runs the same instructions on the same scores, so m, l and lse agree
//   bit for bit across slices; slice 0 writes lse.
// - Per KV tile a warp of the instances (and of the streamed route)
//   computes its scores S = Q K^T (16 x BKV an m-tile) as mma
//   accumulators, the online softmax in registers in base 2 (scores
//   scaled by scale * log2 e, ex2.approx; a row spans the 4 threads of a
//   quad, so its max takes two shuffles, and its sum stays a per-thread
//   partial until the end), then O += P V with P never leaving the
//   registers: for a 16-bit type the m16n8k16 accumulators of two
//   adjacent 8-column score tiles are, packed to it, the A fragment of one
//   16-deep step; for f32 the m16n8k8 accumulator holds columns 2t and
//   2t + 1 where the A operand wants t and t + 4, so the depth index is
//   permuted (t <-> 2t, t + 4 <-> 2t + 1) in both P and V's rows, which
//   leaves the sum as it is. f16 packs P as bf16 does, rounded to
//   nearest; P lies in [0, 1], so it cannot overflow. Tiles with no
//   masked entry (most of a long sequence) skip the mask arithmetic.
// - The tensor cores round their f32 sums toward zero, and an O row sums
//   up to 16384 keys. On f32 each KV tile's P V is therefore summed from
//   zero and folded into O as o = o * corr + pv, rounded to nearest.
// - Operands stay in their own type in shared memory: 16-bit rows padded
//   to D + 8 elements and read with ldmatrix (.trans for V), f32 rows padded
//   to D + 4 and read with 32-bit loads; both free of bank conflicts. A
//   tensor whose pointer, strides or head_dim are not whole 16-byte
//   units takes a scalar load path instead (per tensor, chosen by the
//   launcher).
//
// q, k and v are read through their (S, heads, head_dim) strides (the LM
// hands over views of one projection); O is written contiguous (S, H, D)
// in q's type.

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int WARPS = 4;           // warps per block
constexpr int NT = 32 * WARPS;     // threads per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;

// Key/value rows per tile: 64, or 32 for f32 beyond head_dim 128. A
// thread's keep bits of a tile (4 per 8-column score tile) fit a word.
__host__ __device__ constexpr int kv_rows(bool f32, int dp) {
  return f32 && dp > 128 ? 32 : 64;
}

// 16-row m-tiles per warp: each K and V fragment a warp loads (and, for
// f32, splits) feeds MT products. Two where ptxas then spills nothing
// (f32 to head_dim 32, bf16 and f16 to 64; about 220 and 254
// registers), else
// one.
__host__ __device__ constexpr int m_tiles(bool f32, int dp) {
  return (f32 ? dp <= 32 : dp <= 64) ? 2 : 1;
}

// Query rows per block.
__host__ __device__ constexpr int q_rows(bool f32, int dp) {
  return 16 * WARPS * m_tiles(f32, dp);
}

// Blocks per SM the compiler must leave registers for: 2, so at most 255
// registers a thread.
constexpr int MIN_BLOCKS = 2;

// Accumulator tiles of one f32 P V pass, summed from zero before the
// fold: 4 where they fit beside the output (head_dim up to 32), else 2.
__host__ __device__ constexpr int pv_group(int dp) {
  return dp <= 32 ? dp / 8 : 2;
}

// The wide route (head_dim 257-576, padded to 512 or W_MAX_DP): warps a
// block, and the widest padded head_dim it takes; the streamed route takes
// the widths above.
constexpr int W_WARPS = 8;
constexpr int W_NT = 32 * W_WARPS;
constexpr int W_MAX_DP = 576;

// The wide route's tiles for type T and padded head_dim DP: BQ query rows
// a block, BKV keys a tile, WPM warps an m-tile (each scoring KPW keys of
// a tile and owning DP / WPM output columns), and P's row stride LDP.
template <typename T, int DP> struct Wide {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BQ = F32 ? 32 : 64;
  static constexpr int BKV = F32 || DP > 512 ? 32 : 64;
  static constexpr int WPM = W_WARPS * 16 / BQ;
  static constexpr int KPW = BKV / WPM;
  static constexpr int LDP = BKV + Pad<T>::value;
};

// Dynamic shared memory of one block of the wide route: the Q, K and V
// tiles, P, and the m-tiles' row maxima and sum parts.
template <typename T, int DP>
constexpr int wide_smem_bytes() {
  using W = Wide<T, DP>;
  return (int)((W::BQ + 2 * W::BKV) * (DP + Pad<T>::value) * sizeof(T) +
               W::BQ * W::LDP * sizeof(T) +
               W_WARPS * (16 + 64) * sizeof(float));
}

// The streamed route (head_dim above 576): output columns a block, and
// rows of its query tile and of each KV tile.
constexpr int ST_COLS = 128;
constexpr int ST_ROWS = 64;

// Depth of one chunk of the streamed route's score product: 256 bytes of
// a row (64 f32, 128 of a 16-bit type).
template <typename T>
__host__ __device__ constexpr int stream_chunk() {
  return 256 / (int)sizeof(T);
}

// Elements of one of the streamed route's two stage buffers: a chunk of Q
// and of K, or a V slice, whichever is larger.
template <typename T>
__host__ __device__ constexpr int stream_buf() {
  constexpr int qk = 2 * ST_ROWS * (stream_chunk<T>() + Pad<T>::value);
  constexpr int vs = ST_ROWS * (ST_COLS + Pad<T>::value);
  return qk > vs ? qk : vs;
}

// Dynamic shared memory of one block of the streamed route, whatever
// head_dim.
template <typename T>
constexpr int stream_smem_bytes() {
  return (int)(2 * stream_buf<T>() * sizeof(T));
}

struct Strides {                   // row (ss) and head (sh) strides, elements
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
};

// Bits of `vec`: the 16-byte copy path may be used for q, k, v.
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4;

// The warp's Q as A fragments of its MT m-tiles. 16-bit types: one
// ldmatrix x4 per m-tile and 16-deep step, held in MT DP / 4 registers up
// to head_dim 128 and loaded again from shared memory at each use beyond.
template <typename T, int DP, int MT> struct QFrags {
  static_assert(sizeof(T) == 2, "f32 has its own QFrags");
  static constexpr int LD = DP + Pad<T>::value;
  static constexpr bool IN_REGS = DP <= 128;
  uint32_t a[IN_REGS ? MT : 1][IN_REGS ? DP / 16 : 1][4];
  const T* rows;                   // the lane's ldmatrix row, m-tile 0

  __device__ __forceinline__ void load(const T* sq, int wrow, int lane) {
    rows = sq + (wrow + (lane & 15)) * LD + (lane >> 4) * 8;
    if constexpr (IN_REGS) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldsm_x4(a[mt][kk], rows + mt * 16 * LD + kk * 16);
    }
  }
  __device__ __forceinline__ void get(int mt, int kk,
                                      uint32_t (&r)[4]) const {
    if constexpr (IN_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = a[mt][kk][e];
    } else {
      ldsm_x4(r, rows + mt * 16 * LD + kk * 16);
    }
  }
};

// f32: big and small of each m-tile and 8-deep step, split again from
// shared memory at each use (2 MT DP registers would not fit beside the
// accumulators).
template <int DP, int MT> struct QFrags<float, DP, MT> {
  static constexpr int LD = DP + Pad<float>::value;
  const float* rows;               // the warp's row g, column t

  __device__ __forceinline__ void load(const float* sq, int wrow, int lane) {
    rows = sq + (wrow + (lane >> 2)) * LD + (lane & 3);
  }
  __device__ __forceinline__ void get(int mt, int kk, uint32_t (&ab)[4],
                                      uint32_t (&as)[4]) const {
    const float* ra = rows + mt * 16 * LD + kk * 8;
    split(ra[0], ab[0], as[0]);
    split(ra[8 * LD], ab[1], as[1]);
    split(ra[4], ab[2], as[2]);
    split(ra[8 * LD + 4], ab[3], as[3]);
  }
};

// The warp's 16 MT x 8 NJ scores Q K^T: s[mt][j] holds key columns
// 8j..8j+7 of the tile sk for m-tile mt as an m16n8 accumulator fragment.
template <int DP, int MT, int NJ, typename T, if_16bit<T> = 0>
__device__ __forceinline__ void scores(float (&s)[MT][NJ][4],
                                       const QFrags<T, DP, MT>& qf,
                                       const T* sk, int lane) {
  constexpr int LD = DP + Pad<T>::value;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) qf.get(mt, kk, a[mt]);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, sk + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16<T>(s[mt][2 * jj], a[mt], b[0], b[1]);
        mma16<T>(s[mt][2 * jj + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int DP, int MT, int NJ>
__device__ __forceinline__ void scores(float (&s)[MT][NJ][4],
                                       const QFrags<float, DP, MT>& qf,
                                       const float* sk, int lane) {
  constexpr int LD = DP + Pad<float>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) qf.get(mt, kk, ab[mt], as[mt]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* rb = sk + (j * 8 + g) * LD + kk * 8 + t;
      uint32_t bb[2], bs[2];
      split(rb[0], bb[0], bs[0]);
      split(rb[4], bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(s[mt][j], ab[mt], as[mt], bb, bs);
    }
  }
}

// o = o * corr + P V for the warp's rows: P (the accumulator fragments of
// scores(), now probabilities) as the A operand, V the 8 NJ x DP tile sv.
// o[mt][n] holds head_dim columns 8n..8n+7 of m-tile mt; corr[mt][r] is
// the rescale of its row g + 8r.
template <int DP, int MT, int NJ, typename T, if_16bit<T> = 0>
__device__ __forceinline__ void accumulate(float (&o)[MT][DP / 8][4],
                                           const float (&p)[MT][NJ][4],
                                           const float (&corr)[MT][2],
                                           const T* sv, int lane) {
  constexpr int LD = DP + Pad<T>::value;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] *= corr[mt][e >> 1];
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    // Two 8-column accumulator tiles are one 16-deep A fragment.
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack16<T>(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      a[mt][1] = pack16<T>(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      a[mt][2] = pack16<T>(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      a[mt][3] = pack16<T>(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int nn = 0; nn < DP / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_trans(b, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + nn * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16<T>(o[mt][2 * nn], a[mt], b[0], b[1]);
        mma16<T>(o[mt][2 * nn + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int DP, int MT, int NJ>
__device__ __forceinline__ void accumulate(float (&o)[MT][DP / 8][4],
                                           const float (&p)[MT][NJ][4],
                                           const float (&corr)[MT][2],
                                           const float* sv, int lane) {
  constexpr int LD = DP + Pad<float>::value;
  constexpr int ND = DP / 8;
  constexpr int NG = pv_group(DP);      // accumulator tiles per pass
  const int g = lane >> 2, t = lane & 3;
  // The tile's product is summed from zero, then folded into o with one
  // rounded fma: the tensor cores' own f32 sums round toward zero.
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
      // Depth index permuted: A's k = t is key 8j + 2t, k = t + 4 is
      // 8j + 2t + 1, the columns this thread's accumulators hold.
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(p[mt][j][0], ab[mt][0], as[mt][0]);
        split(p[mt][j][2], ab[mt][1], as[mt][1]);
        split(p[mt][j][1], ab[mt][2], as[mt][2]);
        split(p[mt][j][3], ab[mt][3], as[mt][3]);
      }
      const float* rb = sv + (j * 8 + 2 * t) * LD + g;
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
        for (int e = 0; e < 4; ++e)
          o[mt][n0 + n][e] =
              fmaf(o[mt][n0 + n][e], corr[mt][e >> 1], part[mt][n][e]);
  }
}

// One KV tile's step of the online softmax on the warp's raw scores s
// (key tile k0 of the block's query tile q0): masks them, updates the
// running max m (base 2, scaled) and the thread's part of the running sum
// l, leaves the probabilities in s, and gives each row's rescale of the
// output in corr. MASKED 0 or 1 says whether the tile has a masked entry,
// where the caller has decided it (no branch on it is then compiled);
// -1 decides here.
template <int BQ, int BKV, int MT, int NJ, int MASKED = -1>
__device__ __forceinline__ void softmax_step(
    float (&s)[MT][NJ][4], float (&m)[MT][2], float (&l)[MT][2],
    float (&corr)[MT][2], int q0, int k0, int wrow, int lane, int S,
    int causal, int window, float scale_log2) {
  // A thread's keep bits of a tile: a word, or two beyond 8 score tiles.
  using Bits = std::conditional_t<(NJ * 4 > 32), uint64_t, uint32_t>;
  const int g = lane >> 2, t = lane & 3;
  // Whether any entry of this tile is masked (diagonal, window edge or
  // ragged keys); the same for the whole block, so no warp diverges.
  // Query rows past S are left unmasked: their Q rows are zeros, and
  // they are never written.
  bool masked = MASKED == 1;
  if constexpr (MASKED < 0) {
    masked = k0 + BKV > S;
    if (causal)
      masked = masked || k0 + BKV - 1 > q0 ||
               (window > 0 && q0 + BQ - 1 - k0 >= window);
  }
  Bits kept[MT];                  // bit 4j + e: entry s[mt][j][e] is kept
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    kept[mt] = ~Bits(0);
    if (masked) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + wrow + mt * 16 + g + (e >> 1) * 8;
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          if (!keep(qi, kj, S, causal, window)) {
            kept[mt] &= ~(Bits(1) << (4 * j + e));
            s[mt][j][e] = kNegInf;
          }
        }
    }
  }

  // Online softmax on the raw scores: max(raw) * scale_log2 is the
  // scaled max, and p = 2^(raw * scale_log2 - m).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[mt][r], mx * scale_log2);
      corr[mt][r] = ex2(m[mt][r] - m_new);
      m[mt][r] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          float p = ex2(fmaf(s[mt][j][e], scale_log2, -m_new));
          if (masked && !(kept[mt] >> (4 * j + e) & 1)) p = 0.f;
          s[mt][j][e] = p;
          ls += p;
        }
      l[mt][r] = l[mt][r] * corr[mt][r] + ls;
    }
}

// Writes the warp's rows of O, columns col0 + 8 ND of them (those below
// D), as acc / l, and with col0 0 each row's lse.
template <typename T, int MT, int ND>
__device__ __forceinline__ void store_out(const float (&acc)[MT][ND][4],
                                          const float (&m)[MT][2],
                                          const float (&l)[MT][2], T* o,
                                          float* lse, int q0, int wrow,
                                          int lane, int S, int H, int h,
                                          int D, int col0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qi = q0 + wrow + mt * 16 + g + r * 8;
      if (qi >= S) continue;
      // A fully masked row has l = 0: it takes l = 1 and the reference's
      // masked max, -1e30.
      const float li = lr == 0.f ? 1.f : lr;
      T* orow = o + ((long long)qi * H + h) * D + col0;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + 2 * t + c;
          if (col0 + col < D) store(orow + col, acc[mt][n][2 * r + c] / li);
        }
      if (t == 0 && col0 == 0)
        lse[(long long)h * S + qi] =
            lr == 0.f ? kNegInf : m[mt][r] * LN2 + logf(li);
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int group, int D,
                 Strides st, int vec, int causal, int window, float scale) {
  constexpr int MT = m_tiles(sizeof(T) == 4, DP);
  constexpr int BQ = q_rows(sizeof(T) == 4, DP);
  constexpr int BKV = kv_rows(sizeof(T) == 4, DP);
  constexpr int NJ = BKV / 8;       // 8-column score tiles per m-tile
  constexpr int ND = DP / 8;        // 8-column accumulator tiles
  constexpr int LD = DP + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);     // BQ x LD
  T* sk = sq + BQ * LD;                       // 2 buffers of BKV x LD
  T* sv = sk + 2 * BKV * LD;                  // 2 buffers of BKV x LD

  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16 * MT;  // the warp's first row
  const int h = blockIdx.y;
  const int kvh = h / group;
  // Heaviest causal tiles (the last query rows) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  // _run_window as loop bounds: causal tiles end at the diagonal; a
  // window starts at the first tile holding a key some row may attend.
  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BKV) * BKV;
    }
  }
  const int n_it = (kv_end - kv_begin + BKV - 1) / BKV;

  // Stages KV tile `it` into buffer it & 1.
  auto stage = [&](int it) {
    const int k0 = kv_begin + it * BKV;
    const int b = it & 1;
    load_tile<T, DP, BKV, NT>(sk + b * BKV * LD, k + kvh * st.k_sh, k0, S,
                              D, st.k_ss, vec & VEC_K);
    load_tile<T, DP, BKV, NT>(sv + b * BKV * LD, v + kvh * st.v_sh, k0, S,
                              D, st.v_ss, vec & VEC_V);
  };

  load_tile<T, DP, BQ, NT>(sq, q + h * st.q_sh, q0, S, D, st.q_ss,
                           vec & VEC_Q);
  if (n_it > 0) stage(0);
  cp_async_commit();

  QFrags<T, DP, MT> qf;
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // Rows g and g + 8 of each m-tile: running max (base 2, scaled) and
  // this thread's part of the running sum.
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1, whose
    // buffers the copy of tile it + 1 now overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();
    if (it == 0) qf.load(sq, wrow, lane);   // Q landed with tile 0

    const int k0 = kv_begin + it * BKV;
    const int b = it & 1;
    float s[MT][NJ][4];
    scores<DP, MT, NJ>(s, qf, sk + b * BKV * LD, lane);

    float corr[MT][2];
    softmax_step<BQ, BKV>(s, m, l, corr, q0, k0, wrow, lane, S, causal,
                          window, scale_log2);
    accumulate<DP, MT, NJ>(acc, s, corr, sv + b * BKV * LD, lane);
  }
  store_out(acc, m, l, o, lse, q0, wrow, lane, S, H, h, D, 0);
}

// An f32 warp's scores of its keys over the full depth, as abt computes
// them but in NA partial sums of interleaved depth steps (kk, kk + NA,
// ...), added with rounded f32 adds at the end: one 8-key tile would be a
// single chain of 3 DP / 8 dependent products, whose sums the tensor cores
// round toward zero.
template <int DP, int NJ>
__device__ __forceinline__ void wide_scores_f32(float (&s)[1][NJ][4],
                                                const float* sq,
                                                const float* sk, int wrow,
                                                int lane) {
  constexpr int NA = 4;
  constexpr int LD = DP + Pad<float>::value;
  static_assert(DP / 8 % NA == 0, "whole rounds of the partial sums");
  const int g = lane >> 2, t = lane & 3;
  float part[NA][NJ][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[a][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const float* ra = sq + (wrow + g) * LD + kk * 8 + t;
    uint32_t ab[4], as[4];
    split(ra[0], ab[0], as[0]);
    split(ra[8 * LD], ab[1], as[1]);
    split(ra[4], ab[2], as[2]);
    split(ra[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* rb = sk + (j * 8 + g) * LD + kk * 8 + t;
      uint32_t bb[2], bs[2];
      split(rb[0], bb[0], bs[0]);
      split(rb[4], bb[1], bs[1]);
      mma_3xtf32(part[kk % NA][j], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[0][j][e] = (part[0][j][e] + part[1][j][e]) +
                   (part[2][j][e] + part[3][j][e]);
}

// The wide route's online softmax for one KV tile (keys from k0), on the
// warp's raw scores s of its KPW keys (from key0 of the tile) for the 16
// rows of m-tile mt (query rows q0 + 16 mt..): masks them, takes each
// row's max over the keys of all WPM warps of the m-tile (their maxima
// meet in smax under the m-tile's barrier), updates m and gives the
// rescale corr, leaves the probabilities in s, writes them to P (sp,
// rows of LDP) in the P V operand's type, and this thread's part of each
// row's sum to ssum. The block's next barrier makes P and the parts
// visible to the m-tile's warps.
template <typename T, int BQ, int BKV, int WPM, int LDP, int NJ>
__device__ __forceinline__ void wide_softmax(
    float (&s)[1][NJ][4], float (&m)[1][2], float (&corr)[2], T* sp,
    float* smax, float* ssum, int q0, int k0, int key0, int mt, int warp,
    int lane, int S, int causal, int window, float scale_log2) {
  static_assert(NJ * 4 <= 32, "a thread's keep bits of a tile fit a word");
  const int g = lane >> 2, t = lane & 3;
  const int wrow = mt * 16;
  // Whether any entry of the block's tile is masked: the same for every
  // warp (softmax_step's predicate).
  bool masked = k0 + BKV > S;
  if (causal)
    masked = masked || k0 + BKV - 1 > q0 ||
             (window > 0 && q0 + BQ - 1 - k0 >= window);
  uint32_t kept = 0xffffffffu;    // bit 4j + e: entry s[0][j][e] is kept
  if (masked) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + wrow + g + (e >> 1) * 8;
        const int kj = k0 + key0 + j * 8 + 2 * t + (e & 1);
        if (!keep(qi, kj, S, causal, window)) {
          kept &= ~(1u << (4 * j + e));
          s[0][j][e] = kNegInf;
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(s[0][j][2 * r], s[0][j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (t == 0) smax[warp * 16 + g + 8 * r] = mx;
  }
  bar_sync(1 + mt, 32 * WPM);
  const int first = mt * WPM;     // the m-tile's first warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // The row's max over the whole tile, raw; times scale_log2 it is the
    // scaled max, and p = 2^(raw * scale_log2 - m).
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WPM; ++w)
      mx = fmaxf(mx, smax[(first + w) * 16 + g + 8 * r]);
    const float m_new = fmaxf(m[0][r], mx * scale_log2);
    corr[r] = ex2(m[0][r] - m_new);
    m[0][r] = m_new;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * r + c;
        float p = ex2(fmaf(s[0][j][e], scale_log2, -m_new));
        if (masked && !(kept >> (4 * j + e) & 1u)) p = 0.f;
        s[0][j][e] = p;
        ls += p;
      }
    ssum[(warp * 2 + r) * 32 + lane] = ls;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T* row = sp + (wrow + g + 8 * r) * LDP + key0 + j * 8 + 2 * t;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(row) =
            pack16<T>(s[0][j][2 * r], s[0][j][2 * r + 1]);
      else
        *reinterpret_cast<float2*>(row) =
            make_float2(s[0][j][2 * r], s[0][j][2 * r + 1]);
    }
}

// o = o * corr + P V for the warp's 16 rows (from wrow) and DN output
// columns (from col0): P (BKV keys, rows of LDP in shared memory, the
// m-tile's warps' parts together) as the A operand, read with ldmatrix;
// V the BKV x DP tile sv, read with ldmatrix .trans.
template <int DP, int DN, int BKV, int LDP, typename T, if_16bit<T> = 0>
__device__ __forceinline__ void wide_pv(float (&o)[1][DN / 8][4],
                                        const float (&corr)[2], const T* sp,
                                        const T* sv, int wrow, int col0,
                                        int lane) {
  constexpr int LD = DP + Pad<T>::value;
#pragma unroll
  for (int n = 0; n < DN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][n][e] *= corr[e >> 1];
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sp + (wrow + (lane & 15)) * LDP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < DN / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_trans(b, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + col0 + nn * 16 + (lane >> 4) * 8);
      mma16<T>(o[0][2 * nn], a, b[0], b[1]);
      mma16<T>(o[0][2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// f32 as 3xTF32, P's fragments split once a tile. The depth index is
// permuted as in accumulate (A's k = t is key 8j + 2t, k = t + 4 is
// 8j + 2t + 1), which keeps V's reads free of bank conflicts. The tile's
// product is summed from zero, NG accumulator tiles at a time, then
// folded into o with one rounded fma: the tensor cores' own f32 sums
// round toward zero.
template <int DP, int DN, int BKV, int LDP>
__device__ __forceinline__ void wide_pv(float (&o)[1][DN / 8][4],
                                        const float (&corr)[2],
                                        const float* sp, const float* sv,
                                        int wrow, int col0, int lane) {
  constexpr int LD = DP + Pad<float>::value;
  constexpr int ND = DN / 8, NK = BKV / 8;
  constexpr int NG = ND % 4 == 0 ? 4 : 2;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ab[NK][4], as[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float* ra = sp + (wrow + g) * LDP + j * 8 + 2 * t;
    split(ra[0], ab[j][0], as[j][0]);
    split(ra[8 * LDP], ab[j][1], as[j][1]);
    split(ra[1], ab[j][2], as[j][2]);
    split(ra[8 * LDP + 1], ab[j][3], as[j][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float* rb = sv + (j * 8 + 2 * t) * LD + col0 + g;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bb[2], bs[2];
        split(rb[(n0 + n) * 8], bb[0], bs[0]);
        split(rb[LD + (n0 + n) * 8], bb[1], bs[1]);
        mma_3xtf32(part[n], ab[j], as[j], bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[0][n0 + n][e] = fmaf(o[0][n0 + n][e], corr[e >> 1], part[n][e]);
  }
}

// The wide route's kernel (head_dim 257-576 padded to DP; the file's
// header says how it works and why). Per KV tile: wait for K, stage V,
// S = Q K^T over the warp's keys, the m-tile's softmax exchange; wait for
// V, stage the next K, O += P V over the warp's columns.
template <typename T, int DP>
__global__ void __launch_bounds__(W_NT, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int S, int H, int group,
                      int D, Strides st, int vec, int causal, int window,
                      float scale) {
  using W = Wide<T, DP>;
  constexpr int BQ = W::BQ, BKV = W::BKV, WPM = W::WPM, LDP = W::LDP;
  constexpr int NJ = W::KPW / 8;        // 8-key score tiles a warp
  constexpr int DN = DP / WPM;          // output columns a warp
  constexpr int LD = DP + Pad<T>::value;
  static_assert(DN % 16 == 0, "a warp's columns are whole 16-column steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);     // BQ x LD
  T* sk = sq + BQ * LD;                       // BKV x LD
  T* sv = sk + BKV * LD;                      // BKV x LD
  T* sp = sv + BKV * LD;                      // BQ x LDP: the tile's P
  float* smax = reinterpret_cast<float*>(sp + BQ * LDP);  // [warp][16]
  float* ssum = smax + W_WARPS * 16;          // [warp][2][32]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp / WPM, part = warp % WPM;
  const int wrow = mt * 16;             // the m-tile's first row
  const int key0 = part * W::KPW;       // the warp's first key of a tile
  const int col0 = part * DN;           // and its first output column
  const int h = blockIdx.y;
  const T* kh = k + (h / group) * st.k_sh;
  const T* vh = v + (h / group) * st.v_sh;
  // Heaviest causal tiles (the last query rows) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BKV) * BKV;
    }
  }
  const int n_it = (kv_end - kv_begin + BKV - 1) / BKV;

  load_tile<T, DP, BQ, W_NT>(sq, q + h * st.q_sh, q0, S, D, st.q_ss,
                             vec & VEC_Q);
  if (n_it > 0)
    load_tile<T, DP, BKV, W_NT>(sk, kh, kv_begin, S, D, st.k_ss,
                                vec & VEC_K);
  cp_async_commit();

  float acc[1][DN / 8][4];
  zero(acc);
  // Rows g and g + 8 of the m-tile: running max (base 2, scaled) and this
  // thread's part of the running sum, the same in each of its warps.
  float m[1][2] = {{kNegInf, kNegInf}}, l[1][2] = {{0.f, 0.f}};
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int k0 = kv_begin + it * BKV;
    // Q and K of this tile have landed, and every warp is done with the
    // last tile's V, whose buffer this tile's V now fills.
    cp_async_wait_all();
    __syncthreads();
    load_tile<T, DP, BKV, W_NT>(sv, vh, k0, S, D, st.v_ss, vec & VEC_V);
    cp_async_commit();

    float s[1][NJ][4];
    if constexpr (sizeof(T) == 2)
      abt<DP, 1, NJ>(s, sq, sk + key0 * LD, wrow, lane);
    else
      wide_scores_f32<DP>(s, sq, sk + key0 * LD, wrow, lane);
    float corr[2];
    wide_softmax<T, BQ, BKV, WPM, LDP>(s, m, corr, sp, smax, ssum, q0, k0,
                                       key0, mt, warp, lane, S, causal,
                                       window, scale_log2);
    // V has landed, P and the sum parts are visible, and every warp is
    // done with K, whose buffer the next tile's K now fills.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it)
      load_tile<T, DP, BKV, W_NT>(sk, kh, k0 + BKV, S, D, st.k_ss,
                                  vec & VEC_K);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < WPM; ++w)
        ls += ssum[((mt * WPM + w) * 2 + r) * 32 + lane];
      l[0][r] = l[0][r] * corr[r] + ls;
    }
    wide_pv<DP, DN, BKV, LDP>(acc, corr, sp, sv, wrow, col0, lane);
  }
  store_out(acc, m, l, o, lse, q0, wrow, lane, S, H, h, D, col0);
}

// The streamed route's kernel (head_dim above 576; the file's header
// says why): one block of 4 warps owns one 128-column slice of O for one
// (query head, 64-row query tile), one 16-row m-tile a warp. Per KV tile
// it streams the depth of S = Q K^T through shared memory, DC columns of
// Q and of K at a time, then stages the tile's V slice and folds P V into
// its 128-column accumulators, the 128 instance's. Every stage (a chunk
// pair, or a V slice) goes into one of two buffers by cp.async while the
// other one computes: one wait and one barrier a stage.
template <typename T, int DC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
flash_fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int S, int H, int group,
                        int D, Strides st, int vec, int causal, int window,
                        float scale) {
  constexpr int BQ = ST_ROWS, BKV = ST_ROWS;
  constexpr int NJ = BKV / 8;           // 8-column score tiles
  constexpr int ND = ST_COLS / 8;       // 8-column accumulator tiles
  constexpr int LDC = DC + Pad<T>::value;   // row stride of a chunk tile
  constexpr int BUF = stream_buf<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbuf = reinterpret_cast<T*>(smem_raw);   // 2 stage buffers of BUF

  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;   // the warp's first row
  const int h = blockIdx.y;
  const int kvh = h / group;
  // The slices of one query tile are neighbours in the grid, so they read
  // the same Q and K chunks at about the same time (from L2); the
  // heaviest causal tiles (the last query rows) are scheduled first.
  const int n_slices = (D + ST_COLS - 1) / ST_COLS;
  const int col0 = (blockIdx.x % n_slices) * ST_COLS;
  const int q0 = (gridDim.x / n_slices - 1 - blockIdx.x / n_slices) * BQ;

  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BKV) * BKV;
    }
  }
  const int n_it = (kv_end - kv_begin + BKV - 1) / BKV;
  const int n_chunks = (D + DC - 1) / DC;
  const int per_tile = n_chunks + 1;    // stages a KV tile: chunks, then V
  const int n_st = n_it * per_tile;

  // Stages `u` into buffer u & 1: chunk c of Q and K (rows BQ of Q, then
  // BKV of K, LDC apart), or the V slice (BKV rows, ST_COLS + pad apart).
  auto stage = [&](int u) {
    const int k0 = kv_begin + (u / per_tile) * BKV;
    const int c = u % per_tile;
    T* b = sbuf + (u & 1) * BUF;
    if (c < n_chunks) {
      const int c0 = c * DC;
      load_tile<T, DC, BQ, NT>(b, q + h * st.q_sh + c0, q0, S, D - c0,
                               st.q_ss, vec & VEC_Q);
      load_tile<T, DC, BKV, NT>(b + BQ * LDC, k + kvh * st.k_sh + c0, k0, S,
                                D - c0, st.k_ss, vec & VEC_K);
    } else {
      load_tile<T, ST_COLS, BKV, NT>(b, v + kvh * st.v_sh + col0, k0, S,
                                    D - col0, st.v_ss, vec & VEC_V);
    }
  };

  if (n_st > 0) stage(0);
  cp_async_commit();

  float acc[1][ND][4];
  zero(acc);
  float m[1][2] = {{kNegInf, kNegInf}}, l[1][2] = {{0.f, 0.f}};
  float s[1][NJ][4];
  const float scale_log2 = scale * LOG2E;

  for (int u = 0; u < n_st; ++u) {
    // Stage u has landed, and every warp is done with stage u - 1, whose
    // buffer the copy of stage u + 1 now overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (u + 1 < n_st) stage(u + 1);
    cp_async_commit();
    const T* b = sbuf + (u & 1) * BUF;
    const int c = u % per_tile;
    if (c < n_chunks) {
      if (c == 0) zero(s);
      abt<DC, 1, NJ, true>(s, b, b + BQ * LDC, wrow, lane);
    } else {
      float corr[1][2];
      softmax_step<BQ, BKV>(s, m, l, corr, q0,
                            kv_begin + (u / per_tile) * BKV, wrow, lane, S,
                            causal, window, scale_log2);
      accumulate<ST_COLS, 1, NJ>(acc, s, corr, b, lane);
    }
  }
  store_out(acc, m, l, o, lse, q0, wrow, lane, S, H, h, D, col0);
}

// The wgmma route (16-bit head_dim 33-256, whole 16-byte units; the
// file's header says how it works and why), at head_dim 129-256 (padded
// to 256): query rows a block, keys a KV tile (80, FlashAttention-3's tile
// at this width: 5% faster than 64 on an H100, with 230,472 bytes of
// shared memory), threads a block (a producer and two consumer
// warpgroups), and the registers a thread of each role keeps (24 to 256,
// multiples of 8, at most 65,536 a block: 128 x 40 + 256 x 232). Columns
// of a TMA box: 128 bytes of a 16-bit type, the swizzle's width.
constexpr int G_BQ = 128;
constexpr int G_BKV = 80;
constexpr int G_NT = 384;
constexpr int G_BOX = TMA_COLS;
constexpr int G_PRODUCER_REGS = 40;
constexpr int G_CONSUMER_REGS = 232;

// The wgmma route's tiles and roles at padded head_dim DP (64, 128 or
// 256): NC consumer warpgroups of 64 query rows (BQ rows a block), BKV keys
// a KV tile, NT threads (NC + 1 warpgroups), each role's registers, the
// ring's STAGES, the order of the blocks (HEADS_FIRST: the heaviest causal
// tiles of every head first, so that the lightest run last), and the
// consumers' schedule. At 256 a consumer runs a tile's two products in
// turn (S; softmax; P V). At 64 and 128 it is PIPELINED: S of tile j is
// issued with P V of tile j - 1, and the softmax of tile j runs while
// that P V does, so that the exponentials of a softmax (one for every 4 D
// product FLOPs of a kept score: at D = 64 the special-function units'
// time equals the tensor cores') run under products; the consumers issue
// their products in turn (ping-pong), handing on named barriers, so that
// one warpgroup's softmax also runs under another's products. What an H100
// measured (NVIDIA H100 80GB HBM3, 700 W, kernel_ab.py, causal): at
// (16384, 8, 64) bf16, two stages, 3 consumers of 160 registers with
// ping-pong alone (the softmax after P V's wait) 0.624 ms, with the
// softmax under P V too 0.633, that alone 0.680, neither 0.761; 2
// consumers 0.660-0.779 (in turn 0.719); a third stage 0.606 against
// 0.602 with the softmax under P V (a fourth 0.660); HEADS_FIRST 0.545
// against 0.602; then, in one call, the softmax under P V 0.5214 against
// 0.5408 after P V's wait. At (8192, 8, 1, 256) bf16 HEADS_FIRST took
// 0.4260 against 0.5050 (256 keeps its 2-D grid for now). At (8192, 32,
// 8, 128) bf16, 2 consumers and 128-key tiles with ping-pong and the
// softmax under P V 0.986 ms, ping-pong alone 1.025, the softmax under P V
// alone 1.200, neither 1.176, in turn 1.106; a third stage 0.921; 3
// consumers (160 registers: S of 64 keys beside the m64n128 output) and
// 64-key tiles 0.923 against 0.948 (ping-pong alone 0.972, a fourth stage
// 1.094). At 64 these are FlashAttention-3's tiles (192 x 128).
template <int DP> struct GTile {
  static_assert(DP == 64 || DP == 128 || DP == 256, "64, 128 or 256");
  static constexpr int NC = DP == 256 ? 2 : 3;
  static constexpr int BQ = 64 * NC;
  static constexpr int BKV = DP == 256 ? G_BKV : DP == 128 ? 64 : 128;
  static constexpr int NT = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = NC == 3 ? 32 : G_PRODUCER_REGS;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : G_CONSUMER_REGS;
  static constexpr int STAGES = DP == 256 ? 2 : 3;
  static constexpr bool PIPELINED = DP != 256;
  static constexpr bool HEADS_FIRST = DP != 256;
};
static_assert(GTile<256>::BQ == G_BQ && GTile<256>::NT == G_NT,
              "head_dim 129-256 keeps its tiles");

// The wgmma route's shared memory for type T and padded head_dim DP, in
// bytes: Q's boxes (BQ rows of 128 bytes each), one K or V tile (DP /
// G_BOX boxes of BKV rows), and the block's total: 1024 to align the
// tiles, Q, the ring's stages of K and of V, and its mbarriers (Q full; K
// full, V full, K empty and V empty of each stage).
template <typename T, int DP> struct Gmma {
  static_assert(sizeof(T) == 2 && DP % G_BOX == 0, "16-bit, whole boxes");
  static constexpr int BOXES = DP / G_BOX;
  static constexpr int Q_BOX = GTile<DP>::BQ * G_BOX * (int)sizeof(T);
  static constexpr int KV_BOX = GTile<DP>::BKV * G_BOX * (int)sizeof(T);
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int STAGES = GTile<DP>::STAGES;
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 4 * STAGES) * 8;
};

// The wgmma route's kernel. tq, tk and tv are the 3-D tensor maps (D,
// heads, S) of q, k and v, with boxes of G_BOX columns, one head and BQ
// (q) or BKV (k, v) rows.
template <typename T, int DP>
__global__ void __launch_bounds__(GTile<DP>::NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, float* __restrict__ lse, int S,
                       int H, int group, int D, int causal, int window,
                       float scale) {
  using G = Gmma<T, DP>;
  using Tl = GTile<DP>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, NC = Tl::NC, NS = Tl::STAGES;
  constexpr int NJ = BKV / 8;           // 8-key score tiles
  extern __shared__ __align__(16) unsigned char gsmem_raw[];
  // Shared-window addresses: Q, K's and V's stages, the barriers.
  const uint32_t sq = (smem_addr(gsmem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + G::Q_BYTES;
  const uint32_t sv = sk + NS * G::KV_BYTES;
  const uint32_t q_full = sv + NS * G::KV_BYTES;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * NS;
  const uint32_t k_empty = v_full + 8 * NS, v_empty = k_empty + 8 * NS;
  // KV tile it goes into stage it % NS of the ring; the parity of that
  // stage's use is the phase its barriers wait for (a stage's first
  // empty wait, for parity 1, passes at once).
  auto stage = [](int it) { return (int)((uint32_t)it % NS); };
  auto use = [](int it) { return ((uint32_t)it / NS) & 1; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warpgroup, read from lane 0 so that the compiler knows that it is
  // the same across the warp: the two roles then keep their own register
  // budgets (setmaxnreg), and the consumers' descriptors live in uniform
  // registers, as wgmma takes them.
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  // Heaviest causal tiles (the last query rows) are scheduled first: with
  // HEADS_FIRST every head's, the grid's blocks in order of their work
  // (one dimension, the heads varying fastest), else each head's in turn.
  int h, q0;
  if constexpr (Tl::HEADS_FIRST) {
    h = blockIdx.x % H;
    q0 = (gridDim.x / H - 1 - blockIdx.x / H) * BQ;
  } else {
    h = blockIdx.y;
    q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  }
  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BKV) * BKV;
    }
  }
  const int n_it = (kv_end - kv_begin + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * NC);   // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer warpgroup; one thread issues every copy.
    setmaxnreg_dec<Tl::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int b = 0; b < G::BOXES; ++b)
        tma_load_3d(sq + b * G::Q_BOX, &tq, q_full, b * G_BOX, h, q0);
      const int kvh = h / group;
      for (int it = 0; it < n_it; ++it) {
        const int s = stage(it);
        const uint32_t ph = use(it);
        const int k0 = kv_begin + it * BKV;
        mbar_wait(k_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(k_full + 8 * s, G::KV_BYTES);
        for (int b = 0; b < G::BOXES; ++b)
          tma_load_3d(sk + s * G::KV_BYTES + b * G::KV_BOX, &tk,
                      k_full + 8 * s, b * G_BOX, kvh, k0);
        mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, G::KV_BYTES);
        for (int b = 0; b < G::BOXES; ++b)
          tma_load_3d(sv + s * G::KV_BYTES + b * G::KV_BOX, &tv,
                      v_full + 8 * s, b * G_BOX, kvh, k0);
      }
    }
  } else {
    // A consumer warpgroup: query rows q0w.. (64 of them), the warp's 16
    // from 16 wq.
    setmaxnreg_inc<Tl::CONSUMER_REGS>();
    const int wq = warp & 3, cw = wg - 1;
    const int q0w = q0 + 64 * cw;
    // Descriptors of the warpgroup's Q rows, of K's and of V's stage 0;
    // a box, a 16-deep step and a stage are offsets added to them.
    const uint64_t dq = sw128_desc(sq + cw * 64 * G_BOX * (int)sizeof(T), 16,
                                   1024);
    const uint64_t dk = sw128_desc(sk, 16, 1024);
    const uint64_t dv = sw128_desc(sv, G::KV_BOX, 1024);
    float acc[1][DP / 8][4];
    zero(acc);
    float m[1][2] = {{kNegInf, kNegInf}}, l[1][2] = {{0.f, 0.f}};
    const float scale_log2 = scale * LOG2E;
    // S = Q K^T of the tile in stage st, over DP / 16 steps of depth 16: 4
    // a box, 32 bytes apart inside the swizzle atom (offsets in 16-byte
    // units). Issued only: the caller commits and waits.
    auto issue_s = [&](float (&s)[1][NJ][4], int st) {
      const uint64_t dks = dk + st * (G::KV_BYTES >> 4);
#pragma unroll
      for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T, NJ>(s[0], dq + ((b * G::Q_BOX + kk * 32) >> 4),
                          dks + ((b * G::KV_BOX + kk * 32) >> 4), b | kk);
    };
    // O += P V of the tile in stage st: V's rows are the depth (16 keys,
    // 2048 bytes a step), its boxes of 64 columns G::KV_BOX apart.
    auto issue_pv = [&](const uint32_t (&p)[BKV / 16][4], int st) {
      const uint64_t dvs = dv + st * (G::KV_BYTES >> 4);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<T, DP / 8>(acc[0], p[kk],
                            dvs + ((kk * 16 * G_BOX * (int)sizeof(T)) >> 4),
                            1);
    };
    // P (the probabilities in s) as A fragments, 16 keys a step.
    auto pack_p = [&](uint32_t (&p)[BKV / 16][4], const float (&s)[1][NJ][4]) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        p[kk][0] = pack16<T>(s[0][2 * kk][0], s[0][2 * kk][1]);
        p[kk][1] = pack16<T>(s[0][2 * kk][2], s[0][2 * kk][3]);
        p[kk][2] = pack16<T>(s[0][2 * kk + 1][0], s[0][2 * kk + 1][1]);
        p[kk][3] = pack16<T>(s[0][2 * kk + 1][2], s[0][2 * kk + 1][3]);
      }
    };
    auto rescale = [&](const float (&corr)[1][2]) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][n][e] *= corr[0][e >> 1];
    };
    mbar_wait(q_full, 0);
    if constexpr (!Tl::PIPELINED) {
      for (int it = 0; it < n_it; ++it) {
        const int st = stage(it);
        const uint32_t ph = use(it);
        const int k0 = kv_begin + it * BKV;
        // No row of the warpgroup may use any key of the tile: past the
        // causal diagonal, before the window, or rows past S.
        const bool skip =
            q0w >= S ||
            (causal && (k0 > q0w + 63 ||
                        (window > 0 && q0w - (k0 + BKV - 1) >= window)));
        mbar_wait(k_full + 8 * st, ph);
        float s[1][NJ][4];             // written whole by the first step
        if (!skip) {
          fence_regs(s[0]);
          wgmma_fence();
          issue_s(s, st);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s[0]);
        }
        if (lane == 0) mbar_arrive(k_empty + 8 * st);
        uint32_t p[BKV / 16][4];
        if (!skip) {
          float corr[1][2];
          softmax_step<64, BKV>(s, m, l, corr, q0w, k0, 16 * wq, lane, S,
                                causal, window, scale_log2);
          rescale(corr);
          pack_p(p, s);
        }
        mbar_wait(v_full + 8 * st, ph);
        if (!skip) {
          fence_regs(acc[0]);
          fence_regs(p);
          wgmma_fence();
          issue_pv(p, st);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc[0]);
          fence_regs(p);
        }
        if (lane == 0) mbar_arrive(v_empty + 8 * st);
      }
    } else {
      // The tiles some row of the warpgroup may use, [lo, hi): those from
      // the one holding its first row's earliest key (under a window) to
      // the one holding its last row (causal); none for rows past S. The
      // rest only pass their barriers on.
      int lo = 0, hi = n_it;
      if (q0w >= S) {
        hi = 0;
      } else if (causal) {
        hi = min(n_it, (q0w + 63 - kv_begin) / BKV + 1);
        if (window > 0) lo = max(0, (q0w - window + 1 - kv_begin) / BKV);
      }
      // The consumers issue their products in turn, warpgroup cw on named
      // barrier 1 + cw, handing on to the next; every one takes n_it + 1
      // turns (a tile each, and the last P V), the last consumer giving
      // the first its first turn.
      auto turn_begin = [&] { bar_sync(1 + cw, 256); };
      auto turn_end = [&] { bar_arrive(1 + (cw + 1) % NC, 256); };
      auto pass = [&](int it) {
        turn_begin();
        mbar_wait(k_full + 8 * stage(it), use(it));
        mbar_wait(v_full + 8 * stage(it), use(it));
        turn_end();
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * stage(it));
          mbar_arrive(v_empty + 8 * stage(it));
        }
      };
      if (cw == NC - 1) bar_arrive(1, 256);
      for (int it = 0; it < lo; ++it) pass(it);
      float s[1][NJ][4];               // written whole by the first step
      uint32_t p[BKV / 16][4];         // P of the last tile, as A fragments
      float corr[1][2];                // and its rescale of O
      if (lo < hi) {
        // The first tile: S alone.
        turn_begin();
        mbar_wait(k_full + 8 * stage(lo), use(lo));
        fence_regs(s[0]);
        wgmma_fence();
        issue_s(s, stage(lo));
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(s[0]);
        if (lane == 0) mbar_arrive(k_empty + 8 * stage(lo));
        softmax_step<64, BKV>(s, m, l, corr, q0w, kv_begin + lo * BKV,
                              16 * wq, lane, S, causal, window, scale_log2);
        pack_p(p, s);
      }
      // Tile j: S of tile j and P V of tile j - 1 (O rescaled first: O =
      // O corr + P V, in the instances' order), then the softmax of tile
      // j. MASKED: whether the tile has a masked entry, decided outside,
      // so that no branch sits between a product and its wait.
      auto step = [&](int j, auto masked) {
        const int st = stage(j), sp = stage(j - 1);
        const int k0 = kv_begin + j * BKV;
        turn_begin();
        mbar_wait(v_full + 8 * sp, use(j - 1));
        mbar_wait(k_full + 8 * st, use(j));
        rescale(corr);
        fence_regs(s[0]);
        fence_regs(acc[0]);
        fence_regs(p);
        wgmma_fence();
        issue_s(s, st);
        wgmma_commit();
        issue_pv(p, sp);
        wgmma_commit();
        turn_end();
        constexpr int MASKED = decltype(masked)::value;
        wgmma_wait<1>();
        fence_regs(s[0]);
        softmax_step<64, BKV, 1, NJ, MASKED>(s, m, l, corr, q0w, k0, 16 * wq,
                                             lane, S, causal, window,
                                             scale_log2);
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(p);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * st);
          mbar_arrive(v_empty + 8 * sp);
        }
        pack_p(p, s);
      };
      for (int j = lo + 1; j < hi; ++j) {
        const int k0 = kv_begin + j * BKV;
        const bool masked =
            k0 + BKV > S ||
            (causal && (k0 + BKV - 1 > q0w ||
                        (window > 0 && q0w + 63 - k0 >= window)));
        if (masked)
          step(j, std::integral_constant<int, 1>());
        else
          step(j, std::integral_constant<int, 0>());
      }
      if (lo < hi) {
        // P V of the last tile.
        const int sp = stage(hi - 1);
        turn_begin();
        mbar_wait(v_full + 8 * sp, use(hi - 1));
        rescale(corr);
        fence_regs(acc[0]);
        fence_regs(p);
        wgmma_fence();
        issue_pv(p, sp);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(p);
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
      } else {
        turn_begin();
        turn_end();
      }
      for (int it = hi; it < n_it; ++it) pass(it);
      // The last consumer's last hand-on goes to the first.
      if (cw == 0) bar_sync(1, 256);
    }

    // O = acc / l in q's type, two columns a 32-bit store; lse from the
    // quad's sum of l. A fully masked row has l = 0: it takes l = 1 and
    // the reference's masked max, -1e30. Every other row has l >= 1 (its
    // largest score gives p = 1), so O takes l's approximate reciprocal
    // (relative error 2^-22, far below the rounding to 16 bits): a
    // division's slow path is a subroutine call, which would keep ptxas
    // from giving the consumers their own register budget.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[0][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qi = q0w + 16 * wq + g + 8 * r;
      if (qi >= S) continue;
      const float li = lr == 0.f ? 1.f : lr;
      float inv;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(li));
      T* orow = o + ((long long)qi * H + h) * D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) = pack16<T>(
              acc[0][n][2 * r] * inv, acc[0][n][2 * r + 1] * inv);
      }
      if (t == 0)
        lse[(long long)h * S + qi] =
            lr == 0.f ? kNegInf : m[0][r] * LN2 + logf(li);
    }
  }
}

// Dynamic shared memory of one block: the Q tile and two K and two V
// tiles.
template <typename T, int DP>
constexpr int smem_bytes() {
  constexpr bool f32 = sizeof(T) == 4;
  return (int)((q_rows(f32, DP) + 4 * kv_rows(f32, DP)) *
               (DP + Pad<T>::value) * sizeof(T));
}

// Bits of `vec` for q, k and v: a tensor takes the 16-byte copy path when
// its pointer, row and head strides and head_dim are all whole 16-byte
// units.
template <typename T>
int vec_bits(const void* const* p, const Strides& st, int D) {
  constexpr long long V = 16 / sizeof(T);
  auto whole = [&](const void* ptr, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ss % V == 0 &&
           sh % V == 0 && D % V == 0;
  };
  return (whole(p[0], st.q_ss, st.q_sh) ? VEC_Q : 0) |
         (whole(p[1], st.k_ss, st.k_sh) ? VEC_K : 0) |
         (whole(p[2], st.v_ss, st.v_sh) ? VEC_V : 0);
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* const* p, int S, int H, int KVH, int D,
                       const Strides& st, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, DP>();
  constexpr int BQ = q_rows(sizeof(T) == 4, DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<T*>(const_cast<void*>(p[3])),
      static_cast<float*>(const_cast<void*>(p[4])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fwd_wide(const void* const* p, int S, int H, int KVH,
                            int D, const Strides& st, int causal, int window,
                            float scale, cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes<T, DP>();
  constexpr int BQ = Wide<T, DP>::BQ;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H);
  flash_fwd_wide_kernel<T, DP><<<grid, W_NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<T*>(const_cast<void*>(p[3])),
      static_cast<float*>(const_cast<void*>(p[4])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fwd_wgmma(const void* const* p, int S, int H, int KVH,
                             int D, const Strides& st, int causal,
                             int window, float scale, cudaStream_t stream) {
  using Tl = GTile<DP>;
  constexpr int smem = Gmma<T, DP>::SMEM;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tile_map<T>(&tq, p[0], D, H, S, st.q_ss, st.q_sh, Tl::BQ);
  if (err == cudaSuccess)
    err = tile_map<T>(&tk, p[1], D, KVH, S, st.k_ss, st.k_sh, Tl::BKV);
  if (err == cudaSuccess)
    err = tile_map<T>(&tv, p[2], D, KVH, S, st.v_ss, st.v_sh, Tl::BKV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + Tl::BQ - 1) / Tl::BQ;
  const dim3 grid = Tl::HEADS_FIRST ? dim3(tiles * H) : dim3(tiles, H);
  flash_fwd_wgmma_kernel<T, DP><<<grid, Tl::NT, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(const_cast<void*>(p[3])),
      static_cast<float*>(const_cast<void*>(p[4])), S, H, H / KVH, D, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_stream(const void* const* p, int S, int H, int KVH,
                              int D, const Strides& st, int causal,
                              int window, float scale, cudaStream_t stream) {
  constexpr int smem = stream_smem_bytes<T>();
  constexpr int DC = stream_chunk<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_stream_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_slices = (D + ST_COLS - 1) / ST_COLS;
  const dim3 grid((S + ST_ROWS - 1) / ST_ROWS * n_slices, H);
  flash_fwd_stream_kernel<T, DC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<T*>(const_cast<void*>(p[3])),
      static_cast<float*>(const_cast<void*>(p[4])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The forward's routes, by the codes flash_fwd_route gives them
// (flash_attention.FWD_ROUTES): the instances (head_dim padded to 16, 32,
// 64, 128 or 256), the wgmma route (bf16 and f16 at 33-256 whose q, k and
// v all take the 16-byte copy path, as TMA needs; head_dim padded to 64,
// 128 or 256), the wide route (257-576) and the streamed route beyond.
// f32 and head_dim 32 or less stay on the instances.
enum Route { R_INSTANCE = 0, R_WGMMA = 1, R_WIDE = 2, R_STREAM = 3 };

template <typename T>
Route route_for(int D, int vec) {
  return D > W_MAX_DP ? R_STREAM
       : D > 256      ? R_WIDE
       : sizeof(T) == 2 && D > 32 && vec == (VEC_Q | VEC_K | VEC_V)
           ? R_WGMMA
           : R_INSTANCE;
}

template <typename T>
Launcher fwd_for(int D, int vec) {
  if constexpr (sizeof(T) == 2)
    if (route_for<T>(D, vec) == R_WGMMA)
      return D <= 64    ? &launch_fwd_wgmma<T, 64>
           : D <= 128   ? &launch_fwd_wgmma<T, 128>
                        : &launch_fwd_wgmma<T, 256>;
  return D <= 16 ? &launch_fwd<T, 16>
       : D <= 32 ? &launch_fwd<T, 32>
       : D <= 64 ? &launch_fwd<T, 64>
       : D <= 128 ? &launch_fwd<T, 128>
       : D <= 256 ? &launch_fwd<T, 256>
       : D <= 512 ? &launch_fwd_wide<T, 512>
       : D <= W_MAX_DP ? &launch_fwd_wide<T, W_MAX_DP>
                       : &launch_fwd_stream<T>;
}

template <typename T>
int smem_for(int D, int vec) {
  if constexpr (sizeof(T) == 2)
    if (route_for<T>(D, vec) == R_WGMMA)
      return D <= 64    ? Gmma<T, 64>::SMEM
           : D <= 128   ? Gmma<T, 128>::SMEM
                        : Gmma<T, 256>::SMEM;
  return D <= 16 ? smem_bytes<T, 16>()
       : D <= 32 ? smem_bytes<T, 32>()
       : D <= 64 ? smem_bytes<T, 64>()
       : D <= 128 ? smem_bytes<T, 128>()
       : D <= 256 ? smem_bytes<T, 256>()
       : D <= 512 ? wide_smem_bytes<T, 512>()
       : D <= W_MAX_DP ? wide_smem_bytes<T, W_MAX_DP>()
                       : stream_smem_bytes<T>();
}

}  // namespace

extern "C" {

// q (S, H, D), k and v (S, KVH, D) with unit stride along D and the given
// row (ss) and head (sh) strides in elements; o (S, H, D) contiguous in
// q's type; lse (H, S) f32. dtype: 0 = f32, 1 = bf16, 2 = f16. Any
// head_dim D >= 1. window <= 0 means none. Returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a size, dtype or head
// count no instance takes).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int S, int H, int KVH, int D, long long q_ss,
              long long q_sh, long long k_ss, long long k_sh, long long v_ss,
              long long v_sh, int causal, int window, float scale, int dtype,
              void* stream) {
  if (S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, o, lse};
  const Strides st{q_ss, q_sh, k_ss, k_sh, v_ss, v_sh};
  const Launcher f =
      dtype == 0   ? fwd_for<float>(D, vec_bits<float>(p, st, D))
      : dtype == 1 ? fwd_for<bf16>(D, vec_bits<bf16>(p, st, D))
                   : fwd_for<f16>(D, vec_bits<f16>(p, st, D));
  return (int)f(p, S, H, KVH, D, st, causal, window, scale,
                static_cast<cudaStream_t>(stream));
}

// The route (R_INSTANCE 0, R_WGMMA 1, R_WIDE 2, R_STREAM 3) a launch takes at
// head_dim D and dtype, with `vec` the bits (1 q, 2 k, 4 v) of the
// tensors whose pointer, strides and head_dim are whole 16-byte units.
int flash_fwd_route(int D, int dtype, int vec) {
  return dtype == 0   ? route_for<float>(D, vec)
         : dtype == 1 ? route_for<bf16>(D, vec)
                      : route_for<f16>(D, vec);
}

// Bytes of dynamic shared memory a block of the template that (D, dtype,
// vec) takes.
int flash_fwd_smem_bytes(int D, int dtype, int vec) {
  return dtype == 0   ? smem_for<float>(D, vec)
         : dtype == 1 ? smem_for<bf16>(D, vec)
                      : smem_for<f16>(D, vec);
}

// The wgmma route's tiles at padded head_dim DP (64, 128 or 256): query
// rows a block into *rows and keys a KV tile into *keys. Returns 0, or
// cudaErrorInvalidValue for another DP.
int flash_fwd_wgmma_tiles(int DP, int* rows, int* keys) {
  if (DP == 64) {
    *rows = GTile<64>::BQ, *keys = GTile<64>::BKV;
  } else if (DP == 128) {
    *rows = GTile<128>::BQ, *keys = GTile<128>::BKV;
  } else if (DP == 256) {
    *rows = GTile<256>::BQ, *keys = GTile<256>::BKV;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
