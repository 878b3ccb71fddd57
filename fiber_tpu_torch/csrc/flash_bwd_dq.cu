// Flash-attention backward, dq, for Hopper (sm_90a) on the tensor cores:
// plain CUDA C++ with a C interface, loaded with ctypes by
// fiber_tpu_torch/ops/flash_attention.py. Its partner, dk and dv, is
// flash_bwd_dkv.cu.
//
// Replaces fiber_tpu/ops/pallas_attention.py:_bwd_dq_kernel. From the
// forward's saved (q, k, v, lse) and delta = rowsum(dO * O) - dlse:
//
//   p_ij  = exp(s_ij * scale - lse_i)          (masked entries 0)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j, over the KV tiles a query tile sees,
//
// recomputing p and ds as _bwd_p_ds does, with _run_window's block skip
// as loop bounds and _keep_mask's elementwise mask (plus the ragged edge).
//
// What bounds it on this card: three S x S x D products (halved by
// causality) for O(S D) bytes, so operations. bf16 and f16 inputs run them
// at the 16-bit tensor-core rate (989 TFLOP/s dense), with f32 sums, lse,
// delta and dS before its packing; f32 inputs run each product
// as three TF32 products (3xTF32, mma_sm90.cuh), at 165 TFLOP/s, against
// the 67 TFLOP/s of f32 FMA on the CUDA cores that the previous version
// of this kernel used. An emulation of this kernel's f32 arithmetic on
// the CPU (S = 2048, D = 32, against an f64 recomputation;
// tests/test_torch_flash_backward.py keeps it) puts one TF32 product per
// f32 product above the 5e-5 parity bound of dq and 3xTF32 far below it.
//
// Design (FlashAttention-2's dq pass, warp-level mma.sync, on the tile
// products that dk/dv uses, abt and add_xb of mma_sm90.cuh):
//
// - Up to head_dim 128 one block of 4 warps owns one (query head, query
//   tile); each warp owns MT 16-row m-tiles (m_tiles(), below), so that
//   every K and V fragment it loads (and, for f32, splits) feeds MT
//   products. The TPU
//   kernel carries dq in VMEM scratch across a sequential KV grid axis;
//   here that axis is a loop inside the block, over _run_window's tiles,
//   and dq stays in registers. A block owns its output, so there are no
//   atomics and dq repeats bit for bit. The tiles of the last query rows,
//   which see the most keys under causality, are scheduled first.
// - Q and dO of the tile are staged in shared memory once and read from
//   there at each use, as dk/dv reads its K and V, which leaves the
//   registers to the two score tiles; lse (times log2 e, for ex2) and
//   delta of the warp's rows sit in registers. 64-row K and V tiles are
//   double-buffered by cp.async (16 bytes a thread): the next tile's copy
//   runs while the current one computes, one wait and one barrier a
//   tile. A tensor whose pointer, strides or head_dim are not whole
//   16-byte units takes a scalar load path instead (per tensor, chosen
//   by the launcher).
// - bf16 and f16 at head_dim 33-256 whose q, k, v and dO are whole
//   16-byte units take the wgmma route instead
//   (flash_bwd_dq_wgmma_kernel<type, 64, 128 or 256>, head_dim padded to
//   64, 128 or 256; wgmma_sm90.cuh), Hopper's warpgroup products fed by
//   the Tensor Memory Accelerator: the 64, 128 and 256 instances above
//   run warp-level mma.sync with ldmatrix and cp.async, each warp reading
//   the whole K and V tiles for its 16 rows, at a quarter of their bound
//   (the 256 instance at 22%). One block
//   of three warpgroups owns 128 query rows of one head. A producer
//   warpgroup (its registers given back by setmaxnreg) has one thread
//   issue the TMA copies in the 128-byte swizzle, a 64-column box at a
//   time (two a row at 128): Q and dO once, then each KV tile's K and V
//   into a ring of two stages, each copy completing on a full mbarrier
//   and each stage handed back by an empty one (V once dP is computed, K
//   after dS K). Two consumer warpgroups own 64 query rows each: S = Q
//   K^T and dP = dO V^T by wgmma with both operands in shared memory (one
//   commit group, one wait; at 128 the depth runs over both boxes), P and
//   dS in the accumulators' registers, dS packed there to the input's
//   type as the A fragments of dQ += dS K (m64n64k16 at 64, m64n128k16 at
//   128, K read MN-major: its rows are the depth, its two boxes the
//   descriptor's leading offset apart). GTile<DP> gives each width's
//   tiles and registers: 128-key tiles at 64; at 128, where dQ is 64
//   accumulator registers a thread, 64-key tiles and budgets of 24 / 240,
//   and every head's heaviest causal tiles launched first (a 1-D grid,
//   the heads varying fastest); at 256, where dQ is 128 registers a
//   thread and Q and dO of 128 rows alone take 128 KB, 32-key tiles
//   (m64n32k16 score products, dQ += dS K by m64n256k16) in three
//   stages, 230,504 bytes. As in the instance, the block owns its
//   output, with no atomics, and each score product is computed once a
//   (query tile, KV tile). The wgmma route of flash_fwd.cu says what
//   keeps ptxas from serializing the products (no trap block, roles
//   branched on a warp-uniform index, no subroutine call in a consumer,
//   no branch between a product and its wait).
// - f32 at head_dim 129-256, and bf16 and f16 there whose tensors are not
//   whole 16-byte units, pad to one 256 instance
//   (flash_bwd_dq_split_kernel), where dq over 256 columns would be 128
//   accumulator registers a thread beside both score tiles, which left room
//   for one block of 4 warps an SM. One block of 8 warps owns the (query
//   head, 64-row query tile), in two groups of 4 warps, 16 query rows a
//   warp in each group. Group A computes S = Q K^T over the full depth and
//   P, and stores P (f32) to shared memory; group B computes dP = dO V^T
//   over the full depth, reads A's P to form dS = P (dP - delta), and
//   stores dS (packed to a 16-bit input's type, f32 for f32) to shared
//   memory, each exchange a named barrier over the block's 256 threads (the
//   producing group arrives, the other waits). Then each group adds dS K
//   into its 128 of dq's columns (64 accumulator registers a thread): group
//   B from its own registers, group A from the shared dS, which holds the
//   same packed bits. So each score product is computed once a (query tile,
//   KV tile), 3 products of 64 x BKV x 256, and an SM runs 8 warps (beside
//   both score tiles, a 256-column accumulator leaves room for 4). K and V
//   tiles are 64 rows in a 16-bit type (two buffers: 230 KB of shared
//   memory; 32-row tiles ran 18% slower on an H100) and 32 in f32,
//   single-buffered (the next tile's copy after a barrier at the end of
//   this one), since the f32 Q and dO tiles alone take 133 KB.
// - head_dim 257-1024 takes the wide route (flash_bwd_dq_wide_kernel): a
//   dq accumulator of 512 columns would be 256 registers a thread, and
//   full-width tiles do not fit. A thread-block cluster of n = ceil(D /
//   128) blocks (3 to 8, the portable limit) owns one (query head, 64-row
//   query tile), and block r owns dq's columns [128 r, 128 r + 128), the
//   128 instance's accumulator. Block r holds the same 128 columns of the
//   operands: Q and dO staged once, K and V of each 32-row KV tile in two
//   cp.async stages of a whole slice (one wait a tile). Per KV tile it
//   computes S and dP over its 128 columns of depth only, and the
//   cluster sums those partials into dS through distributed shared
//   memory (cluster_sm90.cuh: block r finishes rows [r own, r own + own)
//   of the tile, own = ceil(64 / n); every block stores its partial rows
//   into their owner, which sums the n partials in rank order and stores
//   the finished dS rows into every block), then adds dS K to its slice.
//   Each score product is thus computed once: at head_dim 512, 3
//   products of one pass (1 + 1 + 1), where the streamed kernel below
//   computed 9 (4 + 4 + 1). Each dS entry is finished by one block, so
//   every slice uses the same bits and dq repeats bit for bit. The price
//   is two cluster barriers a KV tile and the f32 partials crossing the
//   cluster (8 bytes an entry from each block but its owner). A block
//   takes 97,328 bytes of shared memory for a 16-bit type (two blocks of
//   4 warps an SM) and 167,984 for f32 (one block of 8 warps, which
//   split S and dP, then dq's two 64-column halves, between them).
// - head_dim above 1024 (more than 8 blocks a cluster) takes the streamed
//   kernel (flash_bwd_dq_stream_kernel): one block per 128-column slice
//   of dq, each computing S and dP again over the full depth, streamed
//   through shared memory in chunks of 256 bytes a row of Q, dO, K and V,
//   two buffers whatever head_dim (104,448 bytes a block), so that any
//   head_dim reaches a kernel. Every slice runs the same instructions on
//   the same scores, so P and dS agree bit for bit across slices there
//   too.
// - Per KV tile a warp computes S = Q K^T and dP = dO V^T (16 x 64 an
//   m-tile each) as mma accumulators, P = 2^(S scale log2 e - lse log2 e)
//   and dS = P (dP - delta) in registers (the mask only on tiles that
//   need it), then dQ += dS K with dS as the A operand straight from its
//   accumulator registers and K read as the B operand (ldmatrix .trans
//   for 16-bit types, a permuted depth index for f32). dS is packed to
//   the input's 16-bit type before its scale is applied (to dq, in f32).
//   Since O_i is a convex combination of the v_j, |dS_ij| <= |dO_i . v_j|
//   + |delta_i| <= 2 |dO_i| max_j |v_j| + |dlse_i|, which chip_smoke.py
//   holds under f16's largest value, 65504, for its f16 inputs. On f32
//   each tile's dS K is summed from zero and then added to dq with
//   rounded adds: the tensor cores' own f32 sums round toward zero.
// - Operands stay in their own type in shared memory: 16-bit rows padded
//   to D + 8 elements and read with ldmatrix, f32 rows padded to D + 4 and
//   read with 32-bit loads, split into big and small at each use. Both
//   paddings make the fragment reads free of bank conflicts.
//
// q, k, v and dO are read through their (S, heads, head_dim) strides; dq
// is written contiguous, (S, H, D), in q's type.

#include "cluster_sm90.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int WARPS = 4;           // warps per block
constexpr int NT = 32 * WARPS;     // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// Key/value rows per tile up to head_dim 128 (two buffers of each).
constexpr int BKV_MAX = 64;

// The 256 instance (head_dim 129-256): threads of a block (two groups of
// 4 warps), and the rows and buffers of its K and V tiles (64 rows and
// two buffers in a 16-bit type, 32 rows and one in f32).
constexpr int SPLIT_NT = 2 * NT;
template <typename T>
__host__ __device__ constexpr int split_kv_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}
template <typename T>
__host__ __device__ constexpr int split_kv_bufs() {
  return sizeof(T) == 2 ? 2 : 1;
}

// The wide and streamed routes (head_dim above 256): output columns a
// block, and rows of its query tile.
constexpr int W_COLS = 128;
constexpr int W_ROWS = 64;
static_assert(W_ROWS == X_ROWS, "the cluster exchanges the query tile");

// The wide route (head_dim 257-1024): rows of each KV tile (32, so that
// Q, dO and two stages of K and V of a 16-bit type fit twice in an SM),
// and blocks an SM the registers must allow (two for a 16-bit type, one
// for f32, whose tiles take 159 KB).
constexpr int W_KVROWS = 32;
template <typename T>
__host__ __device__ constexpr int wide_min_blocks() {
  return sizeof(T) == 2 ? 2 : 1;
}

// Threads of a wide-route block: 4 warps, each computing both score tiles
// and all 128 output columns of its 16 rows, for a 16-bit type; 8 for
// f32 (one block an SM), warps 0-3 computing S and warps 4-7 dP, then
// each pair of warps sharing a 16-row m-tile and adding dS K to one
// 64-column half of the slice.
template <typename T>
__host__ __device__ constexpr int wide_threads() {
  return sizeof(T) == 2 ? NT : 2 * NT;
}

// Dynamic shared memory of one block of the wide route, whatever head_dim
// up to 1024: Q and dO, two stages of K and V (128 columns each), the
// receive buffers of the partial S and dP (f32), the tile's dS, and the
// lse and delta of the block's own rows.
template <typename T>
__host__ __device__ constexpr int wide_smem_bytes() {
  constexpr int LX = W_KVROWS + X_PAD;
  return (int)((2 * W_ROWS + 4 * W_KVROWS) * (W_COLS + Pad<T>::value) *
                   sizeof(T) +
               2 * recv_rows() * LX * sizeof(float) +
               X_ROWS * LX * sizeof(T) + 2 * X_OWN_MAX * sizeof(float));
}

// The streamed route (head_dim above 1024): rows of each KV tile (32, as
// at head_dim 256, so that the two score tiles fit beside dq's 128-column
// accumulator).
constexpr int ST_KVROWS = 32;

// Depth of one chunk of the streamed route's score products: 256 bytes
// of a row (64 f32, 128 of a 16-bit type): half as many stages, and so
// barriers, as 128-byte chunks, which ran slower on an H100.
template <typename T>
__host__ __device__ constexpr int stream_chunk() {
  return 256 / (int)sizeof(T);
}

// Elements of one of the streamed route's two stage buffers: a chunk of
// Q, dO, K and V, or a K slice, whichever is larger.
template <typename T>
__host__ __device__ constexpr int stream_buf() {
  constexpr int chunk =
      2 * (W_ROWS + ST_KVROWS) * (stream_chunk<T>() + Pad<T>::value);
  constexpr int slice = ST_KVROWS * (W_COLS + Pad<T>::value);
  return chunk > slice ? chunk : slice;
}

// Dynamic shared memory of one block of the streamed route, whatever
// head_dim.
template <typename T>
constexpr int stream_smem_bytes() {
  return (int)(2 * stream_buf<T>() * sizeof(T));
}

struct Strides {                   // row (ss) and head (sh) strides, elements
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, do_ss, do_sh;
};

// Bits of `vec`: the 16-byte copy path may be used for q, k, v, dO.
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_DO = 8;

// 16-row m-tiles per warp: two where ptxas then spills nothing (f32 to
// head_dim 16, bf16 to 32), else one. Two m-tiles hold two 16 x 64 score
// tiles (S and dP) each beside dq: at f32 head_dim 32 and bf16 64 that
// spilled (so did an f32 fold of two accumulator tiles a pass), and
// 32-row KV tiles, which did not spill, were no faster than one m-tile.
__host__ __device__ constexpr int m_tiles(bool f32, int dp) {
  return (f32 ? dp <= 16 : dp <= 32) ? 2 : 1;
}

// Query rows per block.
__host__ __device__ constexpr int q_rows(bool f32, int dp) {
  return 16 * WARPS * m_tiles(f32, dp);
}

// Dynamic shared memory of one block up to head_dim 128: the Q and dO
// tiles and two K and two V tiles.
template <typename T, int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (int)((2 * q_rows(sizeof(T) == 4, DP) + 4 * BKV_MAX) *
               (DP + Pad<T>::value) * sizeof(T));
}

// Dynamic shared memory of one block of the 256 instance: the Q and dO
// tiles, the K and V buffers, P (f32) and dS (in T).
template <typename T, int DP>
__host__ __device__ constexpr int split_smem_bytes() {
  constexpr int BKV = split_kv_rows<T>();
  constexpr int LX = BKV + X_PAD;
  return (int)((2 * 16 * WARPS + 2 * split_kv_bufs<T>() * BKV) *
                   (DP + Pad<T>::value) * sizeof(T) +
               16 * WARPS * LX * (sizeof(float) + sizeof(T)));
}

// Blocks per SM the compiler must leave registers for: as many as the
// shared memory lets in (228 KB an SM, 1 KB of it reserved per block),
// at most 3 (170 registers a thread) for bf16 with one m-tile a warp,
// else at most 2 (255): f32 at head_dim 32 ran faster with 2 blocks and
// room for more registers, bf16 at head_dim 64 with 3.
template <typename T, int DP>
__host__ __device__ constexpr int min_blocks() {
  const int fit = 233472 / (smem_bytes<T, DP>() + 1024);
  const int most = sizeof(T) == 2 && m_tiles(false, DP) == 1 ? 3 : 2;
  return fit < 1 ? 1 : fit > most ? most : fit;
}

// The streamed route's tile arithmetic (the instances up to 256 keep the
// same arithmetic inline: folding them onto these helpers changed their
// register allocation and made one of them spill).

// Whether any entry of key tile k0 against query tile q0 is masked
// (diagonal, window edge or ragged keys); the same for the whole block,
// so no warp diverges.
template <int BQ, int BKV>
__device__ __forceinline__ bool tile_masked(int q0, int k0, int S,
                                            int causal, int window) {
  bool masked = k0 + BKV > S;
  if (causal)
    masked = masked || k0 + BKV - 1 > q0 ||
             (window > 0 && q0 + BQ - 1 - k0 >= window);
  return masked;
}

// P = 2^(S scale log2 e - lse log2 e) in place of the warp's raw scores p
// (key tile k0 of the block's query tile q0), masked entries 0; the mask
// only where tile_masked() says the tile needs it.
template <int MT, int NJ>
__device__ __forceinline__ void to_p(float (&p)[MT][NJ][4],
                                     const float (&lse2)[MT][2],
                                     bool masked, int q0, int k0, int wrow,
                                     int lane, int S, int causal, int window,
                                     float scale_log2) {
  const int g = lane >> 2, t = lane & 3;
  if (masked) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + wrow + mt * 16 + g + (e >> 1) * 8;
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          p[mt][j][e] = keep(qi, kj, S, causal, window)
                            ? ex2(fmaf(p[mt][j][e], scale_log2,
                                       -lse2[mt][e >> 1]))
                            : 0.f;
        }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[mt][j][e] =
              ex2(fmaf(p[mt][j][e], scale_log2, -lse2[mt][e >> 1]));
  }
}

// dS = P o (dP - delta) in place of the warp's dP = dO V^T.
template <int MT, int NJ>
__device__ __forceinline__ void to_ds(float (&ds)[MT][NJ][4],
                                      const float (&p)[MT][NJ][4],
                                      const float (&dlt)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[mt][j][e] = p[mt][j][e] * (ds[mt][j][e] - dlt[mt][e >> 1]);
}

// Writes the warp's rows of dq, columns col0 + 8 ND of them (those below
// D), as scale * acc.
template <typename T, int MT, int ND>
__device__ __forceinline__ void store_dq(const float (&acc)[MT][ND][4],
                                         T* dq, int q0, int wrow, int lane,
                                         int S, int H, int h, int D,
                                         int col0, float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wrow + mt * 16 + g + 8 * r;
      if (qi >= S) continue;
      T* row = dq + ((long long)qi * H + h) * D + col0;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + 2 * t + c;
          if (col0 + col < D) store(row + col, acc[mt][n][2 * r + c] * scale);
        }
    }
}

// The instances up to head_dim 128 (the file's header says why).
template <typename T, int DP>
__global__ void __launch_bounds__(NT, (min_blocks<T, DP>()))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int group, int D, Strides st, int vec,
                    int causal, int window, float scale) {
  static_assert(DP <= 128, "head_dim 129-256 is the split kernel's");
  constexpr int MT = m_tiles(sizeof(T) == 4, DP);
  constexpr int BQ = q_rows(sizeof(T) == 4, DP);
  constexpr int BKV = BKV_MAX;
  constexpr int NB = 2;             // K and V buffers
  constexpr int NJ = BKV / 8;       // 8-column score tiles per warp
  constexpr int ND = DP / 8;        // 8-column accumulator tiles
  constexpr int LD = DP + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);     // BQ x LD
  T* sdo = sq + BQ * LD;                      // BQ x LD
  T* sk = sdo + BQ * LD;                      // NB buffers of BKV x LD
  T* sv = sk + NB * BKV * LD;                 // NB buffers of BKV x LD

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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

  // Stages KV tile `it` into buffer it % NB.
  auto stage = [&](int it) {
    const int k0 = kv_begin + it * BKV;
    const int b = it % NB;
    load_tile<T, DP, BKV, NT>(sk + b * BKV * LD, k + kvh * st.k_sh, k0, S,
                              D, st.k_ss, vec & VEC_K);
    load_tile<T, DP, BKV, NT>(sv + b * BKV * LD, v + kvh * st.v_sh, k0, S,
                              D, st.v_ss, vec & VEC_V);
  };

  load_tile<T, DP, BQ, NT>(sq, q + h * st.q_sh, q0, S, D, st.q_ss,
                           vec & VEC_Q);
  load_tile<T, DP, BQ, NT>(sdo, dout + h * st.do_sh, q0, S, D, st.do_ss,
                           vec & VEC_DO);
  if (n_it > 0) stage(0);
  cp_async_commit();

  // lse (base 2) and delta of rows g and g + 8 of each m-tile. Rows past
  // S take 0: their Q and dO rows are zeros, so their dS is 0 where the
  // tile is not masked, and they are never written.
  float lse2[MT][2], dlt[MT][2];
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wrow + mt * 16 + g + 8 * r;
      lse2[mt][r] = qi < S ? lse[(long long)h * S + qi] * LOG2E : 0.f;
      dlt[mt][r] = qi < S ? delta[(long long)h * S + qi] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1, whose
    // buffers the copy of tile it + 1 now overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();

    const int k0 = kv_begin + it * BKV;
    const T* ck = sk + (it % NB) * BKV * LD;
    const T* cv = sv + (it % NB) * BKV * LD;
    // Whether any entry of this tile is masked (diagonal, window edge or
    // ragged keys); the same for the whole block, so no warp diverges.
    bool masked = k0 + BKV > S;
    if (causal)
      masked = masked || k0 + BKV - 1 > q0 ||
               (window > 0 && q0 + BQ - 1 - k0 >= window);

    // P = 2^(S scale log2 e - lse log2 e), masked entries 0.
    float p[MT][NJ][4];
    abt<DP, MT, NJ>(p, sq, ck, wrow, lane);
    if (masked) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + wrow + mt * 16 + g + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            p[mt][j][e] = keep(qi, kj, S, causal, window)
                              ? ex2(fmaf(p[mt][j][e], scale_log2,
                                         -lse2[mt][e >> 1]))
                              : 0.f;
          }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[mt][j][e] =
                ex2(fmaf(p[mt][j][e], scale_log2, -lse2[mt][e >> 1]));
    }

    // dS = P o (dP - delta), dP = dO V^T; then dQ += dS K.
    float ds[MT][NJ][4];
    abt<DP, MT, NJ>(ds, sdo, cv, wrow, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[mt][j][e] = p[mt][j][e] * (ds[mt][j][e] - dlt[mt][e >> 1]);
    add_xb<DP, MT, NJ>(acc, ds, ck, lane);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wrow + mt * 16 + g + 8 * r;
      if (qi >= S) continue;
      T* row = dq + ((long long)qi * H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + 2 * t + c;
          if (col < D) store(row + col, acc[mt][n][2 * r + c] * scale);
        }
    }
}

// The 256 instance (head_dim 129-256; the file's header says why): one
// block of 8 warps owns one (query head, 64-row query tile); warps 0-3
// (group A) compute S and P, warps 4-7 (group B) dP and dS, 16 query rows
// a warp in each group, and each group adds dS K into one 128-column half
// of dq.
template <typename T, int DP>
__global__ void __launch_bounds__(SPLIT_NT, 1)
flash_bwd_dq_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int S, int H, int group,
                          int D, Strides st, int vec, int causal,
                          int window, float scale) {
  constexpr int BQ = 16 * WARPS;
  constexpr int BKV = split_kv_rows<T>();
  constexpr int NB = split_kv_bufs<T>();
  constexpr int NJ = BKV / 8;       // 8-column score tiles per warp
  constexpr int DN = DP / 2;        // dq's columns a group
  constexpr int LD = DP + Pad<T>::value;
  constexpr int LX = BKV + X_PAD;   // row stride of P and dS
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);     // BQ x LD
  T* sdo = sq + BQ * LD;                      // BQ x LD
  T* sk = sdo + BQ * LD;                      // NB buffers of BKV x LD
  T* sv = sk + NB * BKV * LD;                 // NB buffers of BKV x LD
  float* fp = reinterpret_cast<float*>(sv + NB * BKV * LD);   // BQ x LX
  T* fds = reinterpret_cast<T*>(fp + BQ * LX);                // BQ x LX

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp % WARPS) * 16;       // the warp's first row
  const bool is_b = warp >= WARPS;            // dP and dS
  const int wcol = is_b ? DN : 0;             // the group's first column
  const int h = blockIdx.y;
  const int kvh = h / group;
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
  const int n_it = (kv_end - kv_begin + BKV - 1) / BKV;   // at least 1

  // Stages KV tile `it` into buffer it % NB.
  auto stage = [&](int it) {
    const int k0 = kv_begin + it * BKV;
    const int b = it % NB;
    load_tile<T, DP, BKV, SPLIT_NT>(sk + b * BKV * LD, k + kvh * st.k_sh,
                                    k0, S, D, st.k_ss, vec & VEC_K);
    load_tile<T, DP, BKV, SPLIT_NT>(sv + b * BKV * LD, v + kvh * st.v_sh,
                                    k0, S, D, st.v_ss, vec & VEC_V);
  };

  load_tile<T, DP, BQ, SPLIT_NT>(sq, q + h * st.q_sh, q0, S, D, st.q_ss,
                                 vec & VEC_Q);
  load_tile<T, DP, BQ, SPLIT_NT>(sdo, dout + h * st.do_sh, q0, S, D,
                                 st.do_ss, vec & VEC_DO);
  stage(0);
  cp_async_commit();

  // lse (base 2) and delta of the warp's rows g and g + 8 (0 past S, as
  // in the instances up to 128).
  float lse2[1][2], dlt[1][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wrow + g + 8 * r;
    lse2[0][r] = qi < S ? lse[(long long)h * S + qi] * LOG2E : 0.f;
    dlt[0][r] = qi < S ? delta[(long long)h * S + qi] : 0.f;
  }
  float acc[1][DN / 8][4];
  zero(acc);
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1: its
    // K and V (which, with two buffers, the copy of tile it + 1 now
    // overwrites), its P and its dS.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (NB == 2) {
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
    }
    const int k0 = kv_begin + it * BKV;
    const T* ck = sk + (it % NB) * BKV * LD;
    const T* cv = sv + (it % NB) * BKV * LD;

    // S = Q K^T (group A) or dP = dO V^T (group B), full depth.
    float x[1][NJ][4];
    abt<DP, 1, NJ>(x, is_b ? sdo : sq, is_b ? cv : ck, wrow, lane);
    if (!is_b) {
      // P = 2^(S scale log2 e - lse log2 e), masked entries 0, to group
      // B; then group B's dS.
      to_p(x, lse2, tile_masked<BQ, BKV>(q0, k0, S, causal, window), q0,
           k0, wrow, lane, S, causal, window, scale_log2);
      scatter_rows(fp, x, wrow, lane);
      bar_arrive(1, SPLIT_NT);
      bar_sync(2, SPLIT_NT);
      gather_rows(x, fds, wrow, lane);
    } else {
      // dS = P o (dP - delta), once group A's P is in, to group A.
      bar_sync(1, SPLIT_NT);
      float p[1][NJ][4];
      gather_rows(p, fp, wrow, lane);
      to_ds(x, p, dlt);
      scatter_rows(fds, x, wrow, lane);
      bar_arrive(2, SPLIT_NT);
    }
    // dQ += dS K over the group's columns.
    add_xb<DP, 1, NJ, DN>(acc, x, ck + wcol, lane);
    if constexpr (NB == 1) {
      __syncthreads();              // every warp is done with the buffers
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
    }
  }
  store_dq(acc, dq, q0, wrow, lane, S, H, h, D, wcol, scale);
}

// The streamed route's kernel (head_dim above 1024; the file's header
// says why): one block of 4 warps owns one 128-column slice of dq for one
// (query head, 64-row query tile), one 16-row m-tile a warp. Per 32-row
// KV tile it streams the depth of S = Q K^T and dP = dO V^T through
// shared memory, DC columns of Q, dO, K and V at a time, then stages the
// tile's K slice and adds dS K to its 128-column accumulator, the 128
// instance's.
// Every stage (a chunk of the four, or a K slice) goes into one of two
// buffers by cp.async while the other one computes.
template <typename T, int DC>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_stream_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int S, int H, int group,
                           int D, Strides st, int vec, int causal,
                           int window, float scale) {
  constexpr int BQ = W_ROWS, BKV = ST_KVROWS;
  constexpr int NJ = BKV / 8;           // 8-column score tiles
  constexpr int ND = W_COLS / 8;        // 8-column accumulator tiles
  constexpr int LDC = DC + Pad<T>::value;   // row stride of a chunk tile
  constexpr int BUF = stream_buf<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbuf = reinterpret_cast<T*>(smem_raw);   // 2 stage buffers of BUF

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int wrow = (threadIdx.x >> 5) * 16;   // the warp's first row
  const int h = blockIdx.y;
  const int kvh = h / group;
  // The slices of one query tile are neighbours in the grid; the heaviest
  // causal tiles (the last query rows) are scheduled first.
  const int n_slices = (D + W_COLS - 1) / W_COLS;
  const int col0 = (blockIdx.x % n_slices) * W_COLS;
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
  const int per_tile = n_chunks + 1;    // stages a KV tile: chunks, then K
  const int n_st = n_it * per_tile;

  // Stages `u` into buffer u & 1: chunk c of Q, dO, K and V (BQ, BQ, BKV
  // and BKV rows, LDC apart), or the K slice (BKV rows, W_COLS + pad
  // apart).
  auto stage = [&](int u) {
    const int k0 = kv_begin + (u / per_tile) * BKV;
    const int c = u % per_tile;
    T* b = sbuf + (u & 1) * BUF;
    if (c < n_chunks) {
      const int c0 = c * DC;
      load_tile<T, DC, BQ, NT>(b, q + h * st.q_sh + c0, q0, S, D - c0,
                               st.q_ss, vec & VEC_Q);
      load_tile<T, DC, BQ, NT>(b + BQ * LDC, dout + h * st.do_sh + c0, q0,
                               S, D - c0, st.do_ss, vec & VEC_DO);
      load_tile<T, DC, BKV, NT>(b + 2 * BQ * LDC, k + kvh * st.k_sh + c0,
                                k0, S, D - c0, st.k_ss, vec & VEC_K);
      load_tile<T, DC, BKV, NT>(b + (2 * BQ + BKV) * LDC,
                                v + kvh * st.v_sh + c0, k0, S, D - c0,
                                st.v_ss, vec & VEC_V);
    } else {
      load_tile<T, W_COLS, BKV, NT>(b, k + kvh * st.k_sh + col0, k0, S,
                                    D - col0, st.k_ss, vec & VEC_K);
    }
  };

  if (n_st > 0) stage(0);
  cp_async_commit();

  // lse (base 2) and delta of rows g and g + 8 (0 past S, as above).
  float lse2[1][2], dlt[1][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wrow + g + 8 * r;
    lse2[0][r] = qi < S ? lse[(long long)h * S + qi] * LOG2E : 0.f;
    dlt[0][r] = qi < S ? delta[(long long)h * S + qi] : 0.f;
  }
  float acc[1][ND][4];
  zero(acc);
  float p[1][NJ][4], ds[1][NJ][4];
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
      if (c == 0) {
        zero(p);
        zero(ds);
      }
      abt<DC, 1, NJ, true>(p, b, b + 2 * BQ * LDC, wrow, lane);
      abt<DC, 1, NJ, true>(ds, b + BQ * LDC, b + (2 * BQ + BKV) * LDC,
                           wrow, lane);
    } else {
      const int k0 = kv_begin + (u / per_tile) * BKV;
      to_p(p, lse2, tile_masked<BQ, BKV>(q0, k0, S, causal, window), q0,
           k0, wrow, lane, S, causal, window, scale_log2);
      to_ds(ds, p, dlt);
      add_xb<W_COLS, 1, NJ>(acc, ds, b, lane);
    }
  }
  store_dq(acc, dq, q0, wrow, lane, S, H, h, D, col0, scale);
}

// The wide route's kernel (head_dim 257-1024; the file's header says
// why): a cluster of n = ceil(D / 128) blocks of 4 warps owns one (query
// head, 64-row query tile), one 16-row m-tile a warp; block r (its rank
// in the cluster) owns dq's columns [128 r, 128 r + 128) and holds those
// columns of Q and dO (staged once) and of each KV tile's K and V (two
// cp.async stages). Per KV tile: the partial S and dP over the block's
// 128 columns of depth, the cluster's sum of them into dS
// (cluster_sm90.cuh), then dQ += dS K on the block's slice.
template <typename T, int BKV>
__global__ void
__launch_bounds__((wide_threads<T>()), (wide_min_blocks<T>()))
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int S, int H, int group, int D, Strides st, int vec,
                         int causal, int window, float scale) {
  constexpr int NTB = wide_threads<T>();
  constexpr bool SPLIT = NTB > NT;      // the f32 warps split the work
  constexpr int BQ = W_ROWS;
  constexpr int NJ = BKV / 8;           // 8-column score tiles
  constexpr int DN = SPLIT ? W_COLS / 2 : W_COLS;   // a warp's columns
  constexpr int LD = W_COLS + Pad<T>::value;
  constexpr int LX = BKV + X_PAD;       // row stride of the tile buffers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);        // BQ x LD
  T* sdo = sq + BQ * LD;                         // BQ x LD
  T* skv = sdo + BQ * LD;                        // 2 x (K, V), BKV x LD
  // receive buffers of the partial S and dP, recv_rows() x LX each
  float* xs = reinterpret_cast<float*>(skv + 4 * BKV * LD);
  float* xdp = xs + recv_rows() * LX;
  T* fds = reinterpret_cast<T*>(xdp + recv_rows() * LX);   // BQ x LX
  float* olse = reinterpret_cast<float*>(fds + BQ * LX);
  float* odlt = olse + X_OWN_MAX;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp % WARPS) * 16;       // the warp's first row
  // The warp's share: m = 0 is S, m = 1 dP (a 16-bit warp takes both),
  // and its first output column in the slice.
  const int m_first = SPLIT ? warp / WARPS : 0;
  const int m_end = SPLIT ? m_first + 1 : 2;
  const int wcol = SPLIT ? warp / WARPS * DN : 0;
  const int h = blockIdx.y;
  const int kvh = h / group;
  const int n = (D + W_COLS - 1) / W_COLS;    // blocks of the cluster
  const int rank = cluster_rank();
  const int col0 = rank * W_COLS;
  // The heaviest causal tiles (the last query rows) are scheduled first.
  const int q0 = (gridDim.x / n - 1 - blockIdx.x / n) * BQ;
  // The tile rows whose P and dS this block finishes.
  const int own = own_rows(n);
  const int row0 = rank * own;
  const int n_own = max(0, min(own, BQ - row0));

  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BKV) * BKV;
    }
  }
  const int n_it = (kv_end - kv_begin + BKV - 1) / BKV;   // at least 1

  // Stages the block's columns of KV tile `it`'s K and V into stage it & 1.
  auto stage = [&](int it) {
    const int k0 = kv_begin + it * BKV;
    T* b = skv + (it & 1) * 2 * BKV * LD;
    load_tile<T, W_COLS, BKV, NTB>(b, k + kvh * st.k_sh + col0, k0, S,
                                   D - col0, st.k_ss, vec & VEC_K);
    load_tile<T, W_COLS, BKV, NTB>(b + BKV * LD, v + kvh * st.v_sh + col0,
                                   k0, S, D - col0, st.v_ss, vec & VEC_V);
  };

  load_tile<T, W_COLS, BQ, NTB>(sq, q + h * st.q_sh + col0, q0, S,
                                D - col0, st.q_ss, vec & VEC_Q);
  load_tile<T, W_COLS, BQ, NTB>(sdo, dout + h * st.do_sh + col0, q0, S,
                                D - col0, st.do_ss, vec & VEC_DO);
  stage(0);
  cp_async_commit();
  // lse (base 2) and delta of the owned rows (0 past S, where every entry
  // is masked).
  for (int i = threadIdx.x; i < n_own; i += NTB) {
    const int qi = q0 + row0 + i;
    olse[i] = qi < S ? lse[(long long)h * S + qi] * LOG2E : 0.f;
    odlt[i] = qi < S ? delta[(long long)h * S + qi] : 0.f;
  }

  float acc[1][DN / 8][4];
  zero(acc);
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1, whose
    // stage the copy of tile it + 1 now overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();
    const int k0 = kv_begin + it * BKV;
    const T* ck = skv + (it & 1) * 2 * BKV * LD;
    // The partial S = Q K^T and dP = dO V^T over this block's columns,
    // each stored before the next is computed (registers).
#pragma unroll
    for (int m = m_first; m < m_end; ++m) {
      float part[1][NJ][4];
      abt<W_COLS, 1, NJ>(part, m ? sdo : sq, ck + m * BKV * LD, wrow, lane);
      push_partial(m ? xdp : xs, part, wrow, rank, n, lane);
    }
    // Every block's partials are in their owners' buffers (and every
    // block is done reading the dS of tile it - 1).
    cluster_sync();
    // P = 2^(S scale log2 e - lse log2 e) (masked entries 0) and dS = P o
    // (dP - delta) of the owned rows, packed to T, into every block.
    reduce_rows<BKV, NTB>(
        xs, xdp, n_own, n,
        [&](int lr, int c, const float4& s, const float4& dp) {
          const int qi = q0 + row0 + lr;
          const float sv[4] = {s.x, s.y, s.z, s.w};
          const float dv[4] = {dp.x, dp.y, dp.z, dp.w};
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe =
                keep(qi, k0 + c + e, S, causal, window)
                    ? ex2(fmaf(sv[e], scale_log2, -olse[lr]))
                    : 0.f;
            ds[e] = pe * (dv[e] - odlt[lr]);
          }
          bcast4(fds + (row0 + lr) * LX + c, ds, n);
        });
    // The tile's dS is in every block (and every block is done reading
    // its partials).
    cluster_sync();
    float x[1][NJ][4];
    gather_rows(x, fds, wrow, lane);
    add_xb<W_COLS, 1, NJ, DN>(acc, x, ck + wcol, lane);
  }
  // No block leaves while a peer may still write into it.
  cluster_sync();
  store_dq(acc, dq, q0, wrow, lane, S, H, h, D, col0 + wcol, scale);
}

// The wgmma route (bf16 and f16 at head_dim 33-256 whose q, k, v and dO are
// whole 16-byte units; the file's header says how it works and why), by
// padded head_dim DP (64: 33-64; 128: 65-128; 256: 129-256): query rows a
// block (two consumer warpgroups of 64), keys a KV tile (32 at 256, where Q
// and dO of 128 rows take 128 KB of the 227), threads a block (a producer
// and two consumer warpgroups), the registers a thread of each role keeps
// (24 to 256, multiples of 8, at most 65,536 a block: 128 x 40 + 256 x 232
// at 64; 128 x 24 + 256 x 240 at 128 and 256, where dQ's accumulator is two
// and four times as wide), the ring's stages, the order of the blocks
// (HEADS_FIRST: the heaviest causal tiles of every head first, the heads
// varying fastest, so that the lightest run last; else each head's in
// turn), and the consumers' schedule: a tile's products in turn (S and dP;
// dS; dQ += dS K), or PIPELINED: S and dP of tile j issued with dQ += dS K
// of tile j - 1, and dS of tile j formed while that runs, which holds two
// tiles of K in the ring and so takes a third stage for the copies to run
// ahead. What an H100 measured (NVIDIA H100 80GB HBM3, 700 W, kernel_ab.py,
// at (8192, 32, 8, 128) bf16 causal): 128-key tiles spilled 48 bytes and
// took 1.311 ms against 1.153 with 64-key ones; the 2-D grid 1.233 against
// 1.153 heads first; PIPELINED with three stages 1.049 against 1.163 in
// turn. At (8192, 8, 1, 256) bf16 (32-key tiles, the SM clock 1,725-1,980
// MHz): two stages 1.001 ms against 0.643 with three, and in turn 0.674
// against 0.643 PIPELINED.
template <int DP> struct GTile {
  static_assert(DP == 64 || DP == 128 || DP == 256, "64, 128 or 256");
  static constexpr int BQ = 128;
  static constexpr int BKV = DP == 64 ? 128 : DP == 128 ? 64 : 32;
  static constexpr int NT = 384;
  static constexpr int PRODUCER_REGS = DP == 64 ? 40 : 24;
  static constexpr int CONSUMER_REGS = DP == 64 ? 232 : 240;
  static constexpr int STAGES = DP == 64 ? 2 : 3;
  static constexpr bool HEADS_FIRST = DP != 64;
  static constexpr bool PIPELINED = DP != 64;
};

// The wgmma route's shared memory for type T and padded head_dim DP, in
// bytes: a box (TMA_COLS columns of a row: 128 bytes) of the Q or dO
// tile and of one K or V tile, those tiles (DP / TMA_COLS boxes each),
// and the block's total: 1024 to align the tiles, Q, dO, the ring's
// stages of K and of V, and its mbarriers (Q and dO full; K full, V full,
// K empty and V empty of each stage).
template <typename T, int DP> struct Gmma {
  static_assert(sizeof(T) == 2 && DP % TMA_COLS == 0, "16-bit, whole boxes");
  static constexpr int ROW = TMA_COLS * (int)sizeof(T);
  static constexpr int BOXES = DP / TMA_COLS;
  static constexpr int Q_BOX = GTile<DP>::BQ * ROW;
  static constexpr int KV_BOX = GTile<DP>::BKV * ROW;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int STAGES = GTile<DP>::STAGES;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 4 * STAGES) * 8;
};

// The wgmma route's kernel: one block of three warpgroups owns one (query
// head, BQ-row query tile). tq, tk, tv and tdo are the 3-D tensor maps
// (D, heads, S) of q, k, v and dO, with boxes of TMA_COLS columns, one
// head and BQ (q, dO) or BKV (k, v) rows.
template <typename T, int DP>
__global__ void __launch_bounds__(GTile<DP>::NT, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int S, int H, int group, int D,
                          int causal, int window, float scale) {
  using G = Gmma<T, DP>;
  using Tl = GTile<DP>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, NS = Tl::STAGES;
  constexpr int NJ = BKV / 8;            // 8-key score tiles
  constexpr int ND = DP / 8;             // 8-column tiles of dq
  extern __shared__ __align__(16) unsigned char gsmem_raw[];
  // Shared-window addresses: Q, dO, K's and V's stages, the barriers.
  const uint32_t sq = (smem_addr(gsmem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + G::Q_BYTES;
  const uint32_t sk = sdo + G::Q_BYTES;
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
  // the same across the warp (each role then keeps its own register
  // budget; flash_fwd.cu's wgmma route says why).
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  // Heaviest causal tiles (the last query rows) are scheduled first.
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
      mbar_init(k_empty + 8 * s, 8);   // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer warpgroup; one thread issues every copy: Q and dO once,
    // then K and V of each tile into the ring, box by box.
    setmaxnreg_dec<Tl::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * G::Q_BYTES);
      for (int b = 0; b < G::BOXES; ++b) {
        tma_load_3d(sq + b * G::Q_BOX, &tq, q_full, b * TMA_COLS, h, q0);
        tma_load_3d(sdo + b * G::Q_BOX, &tdo, q_full, b * TMA_COLS, h, q0);
      }
      const int kvh = h / group;
      for (int it = 0; it < n_it; ++it) {
        const int s = stage(it);
        const uint32_t ph = use(it);
        const int k0 = kv_begin + it * BKV;
        mbar_wait(k_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(k_full + 8 * s, G::KV_BYTES);
        for (int b = 0; b < G::BOXES; ++b)
          tma_load_3d(sk + s * G::KV_BYTES + b * G::KV_BOX, &tk,
                      k_full + 8 * s, b * TMA_COLS, kvh, k0);
        mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, G::KV_BYTES);
        for (int b = 0; b < G::BOXES; ++b)
          tma_load_3d(sv + s * G::KV_BYTES + b * G::KV_BOX, &tv,
                      v_full + 8 * s, b * TMA_COLS, kvh, k0);
      }
    }
  } else {
    // A consumer warpgroup: query rows q0w.. (64 of them), the warp's 16
    // from 16 wq.
    setmaxnreg_inc<Tl::CONSUMER_REGS>();
    const int wq = warp & 3, cw = wg - 1;
    const int q0w = q0 + 64 * cw;
    const int g = lane >> 2, t = lane & 3;
    // lse (base 2) and delta of rows g and g + 8 of the warp. Rows past S
    // take 0: their Q and dO rows are zeros (the copies fill them), so
    // their dS is 0 where the tile is not masked, and they are never
    // written.
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0w + 16 * wq + g + 8 * r;
      lse2[r] = qi < S ? lse[(long long)h * S + qi] * LOG2E : 0.f;
      dlt[r] = qi < S ? delta[(long long)h * S + qi] : 0.f;
    }
    // Descriptors of the warpgroup's Q and dO rows (A, K-major), of K's
    // and V's stage 0 as the B of the score products (K-major) and of K's
    // as the B of dS K (MN-major: its rows are the depth, its boxes of 64
    // columns G::KV_BOX apart); a box, a 16-deep step and a stage are
    // offsets added to them (16-byte units).
    const uint64_t da_q = sw128_desc(sq + cw * 64 * G::ROW, 16, 1024);
    const uint64_t da_do = sw128_desc(sdo + cw * 64 * G::ROW, 16, 1024);
    const uint64_t db_k = sw128_desc(sk, 16, 1024);
    const uint64_t db_v = sw128_desc(sv, 16, 1024);
    const uint64_t db_kt = sw128_desc(sk, G::KV_BOX, 1024);
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const float scale_log2 = scale * LOG2E;
    mbar_wait(q_full, 0);
    // The tile loop in turn keeps its code apart from the pipelined one:
    // built from the pipelined loop's lambdas, the head_dim-64 template ran
    // 0.8% slower on an H100 (kernel_ab.py, four 64 shapes, twice).
    if constexpr (!Tl::PIPELINED) {
      for (int it = 0; it < n_it; ++it) {
        const int st = stage(it);
        const uint32_t ph = use(it);
        const int k0 = kv_begin + it * BKV;
        const uint32_t off = st * (G::KV_BYTES >> 4);
        // No row of the warpgroup may use any key of the tile: past the
        // causal diagonal, before the window, or rows past S.
        const bool skip =
            q0w >= S ||
            (causal && (k0 > q0w + 63 ||
                        (window > 0 && q0w - (k0 + BKV - 1) >= window)));
        // Some entry of the warpgroup's rows against the tile is masked.
        const bool masked =
            k0 + BKV > S ||
            (causal && (k0 + BKV - 1 > q0w ||
                        (window > 0 && q0w + 63 - k0 >= window)));
        mbar_wait(k_full + 8 * st, ph);
        mbar_wait(v_full + 8 * st, ph);
        float s[NJ][4], dp[NJ][4];       // written whole by the first step
        if (!skip) {
          // S = Q K^T and dP = dO V^T, DP / 16 steps of depth 16 each: 4 a
          // box, 32 bytes apart inside the swizzle atom.
          fence_regs(s);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<T>(s, da_q + ((b * G::Q_BOX + kk * 32) >> 4),
                          db_k + off + ((b * G::KV_BOX + kk * 32) >> 4),
                          b | kk);
#pragma unroll
          for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<T>(dp, da_do + ((b * G::Q_BOX + kk * 32) >> 4),
                          db_v + off + ((b * G::KV_BOX + kk * 32) >> 4),
                          b | kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
        }
        if (lane == 0) mbar_arrive(v_empty + 8 * st);
        if (!skip) {
          // dS = P o (dP - delta), P = 2^(S scale log2 e - lse log2 e)
          // (masked entries 0), in place of S.
          if (masked) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qi = q0w + 16 * wq + g + 8 * (e >> 1);
                const int kj = k0 + 8 * j + 2 * t + (e & 1);
                const float p =
                    keep(qi, kj, S, causal, window)
                        ? ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1]))
                        : 0.f;
                s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
              }
          } else {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[j][e] = ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) *
                          (dp[j][e] - dlt[e >> 1]);
          }
          // dS as A fragments of the input's type, 16 keys a step; then dQ
          // += dS K, K's rows the depth (16 keys, 2048 bytes a step).
          uint32_t a[BKV / 16][4];
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) {
            a[kk][0] = pack16<T>(s[2 * kk][0], s[2 * kk][1]);
            a[kk][1] = pack16<T>(s[2 * kk][2], s[2 * kk][3]);
            a[kk][2] = pack16<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[kk][3] = pack16<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          }
          fence_regs(acc);
          fence_regs(a);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
            wgmma_rs<T, ND>(acc, a[kk],
                            db_kt + off + ((kk * 16 * G::ROW) >> 4), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(a);
        }
        if (lane == 0) mbar_arrive(k_empty + 8 * st);
      }
    } else {
      float s[NJ][4], dp[NJ][4];         // written whole by the first step
      uint32_t a[BKV / 16][4];           // dS as A fragments
      // S = Q K^T and dP = dO V^T of the tile in stage st, DP / 16 steps of
      // depth 16 each: 4 a box, 32 bytes apart inside the swizzle atom.
      // Issued only: the caller commits and waits.
      auto issue_scores = [&](int st) {
        const uint32_t off = st * (G::KV_BYTES >> 4);
#pragma unroll
        for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<T>(s, da_q + ((b * G::Q_BOX + kk * 32) >> 4),
                        db_k + off + ((b * G::KV_BOX + kk * 32) >> 4), b | kk);
#pragma unroll
        for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<T>(dp, da_do + ((b * G::Q_BOX + kk * 32) >> 4),
                        db_v + off + ((b * G::KV_BOX + kk * 32) >> 4), b | kk);
      };
      // dQ += dS K of the tile in stage st, K's rows the depth (16 keys,
      // 2048 bytes a step). Issued only.
      auto issue_dq = [&](int st) {
        const uint32_t off = st * (G::KV_BYTES >> 4);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs<T, ND>(acc, a[kk], db_kt + off + ((kk * 16 * G::ROW) >> 4),
                          1);
      };
      // dS = P o (dP - delta), P = 2^(S scale log2 e - lse log2 e) (masked
      // entries 0), in place of S, for the tile at key k0. MASKED: whether
      // the tile has a masked entry, decided by the caller, so that no
      // branch on it sits between a product and its wait.
      auto form_ds = [&](int k0, auto masked) {
        if constexpr (decltype(masked)::value) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = q0w + 16 * wq + g + 8 * (e >> 1);
              const int kj = k0 + 8 * j + 2 * t + (e & 1);
              const float p =
                  keep(qi, kj, S, causal, window)
                      ? ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1]))
                      : 0.f;
              s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) *
                        (dp[j][e] - dlt[e >> 1]);
        }
      };
      // dS (in s) packed to the input's type as A fragments, 16 keys a step.
      auto pack_ds = [&] {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          a[kk][0] = pack16<T>(s[2 * kk][0], s[2 * kk][1]);
          a[kk][1] = pack16<T>(s[2 * kk][2], s[2 * kk][3]);
          a[kk][2] = pack16<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          a[kk][3] = pack16<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
      };
      // Some entry of the warpgroup's rows against the tile at k0 is masked.
      auto masked_at = [&](int k0) {
        return k0 + BKV > S ||
               (causal && (k0 + BKV - 1 > q0w ||
                           (window > 0 && q0w + 63 - k0 >= window)));
      };
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
      auto pass = [&](int it) {
        mbar_wait(k_full + 8 * stage(it), use(it));
        mbar_wait(v_full + 8 * stage(it), use(it));
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * stage(it));
          mbar_arrive(v_empty + 8 * stage(it));
        }
      };
      for (int it = 0; it < lo; ++it) pass(it);
      if (lo < hi) {
        // The first tile: its scores alone, then its dS.
        mbar_wait(k_full + 8 * stage(lo), use(lo));
        mbar_wait(v_full + 8 * stage(lo), use(lo));
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores(stage(lo));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (lane == 0) mbar_arrive(v_empty + 8 * stage(lo));
        const int k0 = kv_begin + lo * BKV;
        if (masked_at(k0))
          form_ds(k0, std::true_type{});
        else
          form_ds(k0, std::false_type{});
        pack_ds();
      }
      // Tile j: its scores issued with dQ += dS K of tile j - 1, and its
      // dS formed while that product runs.
      auto step = [&](int j, auto masked) {
        const int st = stage(j), sp = stage(j - 1);
        mbar_wait(k_full + 8 * st, use(j));
        mbar_wait(v_full + 8 * st, use(j));
        fence_regs(s);
        fence_regs(dp);
        fence_regs(acc);
        fence_regs(a);
        wgmma_fence();
        issue_scores(st);
        wgmma_commit();
        issue_dq(sp);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        form_ds(kv_begin + j * BKV, masked);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(a);
        if (lane == 0) {
          mbar_arrive(v_empty + 8 * st);
          mbar_arrive(k_empty + 8 * sp);
        }
        pack_ds();
      };
      for (int j = lo + 1; j < hi; ++j) {
        if (masked_at(kv_begin + j * BKV))
          step(j, std::true_type{});
        else
          step(j, std::false_type{});
      }
      if (lo < hi) {
        // The last tile's dQ += dS K.
        fence_regs(acc);
        fence_regs(a);
        wgmma_fence();
        issue_dq(stage(hi - 1));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(a);
        if (lane == 0) mbar_arrive(k_empty + 8 * stage(hi - 1));
      }
      for (int it = hi; it < n_it; ++it) pass(it);
    }

    // dq = scale * acc in q's type, two columns a 32-bit store (head_dim
    // is a whole number of 8-column units on this route).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0w + 16 * wq + g + 8 * r;
      if (qi >= S) continue;
      T* row = dq + ((long long)qi * H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < D)
          *reinterpret_cast<uint32_t*>(row + col) = pack16<T>(
              acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
      }
    }
  }
}

// Bits of `vec` for q, k, v and dO: a tensor takes the 16-byte copy path
// when its pointer, row and head strides and head_dim are all whole
// 16-byte units.
template <typename T>
int vec_bits(const void* const* p, const Strides& st, int D) {
  constexpr long long V = 16 / sizeof(T);
  auto whole = [&](const void* ptr, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ss % V == 0 &&
           sh % V == 0 && D % V == 0;
  };
  return (whole(p[0], st.q_ss, st.q_sh) ? VEC_Q : 0) |
         (whole(p[1], st.k_ss, st.k_sh) ? VEC_K : 0) |
         (whole(p[2], st.v_ss, st.v_sh) ? VEC_V : 0) |
         (whole(p[3], st.do_ss, st.do_sh) ? VEC_DO : 0);
}

template <typename T, int DP>
cudaError_t launch_dq(const void* const* p, int S, int H, int KVH, int D,
                      const Strides& st, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, DP>();
  constexpr int BQ = q_rows(sizeof(T) == 4, DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq_split(const void* const* p, int S, int H, int KVH,
                            int D, const Strides& st, int causal, int window,
                            float scale, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_split_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 16 * WARPS - 1) / (16 * WARPS), H);
  flash_bwd_dq_split_kernel<T, DP><<<grid, SPLIT_NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq_wgmma(const void* const* p, int S, int H, int KVH,
                            int D, const Strides& st, int causal, int window,
                            float scale, cudaStream_t stream) {
  using Tl = GTile<DP>;
  constexpr int smem = Gmma<T, DP>::SMEM;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = tile_map<T>(&tq, p[0], D, H, S, st.q_ss, st.q_sh, Tl::BQ);
  if (err == cudaSuccess)
    err = tile_map<T>(&tk, p[1], D, KVH, S, st.k_ss, st.k_sh, Tl::BKV);
  if (err == cudaSuccess)
    err = tile_map<T>(&tv, p[2], D, KVH, S, st.v_ss, st.v_sh, Tl::BKV);
  if (err == cudaSuccess)
    err = tile_map<T>(&tdo, p[3], D, H, S, st.do_ss, st.do_sh, Tl::BQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + Tl::BQ - 1) / Tl::BQ;
  const dim3 grid = Tl::HEADS_FIRST ? dim3(tiles * H) : dim3(tiles, H);
  flash_bwd_dq_wgmma_kernel<T, DP><<<grid, Tl::NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_wide(const void* const* p, int S, int H, int KVH,
                           int D, const Strides& st, int causal, int window,
                           float scale, cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes<T>();
  auto* kernel = flash_bwd_dq_wide_kernel<T, W_KVROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n = (D + W_COLS - 1) / W_COLS;
  const ClusterLaunch l(dim3((S + W_ROWS - 1) / W_ROWS * n, H),
                        wide_threads<T>(), smem, stream, n);
  err = cudaLaunchKernelEx(
      &l.cfg, kernel, static_cast<const T*>(p[0]),
      static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t launch_dq_stream(const void* const* p, int S, int H, int KVH,
                             int D, const Strides& st, int causal,
                             int window, float scale, cudaStream_t stream) {
  constexpr int smem = stream_smem_bytes<T>();
  constexpr int DC = stream_chunk<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_stream_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_slices = (D + W_COLS - 1) / W_COLS;
  const dim3 grid((S + W_ROWS - 1) / W_ROWS * n_slices, H);
  flash_bwd_dq_stream_kernel<T, DC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The widest head_dim of the wide route: 8 blocks a cluster.
constexpr int WIDE_MAX_D = W_COLS * X_MAX_N;

// The routes, by the codes flash_bwd_dq_route gives them
// (flash_attention.BWD_ROUTES): the instances (head_dim padded to 16, 32,
// 64, 128 or 256), the wgmma route (bf16 and f16 at 33-256 whose q, k, v
// and dO all take the 16-byte copy path, as TMA needs; head_dim padded to
// 64, 128 or 256), the wide route (257-1024) and the streamed route
// beyond.
enum Route { R_INSTANCE = 0, R_WGMMA = 1, R_WIDE = 2, R_STREAM = 3 };
constexpr int VEC_ALL = VEC_Q | VEC_K | VEC_V | VEC_DO;

template <typename T>
Route route_for(int D, int vec) {
  return D > WIDE_MAX_D ? R_STREAM
       : D > 256        ? R_WIDE
       : sizeof(T) == 2 && D > 32 && vec == VEC_ALL ? R_WGMMA
                                                    : R_INSTANCE;
}

// The template instances with head_dim padded to 16, 32, 64, 128 or 256,
// the wgmma route, the wide route to 1024 and the streamed route beyond.
template <typename T>
Launcher dq_for(int D, int vec) {
  if constexpr (sizeof(T) == 2)
    if (route_for<T>(D, vec) == R_WGMMA)
      return D <= 64 ? &launch_dq_wgmma<T, 64>
           : D <= 128 ? &launch_dq_wgmma<T, 128>
                      : &launch_dq_wgmma<T, 256>;
  return D <= 16 ? &launch_dq<T, 16>
       : D <= 32 ? &launch_dq<T, 32>
       : D <= 64 ? &launch_dq<T, 64>
       : D <= 128 ? &launch_dq<T, 128>
       : D <= 256 ? &launch_dq_split<T, 256>
       : D <= WIDE_MAX_D ? &launch_dq_wide<T>
                         : &launch_dq_stream<T>;
}

template <typename T>
int smem_for(int D, int vec) {
  if constexpr (sizeof(T) == 2)
    if (route_for<T>(D, vec) == R_WGMMA)
      return D <= 64 ? Gmma<T, 64>::SMEM
           : D <= 128 ? Gmma<T, 128>::SMEM
                      : Gmma<T, 256>::SMEM;
  return D <= 16 ? smem_bytes<T, 16>()
       : D <= 32 ? smem_bytes<T, 32>()
       : D <= 64 ? smem_bytes<T, 64>()
       : D <= 128 ? smem_bytes<T, 128>()
       : D <= 256 ? split_smem_bytes<T, 256>()
       : D <= WIDE_MAX_D ? wide_smem_bytes<T>()
                         : stream_smem_bytes<T>();
}

// Warps an SM of the template for (D, vec), or -1 on the wide and
// streamed routes.
template <typename T>
int warps_for(int D, int vec) {
  if constexpr (sizeof(T) == 2)
    if (route_for<T>(D, vec) == R_WGMMA)
      return D <= 64 ? warps_per_sm(flash_bwd_dq_wgmma_kernel<T, 64>,
                                    GTile<64>::NT, Gmma<T, 64>::SMEM)
           : D <= 128 ? warps_per_sm(flash_bwd_dq_wgmma_kernel<T, 128>,
                                     GTile<128>::NT, Gmma<T, 128>::SMEM)
                      : warps_per_sm(flash_bwd_dq_wgmma_kernel<T, 256>,
                                     GTile<256>::NT, Gmma<T, 256>::SMEM);
  return D <= 16 ? warps_per_sm(flash_bwd_dq_kernel<T, 16>, NT,
                                smem_bytes<T, 16>())
       : D <= 32 ? warps_per_sm(flash_bwd_dq_kernel<T, 32>, NT,
                                smem_bytes<T, 32>())
       : D <= 64 ? warps_per_sm(flash_bwd_dq_kernel<T, 64>, NT,
                                smem_bytes<T, 64>())
       : D <= 128 ? warps_per_sm(flash_bwd_dq_kernel<T, 128>, NT,
                                 smem_bytes<T, 128>())
       : D <= 256 ? warps_per_sm(flash_bwd_dq_split_kernel<T, 256>,
                                 SPLIT_NT, split_smem_bytes<T, 256>())
                  : -1;
}

template <typename T>
int clusters_for(int D) {
  return max_clusters(flash_bwd_dq_wide_kernel<T, W_KVROWS>,
                      wide_threads<T>(), wide_smem_bytes<T>(),
                      (D + W_COLS - 1) / W_COLS);
}

}  // namespace

extern "C" {

// q and dout (S, H, D), k and v (S, KVH, D), with unit stride along D and
// the row and head strides in `strides` (elements: q, k, v, dout, each
// row then head); lse and delta (H, S) f32 contiguous; dq written (S, H,
// D) contiguous in q's type. dtype: 0 = f32, 1 = bf16, 2 = f16. Any
// head_dim D >= 1. window <= 0 means none. Returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a size, dtype or head
// count no instance takes).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int S, int H, int KVH, int D,
                 const long long* strides, int causal, int window,
                 float scale, int dtype, void* stream) {
  if (S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, dout, lse, delta, dq};
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Launcher f =
      dtype == 0   ? dq_for<float>(D, vec_bits<float>(p, st, D))
      : dtype == 1 ? dq_for<bf16>(D, vec_bits<bf16>(p, st, D))
                   : dq_for<f16>(D, vec_bits<f16>(p, st, D));
  return (int)f(p, S, H, KVH, D, st, causal, window, scale,
                static_cast<cudaStream_t>(stream));
}

// The route (R_INSTANCE 0, R_WGMMA 1, R_WIDE 2, R_STREAM 3) a launch takes at
// head_dim D and dtype, with `vec` the bits (1 q, 2 k, 4 v, 8 dO) of the
// tensors whose pointer, strides and head_dim are whole 16-byte units.
int flash_bwd_dq_route(int D, int dtype, int vec) {
  return dtype == 0   ? route_for<float>(D, vec)
         : dtype == 1 ? route_for<bf16>(D, vec)
                      : route_for<f16>(D, vec);
}

// Bytes of dynamic shared memory a block of the template that (D, dtype,
// vec) takes.
int flash_bwd_dq_smem_bytes(int D, int dtype, int vec) {
  return dtype == 0   ? smem_for<float>(D, vec)
         : dtype == 1 ? smem_for<bf16>(D, vec)
                      : smem_for<f16>(D, vec);
}

// Clusters of the wide route's kernel for (D, dtype) the card can hold at
// once (cudaOccupancyMaxActiveClusters; 0: none fits, and a launch
// fails), minus a CUDA error, or -1 for a head_dim outside the route.
int flash_bwd_dq_max_clusters(int D, int dtype) {
  if (D <= 256 || D > WIDE_MAX_D) return -1;
  return dtype == 0   ? clusters_for<float>(D)
         : dtype == 1 ? clusters_for<bf16>(D)
                      : clusters_for<f16>(D);
}

// Warps of the template that (D, dtype, vec) takes an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), minus a CUDA error, or
// -1 for a head_dim on the wide or streamed route.
int flash_bwd_dq_warps_per_sm(int D, int dtype, int vec) {
  return dtype == 0   ? warps_for<float>(D, vec)
         : dtype == 1 ? warps_for<bf16>(D, vec)
                      : warps_for<f16>(D, vec);
}

// The wgmma route's tiles at padded head_dim DP (64, 128 or 256): query
// rows a block into *rows and keys a KV tile into *keys. Returns 0, or
// cudaErrorInvalidValue for another DP.
int flash_bwd_dq_wgmma_tiles(int DP, int* rows, int* keys) {
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

const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
