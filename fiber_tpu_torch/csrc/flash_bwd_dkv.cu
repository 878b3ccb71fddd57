// Flash-attention backward, dk and dv, for Hopper (sm_90a) on the tensor
// cores: plain CUDA C++ with a C interface, loaded with ctypes by
// fiber_tpu_torch/ops/flash_attention.py.
//
// Replaces fiber_tpu/ops/pallas_attention.py:_bwd_dkv_kernel. From the
// forward's saved (q, k, v, lse) and delta = rowsum(dO * O) - dlse:
//
//   p_ij  = exp(s_ij * scale - lse_i)          (masked entries 0)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dv_j  = sum_i p_ij dO_i,   dk_j = scale * sum_i ds_ij q_i
//
// summed over the query tiles of every query head of the KV head's GQA
// group, with _run_window's block skip as loop bounds and _keep_mask's
// elementwise mask (plus the ragged edge).
//
// What bounds it on this card: four S x S x D products (halved by
// causality) for O(S D) bytes, so operations. bf16 and f16 inputs run
// them at the 16-bit tensor-core rate (989 TFLOP/s dense), with f32 sums,
// lse, delta and P and dS before their packing (dS as in
// flash_bwd_dq.cu, its scale applied to dk in f32). f32 inputs run each
// product as three TF32 products (3xTF32, below), so at a third of the
// 495 TFLOP/s TF32 rate, 165 TFLOP/s: still 2.5x the 67 TFLOP/s of f32
// FMA on the CUDA cores, which the previous version of this kernel used.
//
// Why 3xTF32 and not plain TF32: each f32 operand x is split into big =
// tf32(x) and small = x - big (of which the tensor core keeps the top 19
// bits), and a product is accumulated in f32 as small*big + big*small +
// big*big (the small*small term is below f32's rounding). An emulation of
// this kernel's f32 arithmetic on the CPU (S = 2048, D = 32, 4 heads,
// causal, against an f64 recomputation; tests/test_torch_flash_backward.py
// keeps it) puts plain TF32 at 7.7e-4 (dk) and 4.7e-4 (dv) of the
// largest gradient, ten times the 5e-5 parity bound, and 3xTF32 at 1.4e-6
// and 1.4e-6.
//
// Design (FlashAttention-2's backward structure, warp-level mma.sync):
//
// - Up to head_dim 128 one block of 4 warps owns one (KV head, 64-row KV
//   tile); each warp owns 16 KV rows and both of their accumulators, dk
//   and dv over all of head_dim. K and V are staged in shared memory
//   once. The block loops over the group's query heads and their query
//   tiles (64 rows; 32 at head_dim 128, to keep the accumulators in
//   registers), from the causal diagonal on and, with a window, up to k0
//   + 63 + window. dk and dv accumulate in registers; a block owns its
//   outputs, so there are no atomics and the gradients repeat bit for bit.
// - f32 at head_dim 129-256, and bf16 and f16 there whose tensors are not
//   whole 16-byte units, pad to one 256 instance
//   (flash_bwd_dkv_split_kernel): dk and dv over 256 columns would be 256
//   accumulator registers a thread, so one block of 8 warps owns the (KV
//   head, 64-row KV tile) and all 256 output columns, in two groups of 4
//   warps, 16 KV rows a warp in each group. Group A computes S^T = K Q^T
//   over the full depth, P^T, and holds dV; group B computes dP^T = V dO^T
//   over the full depth, reads P^T (f32) from shared memory to form dS^T,
//   and holds dK: one 128-register accumulator a thread, and 8 warps an SM.
//   Per query tile only P^T crosses between the groups, inside the block:
//   group A stores it and arrives on a named barrier, group B waits there
//   (bar.sync over the block's 256 threads), and the block barrier that
//   opens the next tile frees the buffer. Each score product is thus
//   computed once a (KV tile, query tile): 4 products of 64 x BQ x 256
//   (S^T, dP^T, dV, dK), where blocks that each owned a 128-column half of
//   dk and dv would compute S^T and dP^T in each half, 6. The other split
//   with the same count, groups that each own 128 columns of both dk and
//   dv, would exchange P^T and dS^T, one exchange more; here group B needs
//   P^T anyway, and A's dV and B's dK products are of one size, so the
//   groups stay in step; on an H100 the other split ran 3-4% slower in 16
//   bits and spilled in f32. Query tiles are 64 rows in a 16-bit type (the
//   accumulator and a 16 x 64 score tile fit the 255 registers a thread
//   that 8 warps an SM leave; 32-row tiles ran 20% slower), 32 in f32 (one
//   query-tile buffer; two would not fit the block's shared memory), whose
//   3xTF32 products add two accumulator tiles a pass (four spilled). With
//   few KV heads one block a KV tile would not fill the card (one KV head
//   at S 8192 gives 128 blocks for 132 SMs, and under causality the first
//   does twice the mean work), so the launcher splits each KV tile's work
//   over `parts` blocks (dkv_parts(): a power of two, at most the GQA group
//   and 8, doubled while the grid has no more blocks than the card has
//   SMs), each taking a share of the group's query heads. The parts of a
//   tile form a thread-block cluster; after the loop they sum their f32
//   partial dk and dv through distributed shared memory (cluster_sm90.cuh's
//   remote stores, into the shared memory the tiles used): block r owns
//   rows [64 r / parts, 64 (r + 1) / parts) of the tile, every block stores
//   those rows of its partials there, and the owner adds the parts in rank
//   order and writes them. The order is fixed, so two launches agree bit
//   for bit, with no atomics.
// - Per query tile a warp computes S^T = K Q^T and dP^T = V dO^T for its
//   16 rows (accumulator fragments), P^T and dS^T from them in registers,
//   then dV += P^T dO and dK += dS^T Q. P^T and dS^T never leave the
//   registers: for 16-bit types the m16n8k16 accumulator layout of two
//   adjacent 8-column tiles is the A-operand layout of one 16-deep step
//   (packed to pairs of the type); for f32 the m16n8k8 accumulator holds
//   columns 2t and 2t+1 where the A operand wants t and t+4, so the depth
//   index is permuted (t <-> 2t, t+4 <-> 2t+1) in both A and B, which
//   leaves the sum as it is.
// - Operands stay in their own type in shared memory: 16-bit rows padded
//   to D + 8 elements and read with ldmatrix (.trans for the B operand of
//   the two accumulating products); f32 rows padded to D + 4 and read
//   with 32-bit loads, split into big and small at each fragment load.
//   On f32 each query tile's dV and dK products are summed from zero and
//   then added to the running sums (add_xb() in mma_sm90.cuh).
//   Both paddings make the fragment reads free of bank conflicts.
// - bf16 and f16 at head_dim 33-256 whose q, k, v and dO are whole 16-byte
//   units take the wgmma route instead (flash_bwd_dkv_wgmma_kernel<type,
//   64, 128 or 256>, head_dim padded to 64, 128 or 256; wgmma_sm90.cuh),
//   Hopper's warpgroup products fed by the Tensor Memory Accelerator, where
//   the 64, 128 and 256 instances run warp-level mma.sync at a quarter of
//   their bound. One block of three warpgroups owns one (KV head, 128-key
//   tile). A producer warpgroup (its registers given back by setmaxnreg)
//   has one thread issue the TMA copies in the 128-byte swizzle, a
//   64-column box at a time (two a row at 128): K and V once, then Q and dO
//   of each 64-row query tile (every query head of the GQA group, the tiles
//   the mask lets through) into a ring of two stages, each completing on a
//   full mbarrier and handed back by an empty one; one of its warps stores
//   each tile's lse (times log2 e) and delta beside them and arrives on the
//   same full barrier (TMA cannot copy a row of lse whose S is not a
//   multiple of 4). Two consumer warpgroups own 64 keys each: S^T = K Q^T
//   and dP^T = V dO^T by wgmma m64n64k16 with both operands in shared
//   memory (one commit group, one wait; at 128 the depth runs over both
//   boxes), P^T and dS^T formed in the accumulators' registers and packed
//   there to the input's type as the A fragments of dV += P^T dO and dK +=
//   dS^T Q (m64n64k16 at 64, m64n128k16 at 128; dO and Q read MN-major:
//   their rows are the depth, their two boxes the descriptor's leading
//   offset apart), so neither goes through shared memory. At 128 dK and dV
//   are 128 accumulator registers a thread beside the 64 of S^T and dP^T:
//   GTile<128> gives the roles budgets of 24 / 240 (40 / 232 at 64) and
//   launches every KV head's heaviest causal tiles first (a 1-D grid, the
//   heads varying fastest). dk's scale is applied in f32 at the end. The
//   block owns its outputs, with no atomics, and each score product is
//   computed once a (KV tile, query tile). At 256 dK and dV over 256
//   columns would be 256 accumulator registers a thread, so the 256
//   instance's split moves onto the warpgroups (dkv_wgmma_pairs): a block
//   owns a 64-key tile, consumer A computes S^T and P^T and holds dV,
//   consumer B computes dP^T, forms dS^T from A's P^T (passed through 16 KB
//   of shared memory) and holds dK; K and V (64 KB), two stages of 64-row Q
//   and dO tiles (128 KB) and P^T take 215,096 bytes, and the parts of a KV
//   tile sum over a cluster, as the 256 instance's do (above).
// - head_dim 257-1024 takes the wide route (flash_bwd_dkv_wide_kernel):
//   dk and dv over 512 columns would be 512 accumulator registers a
//   thread. A thread-block cluster of n = ceil(D / 128) blocks (3 to 8,
//   the portable limit) owns one (KV head, 64-row KV tile), and block r
//   owns both dk and dv of columns [128 r, 128 r + 128), the 128
//   instance's two accumulators. Block r holds the same 128 columns of the
//   operands: K and V staged once, Q and dO (with lse and delta) of each
//   32-row query tile in two cp.async stages of a whole slice (one wait a
//   tile). Per query tile it computes S^T and dP^T over its 128 columns
//   of depth only, and the cluster sums those partials into P^T and dS^T
//   through distributed shared memory (cluster_sm90.cuh: block r
//   finishes rows [r own, r own + own) of the tile, own = ceil(64 / n);
//   every block stores its partial rows into their owner, which sums the
//   n partials in rank order and stores the finished P^T and dS^T rows
//   into every block), then adds P^T dO and dS^T Q to its slices. Each
//   score product is thus computed once: at head_dim 512, 4 slice-widths
//   of products a slice (S^T, dP^T, dV, dK over 128 columns each) where
//   the streamed kernel below took 14 (4 + 1 for dv, 4 + 4 + 1 for dk).
//   Each P and dS entry is finished by one block, so every slice uses the
//   same bits and dk and dv repeat bit for bit. The price is two cluster
//   barriers a query tile and the f32 partials crossing the cluster (see
//   flash_bwd_dq.cu). A block takes 102,784 bytes of shared memory for a
//   16-bit type (two blocks of 4 warps an SM) and 178,560 for f32 (one
//   block of 8 warps: S^T and dv on 4 of them, dP^T and dk on the other
//   4, since one thread with both f32 accumulators spilled).
// - head_dim above 1024 (more than 8 blocks a cluster) takes the streamed
//   kernel (flash_bwd_dkv_stream_kernel): each 128-column slice's dv and
//   dk get a block each (one of the 256 instance's halves; dk and dv of a
//   slice in one block, beside the state of a streamed stage, spilled),
//   and the depth of S^T = K Q^T (and for dk of dP^T = V dO^T) is
//   recomputed by every block, streamed through shared memory in chunks
//   of 256 bytes a row of a 16-bit type and 128 of f32, two buffers
//   whatever head_dim (104,448 bytes a block in bf16 and f16, 55,296 in
//   f32), so that any head_dim reaches a kernel.
// - Q, dO, lse and delta of the next query tile are copied with cp.async
//   (16 bytes a thread; 4 for lse and delta) into the second of two
//   buffers while the current tile computes: one wait and one barrier
//   per tile; for f32 at head_dim 256 one buffer, the next tile's copy
//   after a barrier at the end of this one. A tensor whose pointer,
//   strides or head_dim are not in whole 16-byte units takes a scalar
//   load path inside the kernel instead (per tensor, chosen by the
//   launcher).
//
// q, k, v and dO are read through their (S, heads, head_dim) strides; dk
// and dv are written contiguous, (S, KVH, D), in k's type. The copy,
// ldmatrix, mma and split helpers and the two tile products (abt,
// add_xb) are mma_sm90.cuh's, shared with the forward (flash_fwd.cu) and
// dq (flash_bwd_dq.cu).

#include "cluster_sm90.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BKV = 64;            // KV rows per block
constexpr int WARPS = BKV / 16;    // one warp per 16 KV rows
constexpr int NT = 32 * WARPS;     // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// Query rows per tile: 64, or 32 at head_dim 128, where four D-wide
// accumulators and two score tiles would not fit in 255 registers.
__host__ __device__ constexpr int q_tile(int dp) {
  return dp >= 128 ? 32 : 64;
}

// Blocks per SM the compiler must leave registers for: 3 (at most 170
// registers a thread) where ptxas then still spills nothing, else 1.
__host__ __device__ constexpr int min_blocks(bool f32, int dp) {
  return (f32 ? dp <= 32 : dp <= 64) ? 3 : 1;
}

// The 256 instance (head_dim 129-256): threads of a block (two groups of
// 4 warps), query rows a tile and query-tile buffers (64 rows and two
// buffers in a 16-bit type, 32 rows and one in f32), and the most blocks
// that share a KV tile (the portable cluster size).
constexpr int SPLIT_NT = 2 * NT;
template <typename T>
__host__ __device__ constexpr int split_q_tile() {
  return sizeof(T) == 2 ? 64 : 32;
}
template <typename T>
__host__ __device__ constexpr int split_q_bufs() {
  return sizeof(T) == 2 ? 2 : 1;
}
constexpr int MAX_PARTS = 8;

// Blocks of the 256 instance that share one KV tile, each with a share
// of the GQA group's query heads: a power of two, at most the group and
// MAX_PARTS, doubled while the grid (KV tiles x KV heads x parts) has no
// more blocks than the card has SMs. flash_attention.py's dkv_parts is
// this function.
__host__ __device__ constexpr int dkv_parts(int S, int KVH, int group,
                                            int sms) {
  const long long tiles = (long long)((S + BKV - 1) / BKV) * KVH;
  int parts = 1;
  while (2 * parts <= group && 2 * parts <= MAX_PARTS &&
         tiles * parts <= sms)
    parts *= 2;
  return parts;
}

// The wide and streamed routes (head_dim above 256): output columns a
// block, and rows of each query tile.
constexpr int W_COLS = 128;
constexpr int W_QROWS = 32;
static_assert(BKV == X_ROWS, "the cluster exchanges the KV tile");

// Blocks an SM the wide route's registers must allow: two for a 16-bit
// type, one for f32, whose tiles take 163 KB.
template <typename T>
__host__ __device__ constexpr int wide_min_blocks() {
  return sizeof(T) == 2 ? 2 : 1;
}

// Threads of a wide-route block: 4 warps, each with both accumulators of
// its 16 KV rows, for a 16-bit type; 8 for f32, warps 0-3 computing S^T
// and holding dv, warps 4-7 computing dP^T and holding dk (both f32
// accumulators beside the 3xTF32 operands of a product spilled).
template <typename T>
__host__ __device__ constexpr int wide_threads() {
  return sizeof(T) == 2 ? NT : 2 * NT;
}

// Bytes of one of the wide route's two query-tile stages: the tile's 128
// columns of Q and of dO, then its lse and delta.
template <typename T>
__host__ __device__ constexpr int wide_stage_bytes() {
  return 2 * W_QROWS * (W_COLS + Pad<T>::value) * (int)sizeof(T) +
         2 * W_QROWS * (int)sizeof(float);
}

// Dynamic shared memory of one block of the wide route, whatever head_dim
// up to 1024: K and V (128 columns), two query-tile stages, the receive
// buffers of the partial S^T and dP^T (f32), and the tile's P^T and
// dS^T.
template <typename T>
__host__ __device__ constexpr int wide_smem_bytes() {
  constexpr int LX = W_QROWS + X_PAD;
  return 2 * BKV * (W_COLS + Pad<T>::value) * (int)sizeof(T) +
         2 * wide_stage_bytes<T>() +
         2 * recv_rows() * LX * (int)sizeof(float) +
         2 * BKV * LX * (int)sizeof(T);
}

// Depth of one chunk of the streamed route's score products: 256 bytes of
// a row of a 16-bit type (128 columns; 128-byte chunks ran slower on an
// H100), 128 of f32 (32 columns; 64 columns spilled).
template <typename T>
__host__ __device__ constexpr int stream_chunk() {
  return sizeof(T) == 4 ? 32 : 128;
}

// Bytes of one of the streamed route's two stage buffers: a chunk of K,
// Q, V and dO, or a Q or dO slice with the query tile's lse and delta,
// whichever is larger.
template <typename T>
__host__ __device__ constexpr int stream_buf_bytes() {
  constexpr int chunk = (2 * BKV + 2 * W_QROWS) *
                        (stream_chunk<T>() + Pad<T>::value) * (int)sizeof(T);
  constexpr int slice = W_QROWS * (W_COLS + Pad<T>::value) * (int)sizeof(T) +
                        2 * W_QROWS * (int)sizeof(float);
  return chunk > slice ? chunk : slice;
}

// Dynamic shared memory of one block of the streamed route, whatever
// head_dim.
template <typename T>
constexpr int stream_smem_bytes() {
  return 2 * stream_buf_bytes<T>();
}

struct Strides {                   // row (ss) and head (sh) strides, elements
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, do_ss, do_sh;
};

// Bits of `vec`: the 16-byte copy path may be used for q, k, v, dO.
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_DO = 8;

// The streamed route's tile arithmetic (the instances up to 256 keep the
// same arithmetic inline: folding them onto these helpers changed their
// register allocation and made one of them spill).

// Whether any entry of query tile q0 against KV tile k0 is masked
// (diagonal, window edge or ragged edge); most tiles of a long sequence
// have none. It is the same for the whole block, so no warp diverges.
template <int BQ, int BKV>
__device__ __forceinline__ bool tile_masked(int q0, int k0, int S,
                                            int causal, int window) {
  bool masked = q0 + BQ > S || k0 + BKV > S;
  if (causal)
    masked = masked || q0 < k0 + BKV - 1 ||
             (window > 0 && q0 + BQ - 1 - k0 >= window);
  return masked;
}

// P^T = exp(S^T scale - lse) in place of the warp's raw scores p (its 16
// KV rows of tile k0 against query tile q0, whose lse is clse), masked
// entries 0; the mask only where tile_masked() says the tile needs it.
template <int NJ>
__device__ __forceinline__ void to_pt(float (&p)[1][NJ][4],
                                      const float* clse, bool masked,
                                      int q0, int k0, int wrow, int lane,
                                      int S, int causal, int window,
                                      float scale_log2) {
  const int g = lane >> 2, t = lane & 3;
  if (masked) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int kj = k0 + wrow + g + (e >> 1) * 8;
        p[0][j][e] =
            keep(q0 + col, kj, S, causal, window)
                ? ex2(fmaf(p[0][j][e], scale_log2, -clse[col] * LOG2E))
                : 0.f;
      }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        p[0][j][e] = ex2(fmaf(p[0][j][e], scale_log2, -clse[col] * LOG2E));
      }
  }
}

// dS^T = P^T o (dP^T - delta) in place of the warp's dP^T = V dO^T.
template <int NJ>
__device__ __forceinline__ void to_dst(float (&ds)[1][NJ][4],
                                       const float (&p)[1][NJ][4],
                                       const float* cdelta, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      ds[0][j][e] = p[0][j][e] * (ds[0][j][e] - cdelta[col]);
    }
}

// to_dst with P^T read from shared memory, the tile group A wrote (rows
// 8 NJ + X_PAD apart), a pair at a time: no second score tile in the
// registers, which f32 at head_dim 256 has no room for.
template <int NJ>
__device__ __forceinline__ void to_dst_shared(float (&ds)[1][NJ][4],
                                              const float* fp,
                                              const float* cdelta, int wrow,
                                              int lane) {
  constexpr int LF = 8 * NJ + X_PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 pt = ld_pair(fp + (wrow + g + 8 * h) * LF + 8 * j + 2 * t);
      const int col = j * 8 + 2 * t;
      ds[0][j][2 * h] = pt.x * (ds[0][j][2 * h] - cdelta[col]);
      ds[0][j][2 * h + 1] = pt.y * (ds[0][j][2 * h + 1] - cdelta[col + 1]);
    }
}

// The instances up to head_dim 128 (the file's header says why).
template <typename T, int DP>
__global__ void __launch_bounds__(NT, min_blocks(sizeof(T) == 4, DP))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int KVH, int group, int D,
                     Strides st, int vec, int causal, int window,
                     float scale) {
  static_assert(DP <= 128, "head_dim 129-256 is the split kernel's");
  constexpr int BQ = q_tile(DP);
  constexpr int NB = 2;             // Q and dO (lse, delta) buffers
  constexpr int NJ = BQ / 8;        // 8-column score tiles per warp
  constexpr int ND = DP / 8;        // 8-column accumulator tiles
  constexpr int LD = DP + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);     // BKV x LD
  T* sv = sk + BKV * LD;                      // BKV x LD
  T* sq = sv + BKV * LD;                      // NB buffers of BQ x LD
  T* sdo = sq + NB * BQ * LD;                 // NB buffers of BQ x LD
  float* slse = reinterpret_cast<float*>(sdo + NB * BQ * LD);  // NB x BQ
  float* sdelta = slse + NB * BQ;                              // NB x BQ

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;   // the warp's first KV row
  const int kvh = blockIdx.y;
  // Under causality the first KV tiles see the most query tiles; they
  // have the lowest block index and are scheduled first.
  const int k0 = blockIdx.x * BKV;

  // The transpose of _run_window: KV rows [k0, k0 + BKV) are seen by
  // query rows from k0 on (causal), and with a window only up to the last
  // row whose window still reaches key k0 + BKV - 1.
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BKV - 1 + window);
  }
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;  // per query head
  const int n_it = group * n_qt;

  // Stages query tile `it` (head it / n_qt of the group) into buffer
  // it % NB.
  auto stage = [&](int it) {
    const int h = kvh * group + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * BQ;
    const int b = it % NB;
    load_tile<T, DP, BQ, NT>(sq + b * BQ * LD, q + h * st.q_sh, q0, S, D,
                             st.q_ss, vec & VEC_Q);
    load_tile<T, DP, BQ, NT>(sdo + b * BQ * LD, dout + h * st.do_sh, q0, S,
                             D, st.do_ss, vec & VEC_DO);
    for (int i = threadIdx.x; i < 2 * BQ; i += NT) {
      const bool is_delta = i >= BQ;
      const int c = is_delta ? i - BQ : i;
      const float* row = (is_delta ? delta : lse) + (long long)h * S;
      float* dst = (is_delta ? sdelta : slse) + b * BQ + c;
      const bool ok = q0 + c < S;
      cp_async4(dst, ok ? row + q0 + c : row, ok ? 4 : 0);
    }
  };

  load_tile<T, DP, BKV, NT>(sk, k + kvh * st.k_sh, k0, S, D, st.k_ss,
                            vec & VEC_K);
  load_tile<T, DP, BKV, NT>(sv, v + kvh * st.v_sh, k0, S, D, st.v_ss,
                            vec & VEC_V);
  if (n_it > 0) stage(0);
  cp_async_commit();

  // One 16-row m-tile a warp (the [1] of every fragment array).
  float acc_k[1][ND][4], acc_v[1][ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[0][n][e] = acc_v[0][n][e] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1, whose
    // buffer the copy of tile it + 1 now overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();

    const int b = it % NB;
    const int q0 = q_begin + (it % n_qt) * BQ;
    const T* cq = sq + b * BQ * LD;
    const T* cdo = sdo + b * BQ * LD;
    const float* clse = slse + b * BQ;
    const float* cdelta = sdelta + b * BQ;
    // Whether any entry of this tile is masked (diagonal, window edge or
    // ragged edge); most tiles of a long sequence have none. It is the
    // same for the whole block, so the two loops below never diverge.
    bool masked = q0 + BQ > S || k0 + BKV > S;
    if (causal)
      masked = masked || q0 < k0 + BKV - 1 ||
               (window > 0 && q0 + BQ - 1 - k0 >= window);

    // P^T = exp(S^T * scale - lse), then dV += P^T dO.
    float p[1][NJ][4];
    abt<DP, 1, NJ>(p, sk, cq, wrow, lane);
    if (masked) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int kj = k0 + wrow + g + (e >> 1) * 8;
          p[0][j][e] =
              keep(q0 + col, kj, S, causal, window)
                  ? ex2(fmaf(p[0][j][e], scale_log2, -clse[col] * LOG2E))
                  : 0.f;
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          p[0][j][e] =
              ex2(fmaf(p[0][j][e], scale_log2, -clse[col] * LOG2E));
        }
    }
    add_xb<DP, 1, NJ>(acc_v, p, cdo, lane);

    // dS^T = P^T o (dP^T - delta), dP^T = V dO^T; then dK += dS^T Q.
    float ds[1][NJ][4];
    abt<DP, 1, NJ>(ds, sv, cdo, wrow, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        ds[0][j][e] = p[0][j][e] * (ds[0][j][e] - cdelta[col]);
      }
    add_xb<DP, 1, NJ>(acc_k, ds, cq, lane);
  }

#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + wrow + g + (e >> 1) * 8;
      const int col = n * 8 + 2 * t + (e & 1);
      if (kj < S && col < D) {
        const long long at = ((long long)kj * KVH + kvh) * D + col;
        store(dk + at, acc_k[0][n][e] * scale);
        store(dv + at, acc_v[0][n][e]);
      }
    }
}

// The wgmma route (bf16 and f16 at head_dim 33-256 whose q, k, v and dO
// are whole 16-byte units; the file's header says how it works and why),
// by padded head_dim DP (64: 33-64; 128: 65-128; 256: 129-256): keys a
// block (two consumer warpgroups of 64 at 64 and 128; at 256 both
// consumers own the same 64, one holding dV and the other dK), query
// rows a tile, threads a block (a producer and two consumer warpgroups),
// the registers a thread of each role keeps (128 x 40 + 256 x 232 at 64;
// 128 x 24 + 256 x 240 at 128 and 256, where dK and dV over 128 columns,
// or one of them over 256, are 128 accumulator registers a thread; at
// most 65,536 a block), the ring's stages, the order of the
// blocks (HEADS_FIRST: the heaviest causal tiles of every KV head first,
// the heads varying fastest, so that the lightest run last; else each
// head's in turn), and the consumers' schedule (SPLIT: S^T and dP^T in
// two commit groups, P^T formed while dP^T runs, the masked decision
// taken before the products; else one group, and the decision after
// them). What an H100 measured (NVIDIA H100 80GB HBM3, 700 W,
// kernel_ab.py, at (8192, 32, 8, 128) bf16 causal): the 2-D grid 2.285
// ms against 1.721 heads first; SPLIT 1.713 against 1.766; a third stage
// 1.763 against 1.750; dV += P^T dO issued before dS^T is formed 1.795,
// and with SPLIT too 1.758. At (8192, 32, 8, 64) the same body in one
// commit group, with the masked decision taken before the products, took
// 1.308 ms against 1.386 (not taken there: the head_dim-64 template is
// kept as it was). At (8192, 8, 1, 256) bf16 (the SM clock 1,725-1,980
// MHz): a second P^T buffer 0.857 ms against 0.858 with one (not kept: 16
// KB more), and four parts a KV tile in place of dkv_parts()'s two 1.000
// against 0.858.
template <int DP> struct GTile {
  static_assert(DP == 64 || DP == 128 || DP == 256, "64, 128 or 256");
  static constexpr int BKV = DP == 256 ? 64 : 128;
  static constexpr int BQ = 64;
  static constexpr int NT = 384;
  static constexpr int PRODUCER_REGS = DP == 64 ? 40 : 24;
  static constexpr int CONSUMER_REGS = DP == 64 ? 232 : 240;
  static constexpr int STAGES = 2;
  static constexpr bool HEADS_FIRST = DP != 64;
  static constexpr bool SPLIT = DP == 128;
};

// The wgmma route's shared memory for type T and padded head_dim DP, in
// bytes: a row's box (TMA_COLS columns: 128 bytes), a box of the K or V
// tile and of the Q or dO tile, those tiles (DP / TMA_COLS boxes each), a
// query tile's stage (Q, then dO), P^T (f32) passed between the consumers
// at 256, and the block's total: 1024 to align the tiles, K, V, the
// ring's stages, the lse (base 2) and delta of each stage (f32), P^T, and
// its mbarriers (K and V full; Q full and Q empty of each stage; at 256
// P^T full and P^T empty).
template <typename T, int DP> struct Gmma {
  static_assert(sizeof(T) == 2 && DP % TMA_COLS == 0, "16-bit, whole boxes");
  static constexpr int ROW = TMA_COLS * (int)sizeof(T);
  static constexpr int BOXES = DP / TMA_COLS;
  static constexpr int KV_BOX = GTile<DP>::BKV * ROW;
  static constexpr int Q_BOX = GTile<DP>::BQ * ROW;
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int STAGES = GTile<DP>::STAGES;
  static constexpr bool PAIRS = DP == 256;
  static constexpr int PT_BYTES =
      PAIRS ? GTile<DP>::BKV * GTile<DP>::BQ * (int)sizeof(float) : 0;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * STAGE +
                              STAGES * 2 * GTile<DP>::BQ * (int)sizeof(float) +
                              PT_BYTES + (1 + 2 * STAGES + 2 * PAIRS) * 8;
};
static_assert(GTile<256>::BKV == BKV, "dkv_parts() counts 64-key tiles");

// The wgmma route's body at head_dim 33-128 (DP 64 or 128; inlined into
// flash_bwd_dkv_wgmma_kernel, below): one block of three warpgroups owns
// one (KV head, BKV-key tile) and both its outputs, summed over the query
// tiles of every query head of the GQA group, each consumer 64 of the
// keys. tq, tk, tv and tdo are the kernel's 3-D tensor maps (D, heads, S)
// of q, k, v and dO, with boxes of TMA_COLS columns, one head and BQ (q,
// dO) or BKV (k, v) rows.
template <typename T, int DP>
__device__ __forceinline__ void dkv_wgmma_tiles(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int S, int KVH, int group, int D, int causal,
    int window, float scale) {
  using G = Gmma<T, DP>;
  using Tl = GTile<DP>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, NS = Tl::STAGES;
  constexpr int NJ = BQ / 8;             // 8-query score tiles
  constexpr int ND = DP / 8;             // 8-column tiles of dk and dv
  extern __shared__ __align__(16) unsigned char gsmem_raw[];
  // Shared-window addresses: K, V, the query-tile stages (Q, then dO),
  // lse and delta of each stage, the barriers.
  const uint32_t base = smem_addr(gsmem_raw);
  const uint32_t sk = (base + 1023) & ~1023u;
  const uint32_t sv = sk + G::KV_BYTES;
  const uint32_t sq = sv + G::KV_BYTES;
  const uint32_t slse = sq + NS * G::STAGE;
  const uint32_t kv_full = slse + NS * 2 * BQ * (int)sizeof(float);
  const uint32_t q_full = kv_full + 8, q_empty = q_full + 8 * NS;
  // lse (base 2) and delta of stage s: BQ floats each, lse first.
  float* const lse_delta =
      reinterpret_cast<float*>(gsmem_raw + (slse - base));
  // Query tile it goes into stage it % NS of the ring; the parity of that
  // stage's use is the phase its barriers wait for (a stage's first
  // empty wait, for parity 1, passes at once).
  auto stage = [](int it) { return (int)((uint32_t)it % NS); };
  auto use = [](int it) { return ((uint32_t)it / NS) & 1; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warpgroup, read from lane 0 so that the compiler knows that it is
  // the same across the warp (flash_fwd.cu's wgmma route says why).
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  // Under causality the first KV tiles see the most query tiles; they
  // are scheduled first.
  int kvh, k0;
  if constexpr (Tl::HEADS_FIRST) {
    kvh = blockIdx.x % KVH;
    k0 = blockIdx.x / KVH * BKV;
  } else {
    kvh = blockIdx.y;
    k0 = blockIdx.x * BKV;
  }
  // The transpose of _run_window, as in the instances.
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BKV - 1 + window);
  }
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;  // per query head
  const int n_it = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      // the copies' thread and the 32 lanes that store lse and delta
      mbar_init(q_full + 8 * s, 33);
      mbar_init(q_empty + 8 * s, 8);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer warpgroup. Its thread 0 issues every copy, box by box:
    // K and V once, then Q and dO of each query tile (head it / n_qt of
    // the group) into the ring; its warp 1 stores the tile's lse (times
    // log2 e) and delta beside them.
    setmaxnreg_dec<Tl::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * G::KV_BYTES);
      for (int b = 0; b < G::BOXES; ++b) {
        tma_load_3d(sk + b * G::KV_BOX, &tk, kv_full, b * TMA_COLS, kvh, k0);
        tma_load_3d(sv + b * G::KV_BOX, &tv, kv_full, b * TMA_COLS, kvh, k0);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = stage(it);
        const int h = kvh * group + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * BQ;
        const uint32_t dst = sq + s * G::STAGE;
        mbar_wait(q_empty + 8 * s, use(it) ^ 1);
        mbar_expect_tx(q_full + 8 * s, G::STAGE);
        for (int b = 0; b < G::BOXES; ++b) {
          tma_load_3d(dst + b * G::Q_BOX, &tq, q_full + 8 * s, b * TMA_COLS,
                      h, q0);
          tma_load_3d(dst + G::Q_BYTES + b * G::Q_BOX, &tdo, q_full + 8 * s,
                      b * TMA_COLS, h, q0);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = stage(it);
        const int h = kvh * group + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * BQ;
        float* const dst = lse_delta + 2 * BQ * s;
        mbar_wait(q_empty + 8 * s, use(it) ^ 1);
        for (int i = lane; i < BQ; i += 32) {
          const int qi = q0 + i;
          const bool in = qi < S;
          dst[i] = in ? lse[(long long)h * S + qi] * LOG2E : 0.f;
          dst[BQ + i] = in ? delta[(long long)h * S + qi] : 0.f;
        }
        mbar_arrive(q_full + 8 * s);
      }
    }
  } else {
    // A consumer warpgroup: KV rows k0w.. (64 of them), the warp's 16 from
    // 16 wq.
    setmaxnreg_inc<Tl::CONSUMER_REGS>();
    const int wq = warp & 3, cw = wg - 1;
    const int k0w = k0 + 64 * cw;
    const int g = lane >> 2, t = lane & 3;
    // Descriptors of the warpgroup's K and V rows (A, K-major), of stage
    // 0's Q and dO as the B of the score products (K-major) and as the B
    // of P^T dO and dS^T Q (MN-major: their rows are the depth, their
    // boxes of 64 columns G::Q_BOX apart); a box, a 16-deep step and a
    // stage are offsets added to them (16-byte units).
    const uint64_t da_k = sw128_desc(sk + cw * 64 * G::ROW, 16, 1024);
    const uint64_t da_v = sw128_desc(sv + cw * 64 * G::ROW, 16, 1024);
    const uint64_t db_q = sw128_desc(sq, 16, 1024);
    const uint64_t db_do = sw128_desc(sq + G::Q_BYTES, 16, 1024);
    const uint64_t db_qt = sw128_desc(sq, G::Q_BOX, 1024);
    const uint64_t db_dot = sw128_desc(sq + G::Q_BYTES, G::Q_BOX, 1024);
    float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
    const float scale_log2 = scale * LOG2E;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = stage(it);
      const int q0 = q_begin + (it % n_qt) * BQ;
      const uint32_t off = st * (G::STAGE >> 4);
      // No key of the warpgroup is seen by any row of the tile: every row
      // before the keys, or past the window of the last key, or keys past
      // S.
      const bool skip =
          k0w >= S ||
          (causal && (q0 + BQ - 1 < k0w ||
                      (window > 0 && q0 - (k0w + 63) >= window)));
      // Some entry of the warpgroup's keys against the tile is masked.
      const bool masked =
          q0 + BQ > S || k0w + 64 > S ||
          (causal && (q0 < k0w + 63 ||
                      (window > 0 && q0 + BQ - 1 - k0w >= window)));
      mbar_wait(q_full + 8 * st, use(it));
      if constexpr (Tl::SPLIT) {
        // With Tl::SPLIT, the products of one query tile in stage st (offset
        // off) at query row q0: S^T = K Q^T and dP^T = V dO^T in two commit
        // groups (DP / 16 steps of depth 16 each: 4 a box, 32 bytes apart
        // inside the swizzle atom), P^T = 2^(S^T scale log2 e - lse log2 e)
        // (masked entries 0) formed in place of S^T while dP^T runs, dS^T =
        // P^T o (dP^T - delta) in place of dP^T (the accumulators' columns are
        // the tile's query rows), both packed to the input's type as A
        // fragments (16 query rows a step), then dV += P^T dO and dK += dS^T Q
        // (dO's and Q's rows the depth: 16 rows, 2048 bytes a step). MASKED:
        // whether the tile has a masked entry, decided by the caller, so that
        // no branch on it sits between a product and its wait. (Defined
        // here, not for the head_dim-64 template too: there the unused
        // lambda made its loop 2% slower on an H100, kernel_ab.py.)
        auto tile = [&](auto masked) {
          const float* const cl = lse_delta + 2 * BQ * st;
          const float* const cd = cl + BQ;
          float s[NJ][4], dp[NJ][4];
          uint32_t ap[NJ / 2][4], ad[NJ / 2][4];
          fence_regs(s);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<T>(s, da_k + ((b * G::KV_BOX + kk * 32) >> 4),
                          db_q + off + ((b * G::Q_BOX + kk * 32) >> 4),
                          b | kk);
          wgmma_commit();
#pragma unroll
          for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<T>(dp, da_v + ((b * G::KV_BOX + kk * 32) >> 4),
                          db_do + off + ((b * G::Q_BOX + kk * 32) >> 4),
                          b | kk);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              const float p = ex2(fmaf(s[j][e], scale_log2, -cl[col]));
              if constexpr (decltype(masked)::value)
                s[j][e] = keep(q0 + col, k0w + 16 * wq + g + 8 * (e >> 1), S,
                               causal, window)
                              ? p
                              : 0.f;
              else
                s[j][e] = p;
            }
#pragma unroll
          for (int kk = 0; kk < NJ / 2; ++kk) {
            ap[kk][0] = pack16<T>(s[2 * kk][0], s[2 * kk][1]);
            ap[kk][1] = pack16<T>(s[2 * kk][2], s[2 * kk][3]);
            ap[kk][2] = pack16<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            ap[kk][3] = pack16<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          }
          wgmma_wait<0>();
          fence_regs(dp);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[j][e] = s[j][e] * (dp[j][e] - cd[8 * j + 2 * t + (e & 1)]);
#pragma unroll
          for (int kk = 0; kk < NJ / 2; ++kk) {
            ad[kk][0] = pack16<T>(dp[2 * kk][0], dp[2 * kk][1]);
            ad[kk][1] = pack16<T>(dp[2 * kk][2], dp[2 * kk][3]);
            ad[kk][2] = pack16<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
            ad[kk][3] = pack16<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
          }
          fence_regs(acc_v);
          fence_regs(acc_k);
          fence_regs(ap);
          fence_regs(ad);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NJ / 2; ++kk)
            wgmma_rs<T, ND>(acc_v, ap[kk],
                            db_dot + off + ((kk * 16 * G::ROW) >> 4), 1);
#pragma unroll
          for (int kk = 0; kk < NJ / 2; ++kk)
            wgmma_rs<T, ND>(acc_k, ad[kk],
                            db_qt + off + ((kk * 16 * G::ROW) >> 4), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc_v);
          fence_regs(acc_k);
          fence_regs(ap);
          fence_regs(ad);
        };
        if (!skip) {
          if (masked)
            tile(std::true_type{});
          else
            tile(std::false_type{});
        }
      } else if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T, DP / 16 steps of depth 16 each:
        // 4 a box, 32 bytes apart inside the swizzle atom.
        float s[NJ][4], dp[NJ][4];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<T>(s, da_k + ((b * G::KV_BOX + kk * 32) >> 4),
                        db_q + off + ((b * G::Q_BOX + kk * 32) >> 4),
                        b | kk);
#pragma unroll
        for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<T>(dp, da_v + ((b * G::KV_BOX + kk * 32) >> 4),
                        db_do + off + ((b * G::Q_BOX + kk * 32) >> 4),
                        b | kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // P^T = 2^(S^T scale log2 e - lse log2 e) (masked entries 0) in
        // place of S^T, dS^T = P^T o (dP^T - delta) in place of dP^T; the
        // accumulators' columns are the tile's query rows.
        const float* const cl = lse_delta + 2 * BQ * st;
        const float* const cd = cl + BQ;
        if (masked) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              const int kj = k0w + 16 * wq + g + 8 * (e >> 1);
              const float p =
                  keep(q0 + col, kj, S, causal, window)
                      ? ex2(fmaf(s[j][e], scale_log2, -cl[col]))
                      : 0.f;
              s[j][e] = p;
              dp[j][e] = p * (dp[j][e] - cd[col]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              const float p = ex2(fmaf(s[j][e], scale_log2, -cl[col]));
              s[j][e] = p;
              dp[j][e] = p * (dp[j][e] - cd[col]);
            }
        }
        // P^T and dS^T as A fragments of the input's type, 16 query rows
        // a step; then dV += P^T dO and dK += dS^T Q, dO's and Q's rows
        // the depth (16 rows, 2048 bytes a step).
        uint32_t ap[NJ / 2][4], ad[NJ / 2][4];
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
          ap[kk][0] = pack16<T>(s[2 * kk][0], s[2 * kk][1]);
          ap[kk][1] = pack16<T>(s[2 * kk][2], s[2 * kk][3]);
          ap[kk][2] = pack16<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          ap[kk][3] = pack16<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          ad[kk][0] = pack16<T>(dp[2 * kk][0], dp[2 * kk][1]);
          ad[kk][1] = pack16<T>(dp[2 * kk][2], dp[2 * kk][3]);
          ad[kk][2] = pack16<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          ad[kk][3] = pack16<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        }
        fence_regs(acc_v);
        fence_regs(acc_k);
        fence_regs(ap);
        fence_regs(ad);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk)
          wgmma_rs<T, ND>(acc_v, ap[kk],
                          db_dot + off + ((kk * 16 * G::ROW) >> 4), 1);
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk)
          wgmma_rs<T, ND>(acc_k, ad[kk],
                          db_qt + off + ((kk * 16 * G::ROW) >> 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
        fence_regs(ap);
        fence_regs(ad);
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * st);
    }

    // dk = scale * acc_k and dv = acc_v in k's type, two columns a 32-bit
    // store (head_dim is a whole number of 8-column units on this route).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = k0w + 16 * wq + g + 8 * r;
      if (kj >= S) continue;
      const long long at = ((long long)kj * KVH + kvh) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < D) {
          *reinterpret_cast<uint32_t*>(dk + at + col) = pack16<T>(
              acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at + col) =
              pack16<T>(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
        }
      }
    }
  }
}

// The wgmma route's body at head_dim 129-256 (DP 256; inlined into
// flash_bwd_dkv_wgmma_kernel, below). dK and dV over 256 columns for 64
// keys are 128 f32 accumulator registers a thread each, so no consumer
// holds both: one block of three warpgroups owns one (KV head, 64-key
// tile), and both consumers own all 64 keys. Consumer A computes S^T = K
// Q^T, forms P^T, hands it to consumer B through shared memory (f32, each
// thread's fragment as whole float4s, under the P^T full and empty
// mbarriers) and holds dV += P^T dO; consumer B computes dP^T = V dO^T,
// forms dS^T = P^T o (dP^T - delta) from A's P^T and holds dK += dS^T Q.
// Each score product is thus computed once a (KV tile, query tile), and
// the two consumers' products are of one size, so they stay in step: B's
// dS^T waits for A's P^T, and A's next S^T for B's read of it. The block
// takes the query heads [rank group / parts, (rank + 1) group / parts) of
// its GQA group, where parts is the size of its thread-block cluster
// (dkv_parts(); 1 in a launch without clusters) and rank its place there;
// the parts sum their f32 partial dk and dv through distributed shared
// memory in rank order, as the 256 instance's do (its comment says how),
// so that two launches agree bit for bit with no atomics.
template <typename T>
__device__ __forceinline__ void dkv_wgmma_pairs(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int S, int KVH, int group, int D, int causal,
    int window, float scale) {
  constexpr int DP = 256;
  using G = Gmma<T, DP>;
  using Tl = GTile<DP>;
  static_assert(!Tl::SPLIT, "the consumers' schedule is their own");
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, NS = Tl::STAGES;
  constexpr int NJ = BQ / 8;             // 8-query score tiles
  constexpr int ND = DP / 8;             // 8-column tiles of dk or dv
  constexpr int CT = 128;                // threads of a consumer
  extern __shared__ __align__(16) unsigned char gsmem_raw[];
  // Shared-window addresses: K, V, the query-tile stages (Q, then dO),
  // lse and delta of each stage, P^T, the barriers.
  const uint32_t base = smem_addr(gsmem_raw);
  const uint32_t sk = (base + 1023) & ~1023u;
  const uint32_t sv = sk + G::KV_BYTES;
  const uint32_t sq = sv + G::KV_BYTES;
  const uint32_t slse = sq + NS * G::STAGE;
  const uint32_t spt = slse + NS * 2 * BQ * (int)sizeof(float);
  const uint32_t kv_full = spt + G::PT_BYTES;
  const uint32_t q_full = kv_full + 8, q_empty = q_full + 8 * NS;
  const uint32_t pt_full = q_empty + 8 * NS, pt_empty = pt_full + 8;
  float* const lse_delta =
      reinterpret_cast<float*>(gsmem_raw + (slse - base));
  // P^T: float4 j of consumer thread c at j * CT + c, the same entries in
  // A's S^T fragment and B's dP^T fragment
  float4* const pt = reinterpret_cast<float4*>(gsmem_raw + (spt - base));
  auto stage = [](int it) { return (int)((uint32_t)it % NS); };
  auto use = [](int it) { return ((uint32_t)it / NS) & 1; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warpgroup, read from lane 0 so that the compiler knows that it is
  // the same across the warp (flash_fwd.cu's wgmma route says why).
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  // The parts of one KV tile are neighbours in the grid (a cluster along
  // x); the KV heads vary fastest, and under causality the first KV
  // tiles, which see the most query tiles, are scheduled first.
  const int parts = (int)cluster_size();
  const int rank = blockIdx.x % parts;
  const int tile = blockIdx.x / parts;
  const int kvh = tile % KVH, k0 = tile / KVH * BKV;
  const int h_begin = rank * group / parts;
  const int n_heads = (rank + 1) * group / parts - h_begin;
  // The transpose of _run_window, as in the instances.
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BKV - 1 + window);
  }
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;  // per query head
  const int n_it = n_heads * n_qt;                   // at least 1
  // The tile's rows each part of the cluster sums (below).
  const int own = BKV / parts;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      // the copies' thread and the 32 lanes that store lse and delta
      mbar_init(q_full + 8 * s, 33);
      mbar_init(q_empty + 8 * s, 8);   // one arrival a consumer warp
    }
    mbar_init(pt_full, CT);            // every thread of A
    mbar_init(pt_empty, CT);           // every thread of B
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer warpgroup, as in dkv_wgmma_tiles: K and V once, then Q
    // and dO of each query tile of the block's heads into the ring, and
    // the tile's lse (times log2 e) and delta beside them.
    setmaxnreg_dec<Tl::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * G::KV_BYTES);
      for (int b = 0; b < G::BOXES; ++b) {
        tma_load_3d(sk + b * G::KV_BOX, &tk, kv_full, b * TMA_COLS, kvh, k0);
        tma_load_3d(sv + b * G::KV_BOX, &tv, kv_full, b * TMA_COLS, kvh, k0);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = stage(it);
        const int h = kvh * group + h_begin + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * BQ;
        const uint32_t dst = sq + s * G::STAGE;
        mbar_wait(q_empty + 8 * s, use(it) ^ 1);
        mbar_expect_tx(q_full + 8 * s, G::STAGE);
        for (int b = 0; b < G::BOXES; ++b) {
          tma_load_3d(dst + b * G::Q_BOX, &tq, q_full + 8 * s, b * TMA_COLS,
                      h, q0);
          tma_load_3d(dst + G::Q_BYTES + b * G::Q_BOX, &tdo, q_full + 8 * s,
                      b * TMA_COLS, h, q0);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = stage(it);
        const int h = kvh * group + h_begin + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * BQ;
        float* const dst = lse_delta + 2 * BQ * s;
        mbar_wait(q_empty + 8 * s, use(it) ^ 1);
        for (int i = lane; i < BQ; i += 32) {
          const int qi = q0 + i;
          const bool in = qi < S;
          dst[i] = in ? lse[(long long)h * S + qi] * LOG2E : 0.f;
          dst[BQ + i] = in ? delta[(long long)h * S + qi] : 0.f;
        }
        mbar_arrive(q_full + 8 * s);
      }
    }
    // The consumers' two cluster barriers around the parts' sum.
    if (parts > 1) {
      cluster_sync();
      cluster_sync();
    }
  } else {
    // A consumer warpgroup: A (wg 1) or B (wg 2); the warp's 16 keys from
    // 16 wq, its thread c of the warpgroup's CT.
    setmaxnreg_inc<Tl::CONSUMER_REGS>();
    const bool is_b = wg == 2;
    const int wq = warp & 3, c = threadIdx.x - CT * wg;
    const int g = lane >> 2, t = lane & 3;
    // Descriptors of K (A) or V (B) as the A of the score product
    // (K-major), of stage 0's Q (A) or dO (B) as its B (K-major), and of
    // stage 0's dO (A) or Q (B) as the B of dV += P^T dO or dK += dS^T Q
    // (MN-major: their rows are the depth, their boxes of 64 columns
    // G::Q_BOX apart); a box, a 16-deep step and a stage are offsets
    // added to them (16-byte units).
    const uint64_t da = sw128_desc(is_b ? sv : sk, 16, 1024);
    const uint64_t db = sw128_desc(sq + (is_b ? G::Q_BYTES : 0), 16, 1024);
    const uint64_t db_t =
        sw128_desc(sq + (is_b ? 0 : G::Q_BYTES), G::Q_BOX, 1024);
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const float scale_log2 = scale * LOG2E;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = stage(it);
      const int q0 = q_begin + (it % n_qt) * BQ;
      const uint32_t off = st * (G::STAGE >> 4);
      const uint32_t ph = (uint32_t)it & 1;   // P^T's phase
      // Some entry of the keys against the tile is masked (every tile
      // the loop visits has one that is not).
      const bool masked =
          q0 + BQ > S || k0 + BKV > S ||
          (causal && (q0 < k0 + BKV - 1 ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window)));
      const float* const cl = lse_delta + 2 * BQ * st;
      const float* const cd = cl + BQ;
      mbar_wait(q_full + 8 * st, use(it));
      // S^T = K Q^T (A) or dP^T = V dO^T (B), DP / 16 steps of depth 16
      // each: 4 a box, 32 bytes apart inside the swizzle atom. The
      // accumulators' columns are the tile's query rows.
      float x[NJ][4];
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < G::BOXES; ++b)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T>(x, da + ((b * G::KV_BOX + kk * 32) >> 4),
                      db + off + ((b * G::Q_BOX + kk * 32) >> 4), b | kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      if (!is_b) {
        // P^T = 2^(S^T scale log2 e - lse log2 e), masked entries 0, in
        // place of S^T; then to B, once B has read the previous tile's.
        if (masked) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              const float p = ex2(fmaf(x[j][e], scale_log2, -cl[col]));
              x[j][e] = keep(q0 + col, k0 + 16 * wq + g + 8 * (e >> 1), S,
                             causal, window)
                            ? p
                            : 0.f;
            }
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              x[j][e] = ex2(fmaf(x[j][e], scale_log2, -cl[col]));
            }
        }
        mbar_wait(pt_empty, ph ^ 1);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          pt[j * CT + c] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
        mbar_arrive(pt_full);
      } else {
        // dS^T = P^T o (dP^T - delta) in place of dP^T, once A's P^T is
        // in; then the buffer back to A.
        mbar_wait(pt_full, ph);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 p = pt[j * CT + c];
          const float* const dl = cd + 8 * j + 2 * t;
          x[j][0] = p.x * (x[j][0] - dl[0]);
          x[j][1] = p.y * (x[j][1] - dl[1]);
          x[j][2] = p.z * (x[j][2] - dl[0]);
          x[j][3] = p.w * (x[j][3] - dl[1]);
        }
        mbar_arrive(pt_empty);
      }
      // P^T (A) or dS^T (B) as A fragments of the input's type, 16 query
      // rows a step; then dV += P^T dO or dK += dS^T Q, dO's and Q's rows
      // the depth (16 rows, 2048 bytes a step).
      uint32_t a[NJ / 2][4];
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        a[kk][0] = pack16<T>(x[2 * kk][0], x[2 * kk][1]);
        a[kk][1] = pack16<T>(x[2 * kk][2], x[2 * kk][3]);
        a[kk][2] = pack16<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
        a[kk][3] = pack16<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
      }
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk)
        wgmma_rs<T, ND>(acc, a[kk], db_t + off + ((kk * 16 * G::ROW) >> 4),
                        1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      if (lane == 0) mbar_arrive(q_empty + 8 * st);
    }

    // dk = scale * acc (B) and dv = acc (A) in k's type, two columns a
    // 32-bit store (head_dim is a whole number of 8-column units on this
    // route).
    T* const out = is_b ? dk : dv;
    const float f = is_b ? scale : 1.f;
    if (parts == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k0 + 16 * wq + g + 8 * r;
        if (kj >= S) continue;
        T* const row = out + ((long long)kj * KVH + kvh) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = 8 * n + 2 * t;
          if (col < D)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack16<T>(acc[n][2 * r] * f, acc[n][2 * r + 1] * f);
        }
      }
    } else {
      // The cluster's sum of the parts' partial dv and dk: block r owns
      // rows [r own, r own + own) of the tile; xr (over the tiles' shared
      // memory) holds dv's then dk's receive rows, row r own + lr of each
      // being block r's partial of owned row lr.
      constexpr int LR = DP + X_PAD;
      float* const xr = reinterpret_cast<float*>(gsmem_raw + (sk - base));
      // Every block of the cluster is done with its tiles' shared memory.
      cluster_sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wq + g + 8 * h;
        const int o = row / own;
        const int xrow = (is_b ? BKV : 0) + rank * own + row - o * own;
        const uint32_t at = peer_addr(xr + xrow * LR + 2 * t, o);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          st_peer(at + 32 * n, acc[n][2 * h], acc[n][2 * h + 1]);
      }
      // Every part's rows are in their owners' buffers.
      cluster_sync();
      for (int i = threadIdx.x - CT; i < 2 * own * (DP / 4); i += 2 * CT) {
        const int m = i / (own * (DP / 4));      // 0: dv, 1: dk
        const int lr = i / (DP / 4) % own, col = i % (DP / 4) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < parts; ++r)
          add4(sum, *reinterpret_cast<const float4*>(
                        xr + (m * BKV + r * own + lr) * LR + col));
        const int kj = k0 + rank * own + lr;
        if (kj >= S || col >= D) continue;
        const float fm = m ? scale : 1.f;
        *reinterpret_cast<uint2*>((m ? dk : dv) +
                                  ((long long)kj * KVH + kvh) * D + col) =
            make_uint2(pack16<T>(sum.x * fm, sum.y * fm),
                       pack16<T>(sum.z * fm, sum.w * fm));
      }
    }
  }
}

// The wgmma route's kernel: dkv_wgmma_tiles at head_dim 33-128,
// dkv_wgmma_pairs at 129-256.
template <typename T, int DP>
__global__ void __launch_bounds__(GTile<DP>::NT, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int S,
                           int KVH, int group, int D, int causal, int window,
                           float scale) {
  if constexpr (DP == 256)
    dkv_wgmma_pairs<T>(tq, tk, tv, tdo, lse, delta, dk, dv, S, KVH, group,
                       D, causal, window, scale);
  else
    dkv_wgmma_tiles<T, DP>(tq, tk, tv, tdo, lse, delta, dk, dv, S, KVH,
                           group, D, causal, window, scale);
}

// Dynamic shared memory of one block of the 256 instance: K and V, the
// query-tile buffers (Q, dO, lse, delta) and P^T (f32) while the block
// loops; then, where parts of a cluster sum their partials, the receive
// buffers of dv and dk (f32, 64 rows each) in the same bytes.
template <typename T, int DP>
__host__ __device__ constexpr int split_smem_bytes() {
  constexpr int BQ = split_q_tile<T>();
  constexpr int NB = split_q_bufs<T>();
  constexpr int loop = (2 * BKV + 2 * NB * BQ) * (DP + Pad<T>::value) *
                           (int)sizeof(T) +
                       2 * NB * BQ * (int)sizeof(float) +
                       BKV * (BQ + X_PAD) * (int)sizeof(float);
  constexpr int sum = 2 * BKV * (DP + X_PAD) * (int)sizeof(float);
  return loop > sum ? loop : sum;
}

// The 256 instance (head_dim 129-256; the file's header says why): one
// block of 8 warps owns the (KV head, 64-row KV tile) and every output
// column, for the query heads [rank group / parts, (rank + 1) group /
// parts) of its GQA group, where rank is its place among the `parts`
// blocks of the tile's cluster. Warps 0-3 (group A) compute S^T and P^T
// and hold dv, warps 4-7 (group B) dP^T and dS^T and hold dk, 16 KV rows
// a warp in each group.
template <typename T, int DP>
__global__ void __launch_bounds__(SPLIT_NT, 1)
flash_bwd_dkv_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int S,
                           int KVH, int group, int D, Strides st, int vec,
                           int causal, int window, float scale,
                           int parts) {
  constexpr int BQ = split_q_tile<T>();
  constexpr int NB = split_q_bufs<T>();
  constexpr int NJ = BQ / 8;        // 8-column score tiles per warp
  constexpr int ND = DP / 8;        // 8-column accumulator tiles
  constexpr int LD = DP + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);     // BKV x LD
  T* sv = sk + BKV * LD;                      // BKV x LD
  T* sq = sv + BKV * LD;                      // NB buffers of BQ x LD
  T* sdo = sq + NB * BQ * LD;                 // NB buffers of BQ x LD
  float* slse = reinterpret_cast<float*>(sdo + NB * BQ * LD);  // NB x BQ
  float* sdelta = slse + NB * BQ;                              // NB x BQ
  float* fp = sdelta + NB * BQ;               // P^T, BKV x (BQ + X_PAD)

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp % WARPS) * 16;       // the warp's first KV row
  const bool is_b = warp >= WARPS;            // dP^T, dS^T and dk
  const int kvh = blockIdx.y;
  // The parts of one KV tile are neighbours in the grid (a cluster along
  // x); under causality the first KV tiles see the most query tiles and
  // are scheduled first.
  const int rank = blockIdx.x % parts;
  const int k0 = blockIdx.x / parts * BKV;
  const int h_begin = rank * group / parts;
  const int n_heads = (rank + 1) * group / parts - h_begin;

  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BKV - 1 + window);
  }
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;  // per query head
  const int n_it = n_heads * n_qt;                   // at least 1

  // Stages query tile `it` (head h_begin + it / n_qt of the group) into
  // buffer it % NB.
  auto stage = [&](int it) {
    const int h = kvh * group + h_begin + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * BQ;
    const int b = it % NB;
    load_tile<T, DP, BQ, SPLIT_NT>(sq + b * BQ * LD, q + h * st.q_sh, q0, S,
                                   D, st.q_ss, vec & VEC_Q);
    load_tile<T, DP, BQ, SPLIT_NT>(sdo + b * BQ * LD, dout + h * st.do_sh,
                                   q0, S, D, st.do_ss, vec & VEC_DO);
    for (int i = threadIdx.x; i < 2 * BQ; i += SPLIT_NT) {
      const bool is_delta = i >= BQ;
      const int c = is_delta ? i - BQ : i;
      const float* row = (is_delta ? delta : lse) + (long long)h * S;
      float* dst = (is_delta ? sdelta : slse) + b * BQ + c;
      const bool ok = q0 + c < S;
      cp_async4(dst, ok ? row + q0 + c : row, ok ? 4 : 0);
    }
  };

  load_tile<T, DP, BKV, SPLIT_NT>(sk, k + kvh * st.k_sh, k0, S, D, st.k_ss,
                                  vec & VEC_K);
  load_tile<T, DP, BKV, SPLIT_NT>(sv, v + kvh * st.v_sh, k0, S, D, st.v_ss,
                                  vec & VEC_V);
  stage(0);
  cp_async_commit();

  // One 16-row m-tile a warp: dv in group A, dk in group B.
  float acc[1][ND][4];
  zero(acc);
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1: its
    // query-tile buffer (which, with two buffers, the copy of tile it + 1
    // now overwrites) and its P^T.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (NB == 2) {
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
    }
    const int b = it % NB;
    const int q0 = q_begin + (it % n_qt) * BQ;
    const T* cq = sq + b * BQ * LD;
    const T* cdo = sdo + b * BQ * LD;

    // S^T = K Q^T (group A) or dP^T = V dO^T (group B), full depth.
    float x[1][NJ][4];
    abt<DP, 1, NJ>(x, is_b ? sv : sk, is_b ? cdo : cq, wrow, lane);
    if (!is_b) {
      // P^T = exp(S^T scale - lse), masked entries 0, for group B too.
      to_pt(x, slse + b * BQ,
            tile_masked<BQ, BKV>(q0, k0, S, causal, window), q0, k0, wrow,
            lane, S, causal, window, scale_log2);
      scatter_rows(fp, x, wrow, lane);
      bar_arrive(1, SPLIT_NT);
    } else {
      // dS^T = P^T o (dP^T - delta), once group A's P^T is in.
      bar_sync(1, SPLIT_NT);
      to_dst_shared(x, fp, sdelta + b * BQ, wrow, lane);
    }
    // dV += P^T dO (group A), dK += dS^T Q (group B); f32 two
    // accumulator tiles a pass, since four spilled beside the 128
    // accumulator registers.
    if constexpr (sizeof(T) == 4)
      add_xb<DP, 1, NJ, DP, 2>(acc, x, is_b ? cq : cdo, lane);
    else
      add_xb<DP, 1, NJ>(acc, x, is_b ? cq : cdo, lane);
    if constexpr (NB == 1) {
      __syncthreads();              // every warp is done with the buffer
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
    }
  }

  // dk = scale * acc (group B), dv = acc (group A).
  if (parts == 1) {
    T* out = is_b ? dk : dv;
    const float f = is_b ? scale : 1.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + wrow + g + (e >> 1) * 8;
        const int col = n * 8 + 2 * t + (e & 1);
        if (kj < S && col < D)
          store(out + ((long long)kj * KVH + kvh) * D + col, acc[0][n][e] * f);
      }
    return;
  }

  // The cluster's sum of the parts' partial dv and dk: block r owns rows
  // [r own, r own + own) of the tile; xr holds dv's then dk's receive
  // rows, row r own + lr of each being block r's partial of owned row lr.
  constexpr int LR = DP + X_PAD;
  float* xr = reinterpret_cast<float*>(smem_raw);
  const int own = BKV / parts;
  // Every block of the cluster is done with its tiles' shared memory.
  cluster_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    const int o = row / own;
    const uint32_t base = peer_addr(
        xr + ((is_b ? BKV : 0) + rank * own + row - o * own) * LR + 2 * t, o);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      st_peer(base + 32 * n, acc[0][n][2 * h], acc[0][n][2 * h + 1]);
  }
  // Every part's rows are in their owners' buffers.
  cluster_sync();
  for (int i = threadIdx.x; i < 2 * own * (DP / 4); i += SPLIT_NT) {
    const int m = i / (own * (DP / 4));      // 0: dv, 1: dk
    const int lr = i / (DP / 4) % own, c = i % (DP / 4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < parts; ++r)
      add4(sum, *reinterpret_cast<const float4*>(
                    xr + (m * BKV + r * own + lr) * LR + c));
    const int kj = k0 + rank * own + lr;
    if (kj >= S) continue;
    T* row = (m ? dk : dv) + ((long long)kj * KVH + kvh) * D;
    const float fm = m ? scale : 1.f;
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < D) store(row + c + e, s4[e] * fm);
  }
}

// The streamed route's kernel (head_dim above 1024; the file's header
// says why): one block of 4 warps owns one 128-column slice of dv, or of dk,
// for one (KV head, 64-row KV tile), 16 KV rows a warp. Per 32-row query
// tile it streams the depth of S^T = K Q^T, and for dk of dP^T = V dO^T,
// through shared memory, DC columns of K and Q (and V and dO) at a time,
// then stages the tile's dO slice (dv) or Q slice (dk) with its lse and
// delta and adds P^T dO or dS^T Q to its 128-column accumulator. Every
// stage (a chunk, or a slice) goes into one of two buffers by cp.async
// while the other one computes.
template <typename T, int DC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_stream_kernel(const T* __restrict__ q,
                            const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int S,
                            int KVH, int group, int D, Strides st, int vec,
                            int causal, int window, float scale) {
  constexpr int BQ = W_QROWS;
  constexpr int NJ = BQ / 8;            // 8-column score tiles per warp
  constexpr int ND = W_COLS / 8;        // 8-column accumulator tiles
  constexpr int LDC = DC + Pad<T>::value;   // row stride of a chunk tile
  constexpr int LDS = W_COLS + Pad<T>::value;   // row stride of a slice
  constexpr int BUF = stream_buf_bytes<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;   // the warp's first KV row
  const int kvh = blockIdx.y;
  // blockIdx.x = 2 (tile n_slices + slice) + is_dk: the dv and dk blocks
  // of one KV tile's slices are neighbours in the grid; the first KV
  // tiles, which see the most query tiles under causality, come first.
  const bool is_dk = blockIdx.x & 1;
  const int n_slices = (D + W_COLS - 1) / W_COLS;
  const int col0 = (blockIdx.x / 2 % n_slices) * W_COLS;
  const int k0 = blockIdx.x / 2 / n_slices * BKV;

  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BKV - 1 + window);
  }
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;  // per query head
  const int n_it = group * n_qt;
  const int n_chunks = (D + DC - 1) / DC;
  const int per_tile = n_chunks + 1;    // stages a query tile
  const int n_st = n_it * per_tile;

  // Stages `u` into buffer u & 1: chunk c of K and Q, and for dk of V and
  // dO (BKV, BQ, BKV and BQ rows, LDC apart), or the dO slice (dv) or Q
  // slice (dk), BQ rows LDS apart, followed by BQ floats each of lse and
  // delta.
  auto stage = [&](int u) {
    const int it = u / per_tile, c = u % per_tile;
    const int h = kvh * group + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * BQ;
    T* b = reinterpret_cast<T*>(smem_raw + (u & 1) * BUF);
    if (c < n_chunks) {
      const int c0 = c * DC;
      load_tile<T, DC, BKV, NT>(b, k + kvh * st.k_sh + c0, k0, S, D - c0,
                                st.k_ss, vec & VEC_K);
      load_tile<T, DC, BQ, NT>(b + BKV * LDC, q + h * st.q_sh + c0, q0, S,
                               D - c0, st.q_ss, vec & VEC_Q);
      if (is_dk) {
        load_tile<T, DC, BKV, NT>(b + (BKV + BQ) * LDC,
                                  v + kvh * st.v_sh + c0, k0, S, D - c0,
                                  st.v_ss, vec & VEC_V);
        load_tile<T, DC, BQ, NT>(b + (2 * BKV + BQ) * LDC,
                                 dout + h * st.do_sh + c0, q0, S, D - c0,
                                 st.do_ss, vec & VEC_DO);
      }
    } else {
      if (is_dk)
        load_tile<T, W_COLS, BQ, NT>(b, q + h * st.q_sh + col0, q0, S,
                                     D - col0, st.q_ss, vec & VEC_Q);
      else
        load_tile<T, W_COLS, BQ, NT>(b, dout + h * st.do_sh + col0, q0, S,
                                     D - col0, st.do_ss, vec & VEC_DO);
      float* stats = reinterpret_cast<float*>(b + BQ * LDS);
      for (int i = threadIdx.x; i < 2 * BQ; i += NT) {
        const bool is_delta = i >= BQ;
        const int r = is_delta ? i - BQ : i;
        const float* row = (is_delta ? delta : lse) + (long long)h * S;
        const bool ok = q0 + r < S;
        cp_async4(stats + i, ok ? row + q0 + r : row, ok ? 4 : 0);
      }
    }
  };

  if (n_st > 0) stage(0);
  cp_async_commit();

  // One 16-row m-tile a warp (the [1] of every fragment array).
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
    const T* b = reinterpret_cast<const T*>(smem_raw + (u & 1) * BUF);
    const int it = u / per_tile, c = u % per_tile;
    if (c < n_chunks) {
      if (c == 0) {
        zero(p);
        zero(ds);
      }
      abt<DC, 1, NJ, true>(p, b, b + BKV * LDC, wrow, lane);
      if (is_dk)
        abt<DC, 1, NJ, true>(ds, b + (BKV + BQ) * LDC,
                             b + (2 * BKV + BQ) * LDC, wrow, lane);
    } else {
      const int q0 = q_begin + (it % n_qt) * BQ;
      const float* clse = reinterpret_cast<const float*>(b + BQ * LDS);
      to_pt(p, clse, tile_masked<BQ, BKV>(q0, k0, S, causal, window), q0,
            k0, wrow, lane, S, causal, window, scale_log2);
      if (is_dk) {
        to_dst(ds, p, clse + BQ, lane);
        add_xb<W_COLS, 1, NJ>(acc, ds, b, lane);
      } else {
        add_xb<W_COLS, 1, NJ>(acc, p, b, lane);
      }
    }
  }

  // dk = scale * acc, dv = acc: the warp's KV rows, columns col0 + 8 ND
  // of them (those below D).
  T* out = is_dk ? dk : dv;
  const float f = is_dk ? scale : 1.f;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + wrow + g + (e >> 1) * 8;
      const int col = col0 + n * 8 + 2 * t + (e & 1);
      if (kj < S && col < D)
        store(out + ((long long)kj * KVH + kvh) * D + col, acc[0][n][e] * f);
    }
}

// The wide route's kernel (head_dim 257-1024; the file's header says
// why): a cluster of n = ceil(D / 128) blocks owns one (KV head, 64-row
// KV tile), 16 KV rows a warp; block r (its rank in the cluster) owns
// dk's and dv's columns [128 r, 128 r + 128) and holds those columns of
// K and V (staged once) and of each query tile's Q and dO (two cp.async
// stages, with the tile's lse and delta). Per query tile: the partial
// S^T and dP^T over the block's 128 columns of depth, the cluster's sum
// of them into P^T and dS^T (cluster_sm90.cuh), then dV += P^T dO and
// dK += dS^T Q on the block's slices. A 16-bit block's 4 warps do both
// halves of the work for their rows; an f32 block's 8 warps split them
// (wide_threads()).
template <typename T, int BQ>
__global__ void
__launch_bounds__((wide_threads<T>()), (wide_min_blocks<T>()))
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          int KVH, int group, int D, Strides st, int vec,
                          int causal, int window, float scale) {
  constexpr int NTB = wide_threads<T>();
  constexpr bool SPLIT = NTB > NT;      // the f32 warps split the work
  constexpr int NACC = SPLIT ? 1 : 2;   // accumulators a thread
  constexpr int NJ = BQ / 8;            // 8-column score tiles per warp
  constexpr int ND = W_COLS / 8;        // 8-column accumulator tiles
  constexpr int LD = W_COLS + Pad<T>::value;
  constexpr int LX = BQ + X_PAD;        // row stride of the tile buffers
  constexpr int STAGE = wide_stage_bytes<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);     // BKV x LD
  T* sv = sk + BKV * LD;                      // BKV x LD
  unsigned char* stages = reinterpret_cast<unsigned char*>(sv + BKV * LD);
  // receive buffers of the partial S^T and dP^T, recv_rows() x LX each
  float* xs = reinterpret_cast<float*>(stages + 2 * STAGE);
  float* xdp = xs + recv_rows() * LX;
  T* fp = reinterpret_cast<T*>(xdp + recv_rows() * LX);   // BKV x LX
  T* fds = fp + BKV * LX;                                  // BKV x LX

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp % WARPS) * 16;       // the warp's first KV row
  // The warp's share: m = 0 is S^T, P^T and dv, m = 1 dP^T, dS^T and dk;
  // a 16-bit warp takes both.
  const int m_first = SPLIT ? warp / WARPS : 0;
  const int m_end = SPLIT ? m_first + 1 : 2;
  const int kvh = blockIdx.y;
  const int n = (D + W_COLS - 1) / W_COLS;    // blocks of the cluster
  const int rank = cluster_rank();
  const int col0 = rank * W_COLS;
  // Under causality the first KV tiles see the most query tiles; their
  // clusters come first.
  const int k0 = blockIdx.x / n * BKV;
  // The tile rows whose P^T and dS^T this block finishes.
  const int own = own_rows(n);
  const int row0 = rank * own;
  const int n_own = max(0, min(own, BKV - row0));

  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BKV - 1 + window);
  }
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;  // per query head
  const int n_it = group * n_qt;                     // at least 1

  // Stages the block's columns of query tile `it` (head it / n_qt of the
  // group), Q then dO, BQ rows LD apart, followed by BQ floats each of
  // lse and delta, into stage it & 1.
  auto stage = [&](int it) {
    const int h = kvh * group + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * BQ;
    T* b = reinterpret_cast<T*>(stages + (it & 1) * STAGE);
    load_tile<T, W_COLS, BQ, NTB>(b, q + h * st.q_sh + col0, q0, S,
                                  D - col0, st.q_ss, vec & VEC_Q);
    load_tile<T, W_COLS, BQ, NTB>(b + BQ * LD, dout + h * st.do_sh + col0,
                                  q0, S, D - col0, st.do_ss, vec & VEC_DO);
    float* stats = reinterpret_cast<float*>(b + 2 * BQ * LD);
    for (int i = threadIdx.x; i < 2 * BQ; i += NTB) {
      const bool is_delta = i >= BQ;
      const int r = is_delta ? i - BQ : i;
      const float* row = (is_delta ? delta : lse) + (long long)h * S;
      const bool ok = q0 + r < S;
      cp_async4(stats + i, ok ? row + q0 + r : row, ok ? 4 : 0);
    }
  };

  load_tile<T, W_COLS, BKV, NTB>(sk, k + kvh * st.k_sh + col0, k0, S,
                                 D - col0, st.k_ss, vec & VEC_K);
  load_tile<T, W_COLS, BKV, NTB>(sv, v + kvh * st.v_sh + col0, k0, S,
                                 D - col0, st.v_ss, vec & VEC_V);
  stage(0);
  cp_async_commit();

  // One 16-row m-tile a warp (the [1] of every fragment array); acc[0]
  // is dv, acc[1] dk (on f32, acc[0] is the warp's one output).
  float acc[NACC][1][ND][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a) zero(acc[a]);
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    // Tile `it` has landed, and every warp is done with tile it - 1, whose
    // stage the copy of tile it + 1 now overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();
    const int q0 = q_begin + (it % n_qt) * BQ;
    const T* cq = reinterpret_cast<const T*>(stages + (it & 1) * STAGE);
    const T* cdo = cq + BQ * LD;
    const float* clse = reinterpret_cast<const float*>(cdo + BQ * LD);
    const float* cdelta = clse + BQ;
    // The partial S^T = K Q^T and dP^T = V dO^T over this block's
    // columns, each stored before the next is computed (registers).
#pragma unroll
    for (int m = m_first; m < m_end; ++m) {
      float part[1][NJ][4];
      abt<W_COLS, 1, NJ>(part, m ? sv : sk, m ? cdo : cq, wrow, lane);
      push_partial(m ? xdp : xs, part, wrow, rank, n, lane);
    }
    // Every block's partials are in their owners' buffers (and every
    // block is done reading the P^T and dS^T of tile it - 1).
    cluster_sync();
    // P^T = exp(S^T scale - lse) (masked entries 0) and dS^T = P^T o
    // (dP^T - delta) of the owned rows, packed to T, into every block.
    reduce_rows<BQ, NTB>(
        xs, xdp, n_own, n,
        [&](int lr, int c, const float4& s, const float4& dpt) {
          const int kj = k0 + row0 + lr;
          const float sv4[4] = {s.x, s.y, s.z, s.w};
          const float dv4[4] = {dpt.x, dpt.y, dpt.z, dpt.w};
          float pe[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c + e;
            pe[e] = keep(q0 + col, kj, S, causal, window)
                        ? ex2(fmaf(sv4[e], scale_log2, -clse[col] * LOG2E))
                        : 0.f;
            ds[e] = pe[e] * (dv4[e] - cdelta[col]);
          }
          bcast4(fp + (row0 + lr) * LX + c, pe, n);
          bcast4(fds + (row0 + lr) * LX + c, ds, n);
        });
    // The tile's P^T and dS^T are in every block (and every block is done
    // reading its partials).
    cluster_sync();
    // dV += P^T dO, dK += dS^T Q.
#pragma unroll
    for (int m = m_first; m < m_end; ++m) {
      float x[1][NJ][4];
      gather_rows(x, m ? fds : fp, wrow, lane);
      add_xb<W_COLS, 1, NJ>(acc[SPLIT ? 0 : m], x, m ? cq : cdo, lane);
    }
  }
  // No block leaves while a peer may still write into it.
  cluster_sync();

  // dk = scale * acc, dv = acc: the warp's KV rows, columns col0 + 8 ND
  // of them (those below D).
#pragma unroll
  for (int m = m_first; m < m_end; ++m) {
    T* out = m ? dk : dv;
    const float f = m ? scale : 1.f;
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + wrow + g + (e >> 1) * 8;
        const int col = col0 + nn * 8 + 2 * t + (e & 1);
        if (kj < S && col < D)
          store(out + ((long long)kj * KVH + kvh) * D + col,
                acc[SPLIT ? 0 : m][0][nn][e] * f);
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

// Dynamic shared memory of one block of an instance up to head_dim 128:
// K, V, two Q and two dO tiles, and two buffers each of lse and delta.
template <typename T, int DP>
constexpr int smem_bytes() {
  return (int)((2 * BKV + 4 * q_tile(DP)) * (DP + Pad<T>::value) *
                   sizeof(T) +
               4 * q_tile(DP) * sizeof(float));
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* const* p, int S, int H, int KVH, int D,
                       const Strides& st, int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BKV - 1) / BKV, KVH);
  flash_bwd_dkv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

// SMs of the current device, or minus the CUDA error.
int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? sms : -(int)err;
}

template <typename T, int DP>
cudaError_t launch_dkv_wgmma(const void* const* p, int S, int H, int KVH,
                             int D, const Strides& st, int causal,
                             int window, float scale, cudaStream_t stream) {
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
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + Tl::BKV - 1) / Tl::BKV;
  if constexpr (Gmma<T, DP>::PAIRS) {
    // The parts of a KV tile form a cluster, as the 256 instance's do;
    // one part is a plain launch.
    const int sms = sm_count();
    if (sms < 0) return static_cast<cudaError_t>(-sms);
    const int parts = dkv_parts(S, KVH, H / KVH, sms);
    ClusterLaunch l(dim3(tiles * KVH * parts), Tl::NT, smem, stream, parts);
    if (parts == 1) l.cfg.numAttrs = 0;
    err = cudaLaunchKernelEx(
        &l.cfg, flash_bwd_dkv_wgmma_kernel<T, DP>, tq, tk, tv, tdo,
        static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
        static_cast<T*>(const_cast<void*>(p[6])),
        static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, causal,
        window, scale);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
  const dim3 grid = Tl::HEADS_FIRST ? dim3(tiles * KVH) : dim3(tiles, KVH);
  flash_bwd_dkv_wgmma_kernel<T, DP><<<grid, Tl::NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv_split(const void* const* p, int S, int H, int KVH,
                             int D, const Strides& st, int causal,
                             int window, float scale, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<T, DP>();
  auto* kernel = flash_bwd_dkv_split_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 0) return static_cast<cudaError_t>(-sms);
  const int parts = dkv_parts(S, KVH, H / KVH, sms);
  // The parts of a KV tile form a cluster; one part is a plain launch.
  ClusterLaunch l(dim3((S + BKV - 1) / BKV * parts, KVH), SPLIT_NT, smem,
                  stream, parts);
  if (parts == 1) l.cfg.numAttrs = 0;
  err = cudaLaunchKernelEx(
      &l.cfg, kernel, static_cast<const T*>(p[0]),
      static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale, parts);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t launch_dkv_wide(const void* const* p, int S, int H, int KVH,
                            int D, const Strides& st, int causal, int window,
                            float scale, cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes<T>();
  auto* kernel = flash_bwd_dkv_wide_kernel<T, W_QROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n = (D + W_COLS - 1) / W_COLS;
  const ClusterLaunch l(dim3((S + BKV - 1) / BKV * n, KVH),
                        wide_threads<T>(), smem, stream, n);
  err = cudaLaunchKernelEx(
      &l.cfg, kernel, static_cast<const T*>(p[0]),
      static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t launch_dkv_stream(const void* const* p, int S, int H, int KVH,
                              int D, const Strides& st, int causal,
                              int window, float scale, cudaStream_t stream) {
  constexpr int smem = stream_smem_bytes<T>();
  constexpr int DC = stream_chunk<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_stream_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_slices = (D + W_COLS - 1) / W_COLS;
  const dim3 grid((S + BKV - 1) / BKV * n_slices * 2, KVH);
  flash_bwd_dkv_stream_kernel<T, DC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, st,
      vec_bits<T>(p, st, D), causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The widest head_dim of the wide route: 8 blocks a cluster.
constexpr int WIDE_MAX_D = W_COLS * X_MAX_N;

// The routes, by the codes flash_bwd_dkv_route gives them
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
Launcher dkv_for(int D, int vec) {
  if constexpr (sizeof(T) == 2)
    if (route_for<T>(D, vec) == R_WGMMA)
      return D <= 64 ? &launch_dkv_wgmma<T, 64>
           : D <= 128 ? &launch_dkv_wgmma<T, 128>
                      : &launch_dkv_wgmma<T, 256>;
  return D <= 16 ? &launch_dkv<T, 16>
       : D <= 32 ? &launch_dkv<T, 32>
       : D <= 64 ? &launch_dkv<T, 64>
       : D <= 128 ? &launch_dkv<T, 128>
       : D <= 256 ? &launch_dkv_split<T, 256>
       : D <= WIDE_MAX_D ? &launch_dkv_wide<T>
                         : &launch_dkv_stream<T>;
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
      return D <= 64 ? warps_per_sm(flash_bwd_dkv_wgmma_kernel<T, 64>,
                                    GTile<64>::NT, Gmma<T, 64>::SMEM)
           : D <= 128 ? warps_per_sm(flash_bwd_dkv_wgmma_kernel<T, 128>,
                                     GTile<128>::NT, Gmma<T, 128>::SMEM)
                      : warps_per_sm(flash_bwd_dkv_wgmma_kernel<T, 256>,
                                     GTile<256>::NT, Gmma<T, 256>::SMEM);
  return D <= 16 ? warps_per_sm(flash_bwd_dkv_kernel<T, 16>, NT,
                                smem_bytes<T, 16>())
       : D <= 32 ? warps_per_sm(flash_bwd_dkv_kernel<T, 32>, NT,
                                smem_bytes<T, 32>())
       : D <= 64 ? warps_per_sm(flash_bwd_dkv_kernel<T, 64>, NT,
                                smem_bytes<T, 64>())
       : D <= 128 ? warps_per_sm(flash_bwd_dkv_kernel<T, 128>, NT,
                                 smem_bytes<T, 128>())
       : D <= 256 ? warps_per_sm(flash_bwd_dkv_split_kernel<T, 256>,
                                 SPLIT_NT, split_smem_bytes<T, 256>())
                  : -1;
}

template <typename T>
int clusters_for(int D) {
  return max_clusters(flash_bwd_dkv_wide_kernel<T, W_QROWS>,
                      wide_threads<T>(), wide_smem_bytes<T>(),
                      (D + W_COLS - 1) / W_COLS);
}

}  // namespace

extern "C" {

// q and dout (S, H, D), k and v (S, KVH, D), with unit stride along D and
// the row and head strides in `strides` (elements: q, k, v, dout, each
// row then head); lse and delta (H, S) f32 contiguous; dk and dv written
// (S, KVH, D) contiguous in k's type, each the sum over the H / KVH query
// heads that share the KV head. dtype: 0 = f32, 1 = bf16, 2 = f16. Any
// head_dim D >= 1. window <= 0 means none. Returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a size, dtype or head
// count no instance takes).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int S, int H, int KVH, int D,
                  const long long* strides, int causal, int window,
                  float scale, int dtype, void* stream) {
  if (S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, dout, lse, delta, dk, dv};
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Launcher f =
      dtype == 0   ? dkv_for<float>(D, vec_bits<float>(p, st, D))
      : dtype == 1 ? dkv_for<bf16>(D, vec_bits<bf16>(p, st, D))
                   : dkv_for<f16>(D, vec_bits<f16>(p, st, D));
  return (int)f(p, S, H, KVH, D, st, causal, window, scale,
                static_cast<cudaStream_t>(stream));
}

// The route (R_INSTANCE 0, R_WGMMA 1, R_WIDE 2, R_STREAM 3) a launch takes at
// head_dim D and dtype, with `vec` the bits (1 q, 2 k, 4 v, 8 dO) of the
// tensors whose pointer, strides and head_dim are whole 16-byte units.
int flash_bwd_dkv_route(int D, int dtype, int vec) {
  return dtype == 0   ? route_for<float>(D, vec)
         : dtype == 1 ? route_for<bf16>(D, vec)
                      : route_for<f16>(D, vec);
}

// Bytes of dynamic shared memory a block of the template that (D, dtype,
// vec) takes.
int flash_bwd_dkv_smem_bytes(int D, int dtype, int vec) {
  return dtype == 0   ? smem_for<float>(D, vec)
         : dtype == 1 ? smem_for<bf16>(D, vec)
                      : smem_for<f16>(D, vec);
}

// Clusters of the wide route's kernel for (D, dtype) the card can hold at
// once (cudaOccupancyMaxActiveClusters; 0: none fits, and a launch
// fails), minus a CUDA error, or -1 for a head_dim outside the route.
int flash_bwd_dkv_max_clusters(int D, int dtype) {
  if (D <= 256 || D > WIDE_MAX_D) return -1;
  return dtype == 0   ? clusters_for<float>(D)
         : dtype == 1 ? clusters_for<bf16>(D)
                      : clusters_for<f16>(D);
}

// Warps of the template that (D, dtype, vec) takes an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), minus a CUDA error, or
// -1 for a head_dim on the wide or streamed route.
int flash_bwd_dkv_warps_per_sm(int D, int dtype, int vec) {
  return dtype == 0   ? warps_for<float>(D, vec)
         : dtype == 1 ? warps_for<bf16>(D, vec)
                      : warps_for<f16>(D, vec);
}

// Blocks of the head_dim-256 instance, or of the wgmma route's 256
// template, that share each KV tile in a launch on the current device
// (dkv_parts(), the same for both); 1 for a head_dim outside 129-256;
// minus a CUDA error.
int flash_bwd_dkv_parts(int S, int KVH, int group, int D) {
  if (D <= 128 || D > 256) return 1;
  const int sms = sm_count();
  return sms < 0 ? sms : dkv_parts(S, KVH, group, sms);
}

// The wgmma route's tiles at padded head_dim DP (64, 128 or 256): keys a
// block into *keys and query rows a tile into *rows. Returns 0, or
// cudaErrorInvalidValue for another DP.
int flash_bwd_dkv_wgmma_tiles(int DP, int* keys, int* rows) {
  if (DP == 64) {
    *keys = GTile<64>::BKV, *rows = GTile<64>::BQ;
  } else if (DP == 128) {
    *keys = GTile<128>::BKV, *rows = GTile<128>::BQ;
  } else if (DP == 256) {
    *keys = GTile<256>::BKV, *rows = GTile<256>::BQ;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
