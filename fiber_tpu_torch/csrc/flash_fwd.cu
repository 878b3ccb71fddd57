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
// causality) for O(S D) bytes, so operations. bf16 inputs run them at
// the bf16 tensor-core rate (989 TFLOP/s dense). f32 inputs run each
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
//   would spill: f32 from head_dim 64 on, bf16 at 128. The tiles of the
//   last query rows, which see the most keys under causality, are
//   scheduled first. The block sweeps the KV tiles with _run_window's
//   predicate as its loop bounds; m, l and the output accumulator stay
//   in registers.
// - Q is staged in shared memory once. bf16 Q fragments stay in
//   registers for the whole sweep; f32 ones (big and small) are split
//   again from shared memory at each tile, which beside two m-tiles'
//   accumulators measured faster than one m-tile with Q in registers.
//   64-row K and V tiles are double-buffered by cp.async (16 bytes a
//   thread): the next tile's copy runs while the current one computes,
//   one wait and one barrier a tile.
// - Per KV tile a warp computes its scores S = Q K^T (16 x 64 an m-tile)
//   as mma accumulators, the online softmax in registers in base 2 (scores
//   scaled by scale * log2 e, ex2.approx; a row spans the 4 threads of a
//   quad, so its max takes two shuffles, and its sum stays a per-thread
//   partial until the end), then O += P V with P never leaving the
//   registers: for bf16 the m16n8k16 accumulators of two adjacent
//   8-column score tiles are, packed to bf16, the A fragment of one
//   16-deep step; for f32 the m16n8k8 accumulator holds columns 2t and
//   2t + 1 where the A operand wants t and t + 4, so the depth index is
//   permuted (t <-> 2t, t + 4 <-> 2t + 1) in both P and V's rows, which
//   leaves the sum as it is. Tiles with no masked entry (most of a long
//   sequence) skip the mask arithmetic.
// - The tensor cores round their f32 sums toward zero, and an O row sums
//   up to 16384 keys. On f32 each KV tile's P V is therefore summed from
//   zero and folded into O as o = o * corr + pv, rounded to nearest.
// - Operands stay in their own type in shared memory: bf16 rows padded to
//   D + 8 elements and read with ldmatrix (.trans for V), f32 rows padded
//   to D + 4 and read with 32-bit loads; both free of bank conflicts. A
//   tensor whose pointer, strides or head_dim are not whole 16-byte
//   units takes a scalar load path instead (per tensor, chosen by the
//   launcher).
//
// q, k and v are read through their (S, heads, head_dim) strides (the LM
// hands over views of one projection); O is written contiguous (S, H, D)
// in q's type.

#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 4;           // warps per block
constexpr int NT = 32 * WARPS;     // threads per block
constexpr int BKV = 64;            // key/value rows per tile
constexpr int NJ = BKV / 8;        // 8-column score tiles per m-tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;
static_assert(NJ * 4 == 32, "a thread's keep bits of a tile fill a word");

// 16-row m-tiles per warp: each K and V fragment a warp loads (and, for
// f32, splits) feeds MT products. Two where ptxas then spills nothing
// (f32 to head_dim 32, bf16 to 64; about 220 and 254 registers), else
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

struct Strides {                   // row (ss) and head (sh) strides, elements
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
};

// Bits of `vec`: the 16-byte copy path may be used for q, k, v.
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4;

// The warp's Q as A fragments of its MT m-tiles.
template <typename T, int DP, int MT> struct QFrags;

// bf16: one ldmatrix x4 per m-tile and 16-deep step, MT DP / 4 registers.
template <int DP, int MT> struct QFrags<bf16, DP, MT> {
  static constexpr int LD = DP + Pad<bf16>::value;
  uint32_t a[MT][DP / 16][4];

  __device__ __forceinline__ void load(const bf16* sq, int wrow, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(a[mt][kk], sq + (wrow + mt * 16 + (lane & 15)) * LD +
                               kk * 16 + (lane >> 4) * 8);
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

// The warp's 16 MT x BKV scores Q K^T: s[mt][j] holds key columns
// 8j..8j+7 of the tile sk for m-tile mt as an m16n8 accumulator fragment.
template <int DP, int MT>
__device__ __forceinline__ void scores(float (&s)[MT][NJ][4],
                                       const QFrags<bf16, DP, MT>& qf,
                                       const bf16* sk, int lane) {
  constexpr int LD = DP + Pad<bf16>::value;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, sk + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * jj], qf.a[mt][kk], b[0], b[1]);
        mma_bf16(s[mt][2 * jj + 1], qf.a[mt][kk], b[2], b[3]);
      }
    }
  }
}

template <int DP, int MT>
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
// scores(), now probabilities) as the A operand, V the BKV x DP tile sv.
// o[mt][n] holds head_dim columns 8n..8n+7 of m-tile mt; corr[mt][r] is
// the rescale of its row g + 8r.
template <int DP, int MT>
__device__ __forceinline__ void accumulate(float (&o)[MT][DP / 8][4],
                                           const float (&p)[MT][NJ][4],
                                           const float (&corr)[MT][2],
                                           const bf16* sv, int lane) {
  constexpr int LD = DP + Pad<bf16>::value;
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
      a[mt][0] = pack_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int nn = 0; nn < DP / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_trans(b, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + nn * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * nn], a[mt], b[0], b[1]);
        mma_bf16(o[mt][2 * nn + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int DP, int MT>
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

template <typename T, int DP>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int group, int D,
                 Strides st, int vec, int causal, int window, float scale) {
  constexpr int MT = m_tiles(sizeof(T) == 4, DP);
  constexpr int BQ = q_rows(sizeof(T) == 4, DP);
  constexpr int ND = DP / 8;        // 8-column accumulator tiles
  constexpr int LD = DP + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);     // BQ x LD
  T* sk = sq + BQ * LD;                       // 2 buffers of BKV x LD
  T* sv = sk + 2 * BKV * LD;                  // 2 buffers of BKV x LD

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
    scores<DP, MT>(s, qf, sk + b * BKV * LD, lane);

    // Whether any entry of this tile is masked (diagonal, window edge or
    // ragged keys); the same for the whole block, so no warp diverges.
    // Query rows past S are left unmasked: their Q rows are zeros, and
    // they are never written.
    bool masked = k0 + BKV > S;
    if (causal)
      masked = masked || k0 + BKV - 1 > q0 ||
               (window > 0 && q0 + BQ - 1 - k0 >= window);
    uint32_t kept[MT];              // bit 4j + e: entry s[mt][j][e] is kept
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      kept[mt] = 0xffffffffu;
      if (masked) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + wrow + mt * 16 + g + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (!keep(qi, kj, S, causal, window)) {
              kept[mt] &= ~(1u << (4 * j + e));
              s[mt][j][e] = kNegInf;
            }
          }
      }
    }

    // Online softmax on the raw scores: max(raw) * scale_log2 is the
    // scaled max, and p = 2^(raw * scale_log2 - m).
    float corr[MT][2];
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
            if (masked && !(kept[mt] >> (4 * j + e) & 1u)) p = 0.f;
            s[mt][j][e] = p;
            ls += p;
          }
        l[mt][r] = l[mt][r] * corr[mt][r] + ls;
      }
    accumulate<DP, MT>(acc, s, corr, sv + b * BKV * LD, lane);
  }

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
      T* orow = o + ((long long)qi * H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + 2 * t + c;
          if (col < D) store(orow + col, acc[mt][n][2 * r + c] / li);
        }
      if (t == 0)
        lse[(long long)h * S + qi] =
            lr == 0.f ? kNegInf : m[mt][r] * LN2 + logf(li);
    }
}

// Dynamic shared memory of one block: the Q tile and two K and two V
// tiles.
template <typename T, int DP>
constexpr int smem_bytes() {
  return (int)((q_rows(sizeof(T) == 4, DP) + 4 * BKV) *
               (DP + Pad<T>::value) * sizeof(T));
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
  // The 16-byte copy path of a tensor: its pointer, row and head strides
  // and head_dim all in whole 16-byte units.
  constexpr long long V = 16 / sizeof(T);
  auto whole = [&](const void* ptr, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ss % V == 0 &&
           sh % V == 0 && D % V == 0;
  };
  const int vec = (whole(p[0], st.q_ss, st.q_sh) ? VEC_Q : 0) |
                  (whole(p[1], st.k_ss, st.k_sh) ? VEC_K : 0) |
                  (whole(p[2], st.v_ss, st.v_sh) ? VEC_V : 0);
  const dim3 grid((S + BQ - 1) / BQ, H);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<T*>(const_cast<void*>(p[3])),
      static_cast<float*>(const_cast<void*>(p[4])), S, H, H / KVH, D, st,
      vec, causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The template instances with head_dim padded to 16, 32, 64 or 128.
template <typename T>
Launcher fwd_for(int D) {
  return D <= 16 ? &launch_fwd<T, 16>
       : D <= 32 ? &launch_fwd<T, 32>
       : D <= 64 ? &launch_fwd<T, 64>
                 : &launch_fwd<T, 128>;
}

template <typename T>
int smem_for(int D) {
  return D <= 16 ? smem_bytes<T, 16>()
       : D <= 32 ? smem_bytes<T, 32>()
       : D <= 64 ? smem_bytes<T, 64>()
                 : smem_bytes<T, 128>();
}

}  // namespace

extern "C" {

// q (S, H, D), k and v (S, KVH, D) with unit stride along D and the given
// row (ss) and head (sh) strides in elements; o (S, H, D) contiguous in
// q's type; lse (H, S) f32. dtype: 0 = f32, 1 = bf16. window <= 0 means
// none. Returns the CUDA error of the launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int S, int H, int KVH, int D, long long q_ss,
              long long q_sh, long long k_ss, long long k_sh, long long v_ss,
              long long v_sh, int causal, int window, float scale, int dtype,
              void* stream) {
  if (S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 || D > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, o, lse};
  const Strides st{q_ss, q_sh, k_ss, k_sh, v_ss, v_sh};
  const Launcher f = dtype == 0 ? fwd_for<float>(D) : fwd_for<bf16>(D);
  return (int)f(p, S, H, KVH, D, st, causal, window, scale,
                static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the instance for (D, dtype)
// takes.
int flash_fwd_smem_bytes(int D, int dtype) {
  return dtype == 0 ? smem_for<float>(D) : smem_for<bf16>(D);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
