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
// - One block of 4 warps owns one (query head, query tile); each warp
//   owns MT 16-row m-tiles (m_tiles(), below), so that every K and V
//   fragment it loads (and, for f32, splits) feeds MT products. The TPU
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
// - head_dim 129-256 pads to one 256 instance, whose dq accumulator is
//   128 registers a thread: its K and V tiles are 32 rows (two score
//   tiles of 16 registers each beside dq), and for f32 single-buffered
//   (the next tile's copy after a barrier at the end of this one), since
//   the Q and dO tiles and two buffers of K and V would take 266 KB of
//   shared memory against the block's 227 KB.
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

#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 4;           // warps per block
constexpr int NT = 32 * WARPS;     // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// Key/value rows per tile: 64, or 32 beyond head_dim 128.
__host__ __device__ constexpr int kv_rows(int dp) {
  return dp > 128 ? 32 : 64;
}

// K and V buffers: two, or one for f32 beyond head_dim 128.
__host__ __device__ constexpr int kv_bufs(bool f32, int dp) {
  return f32 && dp > 128 ? 1 : 2;
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

// Dynamic shared memory of one block: the Q and dO tiles and NB K and NB
// V tiles.
template <typename T, int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (int)((2 * q_rows(sizeof(T) == 4, DP) +
                2 * kv_bufs(sizeof(T) == 4, DP) * kv_rows(DP)) *
               (DP + Pad<T>::value) * sizeof(T));
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

template <typename T, int DP>
__global__ void __launch_bounds__(NT, (min_blocks<T, DP>()))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int group, int D, Strides st, int vec,
                    int causal, int window, float scale) {
  constexpr int MT = m_tiles(sizeof(T) == 4, DP);
  constexpr int BQ = q_rows(sizeof(T) == 4, DP);
  constexpr int BKV = kv_rows(DP);
  constexpr int NB = kv_bufs(sizeof(T) == 4, DP);
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
    // buffers the copy of tile it + 1 now overwrites (with two buffers;
    // with one, that copy waits for the end of this tile, below).
    cp_async_wait_all();
    __syncthreads();
    if constexpr (NB == 2) {
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
    }

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
    if constexpr (NB == 1) {
      __syncthreads();              // every warp is done with the buffer
      if (it + 1 < n_it) stage(it + 1);
      cp_async_commit();
    }
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
  // The 16-byte copy path of a tensor: its pointer, row and head strides
  // and head_dim all in whole 16-byte units.
  constexpr long long V = 16 / sizeof(T);
  auto whole = [&](const void* ptr, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ss % V == 0 &&
           sh % V == 0 && D % V == 0;
  };
  const int vec = (whole(p[0], st.q_ss, st.q_sh) ? VEC_Q : 0) |
                  (whole(p[1], st.k_ss, st.k_sh) ? VEC_K : 0) |
                  (whole(p[2], st.v_ss, st.v_sh) ? VEC_V : 0) |
                  (whole(p[3], st.do_ss, st.do_sh) ? VEC_DO : 0);
  const dim3 grid((S + BQ - 1) / BQ, H);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, st, vec,
      causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The template instances with head_dim padded to 16, 32, 64, 128 or 256.
template <typename T>
Launcher dq_for(int D) {
  return D <= 16 ? &launch_dq<T, 16>
       : D <= 32 ? &launch_dq<T, 32>
       : D <= 64 ? &launch_dq<T, 64>
       : D <= 128 ? &launch_dq<T, 128>
                  : &launch_dq<T, 256>;
}

template <typename T>
int smem_for(int D) {
  return D <= 16 ? smem_bytes<T, 16>()
       : D <= 32 ? smem_bytes<T, 32>()
       : D <= 64 ? smem_bytes<T, 64>()
       : D <= 128 ? smem_bytes<T, 128>()
                  : smem_bytes<T, 256>();
}

// The largest head_dim an instance takes.
constexpr int MAX_HEAD_DIM = 256;

}  // namespace

extern "C" {

// q and dout (S, H, D), k and v (S, KVH, D), with unit stride along D and
// the row and head strides in `strides` (elements: q, k, v, dout, each
// row then head); lse and delta (H, S) f32 contiguous; dq written (S, H,
// D) contiguous in q's type. dtype: 0 = f32, 1 = bf16, 2 = f16. head_dim
// D up to MAX_HEAD_DIM (256). window <= 0 means none. Returns the CUDA
// error of the launch (0 on success; cudaErrorInvalidValue for a D, dtype
// or head count no instance takes).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int S, int H, int KVH, int D,
                 const long long* strides, int causal, int window,
                 float scale, int dtype, void* stream) {
  if (S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 ||
      D > MAX_HEAD_DIM || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, dout, lse, delta, dq};
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Launcher f = dtype == 0   ? dq_for<float>(D)
                     : dtype == 1 ? dq_for<bf16>(D)
                                  : dq_for<f16>(D);
  return (int)f(p, S, H, KVH, D, st, causal, window, scale,
                static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the instance for (D, dtype)
// takes.
int flash_bwd_dq_smem_bytes(int D, int dtype) {
  return dtype == 0   ? smem_for<float>(D)
         : dtype == 1 ? smem_for<bf16>(D)
                      : smem_for<f16>(D);
}

const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
