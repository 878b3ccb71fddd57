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
// causality) for O(S D) bytes, so operations. bf16 inputs run them at
// the bf16 tensor-core rate (989 TFLOP/s dense). f32 inputs run each
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
// - One block of 4 warps owns one (KV head, 64-row KV tile); each warp
//   owns 16 KV rows. K and V are staged in shared memory once. The block
//   loops over the group's query heads and their query tiles (64 rows; 32
//   at head_dim 128, to keep the accumulators in registers), from the
//   causal diagonal on and, with a window, up to k0 + 63 + window. dk and
//   dv accumulate in registers; a block owns its outputs, so there are no
//   atomics and the gradients repeat bit for bit.
// - Per query tile a warp computes S^T = K Q^T and dP^T = V dO^T for its
//   16 rows (accumulator fragments), P^T and dS^T from them in registers,
//   then dV += P^T dO and dK += dS^T Q. P^T and dS^T never leave the
//   registers: for bf16 the m16n8k16 accumulator layout of two adjacent
//   8-column tiles is the A-operand layout of one 16-deep step (packed to
//   bf16 pairs); for f32 the m16n8k8 accumulator holds columns 2t and 2t+1
//   where the A operand wants t and t+4, so the depth index is permuted
//   (t <-> 2t, t+4 <-> 2t+1) in both A and B, which leaves the sum as it is.
// - Operands stay in their own type in shared memory: bf16 rows padded to
//   D + 8 elements and read with ldmatrix (.trans for the B operand of
//   the two accumulating products); f32 rows padded to D + 4 and read
//   with 32-bit loads, split into big and small at each fragment load.
//   On f32 each query tile's dV and dK products are summed from zero and
//   then added to the running sums (add_xb() in mma_sm90.cuh).
//   Both paddings make the fragment reads free of bank conflicts.
// - Q, dO, lse and delta of the next query tile are copied with cp.async
//   (16 bytes a thread; 4 for lse and delta) into the second of two
//   buffers while the current tile computes: one wait and one barrier
//   per tile. A tensor whose pointer, strides or head_dim are not in
//   whole 16-byte units takes a scalar load path inside the kernel
//   instead (per tensor, chosen by the launcher).
//
// q, k, v and dO are read through their (S, heads, head_dim) strides; dk
// and dv are written contiguous, (S, KVH, D), in k's type. The copy,
// ldmatrix, mma and split helpers and the two tile products (abt,
// add_xb) are mma_sm90.cuh's, shared with the forward (flash_fwd.cu) and
// dq (flash_bwd_dq.cu).

#include "mma_sm90.cuh"

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

struct Strides {                   // row (ss) and head (sh) strides, elements
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, do_ss, do_sh;
};

// Bits of `vec`: the 16-byte copy path may be used for q, k, v, dO.
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_DO = 8;

template <typename T, int DP>
__global__ void __launch_bounds__(NT, min_blocks(sizeof(T) == 4, DP))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int KVH, int group, int D,
                     Strides st, int vec, int causal, int window,
                     float scale) {
  constexpr int BQ = q_tile(DP);
  constexpr int NJ = BQ / 8;        // 8-column score tiles per warp
  constexpr int ND = DP / 8;        // 8-column accumulator tiles
  constexpr int LD = DP + Pad<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);     // BKV x LD
  T* sv = sk + BKV * LD;                      // BKV x LD
  T* sq = sv + BKV * LD;                      // 2 buffers of BQ x LD
  T* sdo = sq + 2 * BQ * LD;                  // 2 buffers of BQ x LD
  float* slse = reinterpret_cast<float*>(sdo + 2 * BQ * LD);  // 2 x BQ
  float* sdelta = slse + 2 * BQ;                              // 2 x BQ

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

  // Stages query tile `it` (head it / n_qt of the group) into buffer it & 1.
  auto stage = [&](int it) {
    const int h = kvh * group + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * BQ;
    const int b = it & 1;
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

    const int b = it & 1;
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

// Dynamic shared memory of one block: K, V, two Q and two dO tiles, and
// two buffers each of lse and delta.
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
  const dim3 grid((S + BKV - 1) / BKV, KVH);
  flash_bwd_dkv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, st, vec,
      causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The template instances with head_dim padded to 16, 32, 64 or 128.
template <typename T>
Launcher dkv_for(int D) {
  return D <= 16 ? &launch_dkv<T, 16>
       : D <= 32 ? &launch_dkv<T, 32>
       : D <= 64 ? &launch_dkv<T, 64>
                 : &launch_dkv<T, 128>;
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

// q and dout (S, H, D), k and v (S, KVH, D), with unit stride along D and
// the row and head strides in `strides` (elements: q, k, v, dout, each
// row then head); lse and delta (H, S) f32 contiguous; dk and dv written
// (S, KVH, D) contiguous in k's type, each the sum over the H / KVH query
// heads that share the KV head. dtype: 0 = f32, 1 = bf16. window <= 0
// means none. Returns the CUDA error of the launch (0 on success).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int S, int H, int KVH, int D,
                  const long long* strides, int causal, int window,
                  float scale, int dtype, void* stream) {
  if (S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 || D > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, dout, lse, delta, dk, dv};
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Launcher f = dtype == 0 ? dkv_for<float>(D) : dkv_for<bf16>(D);
  return (int)f(p, S, H, KVH, D, st, causal, window, scale,
                static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the instance for (D, dtype)
// takes.
int flash_bwd_dkv_smem_bytes(int D, int dtype) {
  return dtype == 0 ? smem_for<float>(D) : smem_for<bf16>(D);
}

const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
