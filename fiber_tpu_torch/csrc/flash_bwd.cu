// Flash-attention backward for Hopper (sm_90a), plain CUDA C++ with a C
// interface (loaded with ctypes by fiber_tpu_torch/ops/flash_attention.py).
//
// Two kernels, the FlashAttention-2 recurrence from the forward's saved
// (q, k, v, O, lse), with delta = rowsum(dO * O) - dlse computed outside:
//
//   p_ij  = exp(s_ij * scale - lse_i)          (masked entries 0)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//
// flash_bwd_dq replaces fiber_tpu/ops/pallas_attention.py:_bwd_dq_kernel:
//   dq_i = scale * sum_j ds_ij k_j, over the KV tiles a query tile sees.
// flash_bwd_dkv replaces pallas_attention.py:_bwd_dkv_kernel:
//   dv_j = sum_i p_ij dO_i and dk_j = scale * sum_i ds_ij q_i, over the
//   query tiles of every query head of the KV head's GQA group.
// Both recompute p and ds as _bwd_p_ds does, with _run_window's block
// skip as loop bounds and _keep_mask's elementwise mask.
//
// What bounds them on this card: at the shapes the port trains (S =
// 16384, head_dim 32) each does three (dq) or four (dk/dv) S x S x D
// products, halved by causality, for O(S D) bytes: thousands of
// operations per byte, far above the H100's ridge, so both are bound by
// arithmetic. This first version does it as f32 FMA on the CUDA cores (67
// TFLOP/s peak), which also keeps the f32 parity bound that TF32 tensor
// cores could not; wgmma and TMA are later work. What the design does
// about the bound: every operand is staged once per tile in shared memory
// as f32 and each thread keeps a 4 x 4 register tile of scores, so the
// inner loops run two FMAs per shared-memory load; tiles the mask empties
// entirely are never visited, so causal and windowed shapes pay only for
// the tiles they need.
//
// Design. The TPU kernels carry dq (or dk and dv) in VMEM scratch across
// a sequential innermost grid axis; CUDA blocks share nothing, so that
// axis becomes a loop inside one block and the sums stay in registers:
//
// - flash_bwd_dq: one block owns one (query head, 64-row query tile). Q,
//   dO, lse and delta of the tile are staged once; the block sweeps the
//   KV tiles from _run_window's first to its last, recomputes s, p, dp and
//   ds, passes ds through shared memory and adds ds K into its dq
//   registers, then writes dq * scale once.
// - flash_bwd_dkv: one block owns one (KV head, 64-row KV tile). K and V
//   stay in shared memory; the block loops over the group's query heads
//   and over their query tiles from the causal diagonal onward (with a
//   window, only up to the last row that still sees the tile). Scores are
//   computed transposed (KV rows by query columns), so p^T and ds^T go to
//   shared memory in the layout the dv += p^T dO and dk += ds^T Q products
//   read; dk * scale and dv are written once.
//
// Each block owns its outputs, so there are no atomics and the gradients
// are the same from run to run (the JAX package's split, kept on
// purpose). 256 threads form a 16 x 16 grid: a thread owns 4 rows and 4
// columns of the score tile and 4 rows by head_dim / 16 columns of its
// accumulators. Rows past S read no lse or delta and add nothing; columns
// past S are masked whatever `causal` says (their zero-filled K rows give
// s = 0, and exp(0 - lse) is not 0). Shared-memory rows have an odd
// stride, so the column walks are free of bank conflicts. q, k, v and dO
// are read through their (S, heads, head_dim) strides; dq, dk and dv are
// written contiguous, dq as (S, H, D), dk and dv as (S, KVH, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;          // rows per query tile and per KV tile
constexpr int TX = 16;          // threads along a tile's columns
constexpr int TY = 16;          // threads along a tile's rows
constexpr int NT = TX * TY;     // threads per block
constexpr int RM = BT / TY;     // score rows per thread
constexpr int RN = BT / TX;     // score columns per thread
constexpr int LDP = BT + 1;     // row stride of the p / ds tiles

struct Strides {                // row (ss) and head (sh) strides, elements
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, do_ss, do_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copies a (BT x D) tile starting at sequence row `row0` into shared
// memory as f32 with row stride DP + 1; rows past S and columns past D
// are zero, so they add nothing to the dot products.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int S, int D,
                                          long long ss) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < BT * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S && c < D) x = to_f32(src[s * ss + c]);
    dst[r * LD + c] = x;
  }
}

// _keep_mask plus the ragged edge: query row qi may use key row kj.
__device__ __forceinline__ bool keep(int qi, int kj, int S, int causal,
                                     int window) {
  bool k = qi < S && kj < S;
  if (causal) k = k && qi >= kj && (window <= 0 || qi - kj < window);
  return k;
}

// This thread's RM x RN entries of two tile products, over head_dim:
// x[i][j] = a[r_i] . c[c_j] and y[i][j] = b[r_i] . d[c_j], with rows
// r_i = ty * RM + i of a and b and rows c_j = tx + TX * j of c and d.
template <int DP>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* d,
                                             float (&x)[RM][RN],
                                             float (&y)[RM][RN], int ty,
                                             int tx) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < DP; ++e) {
    float ra[RM], rb[RM], rc[RN], rd[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      ra[i] = a[(ty * RM + i) * LD + e];
      rb[i] = b[(ty * RM + i) * LD + e];
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      rc[j] = c[(tx + TX * j) * LD + e];
      rd[j] = d[(tx + TX * j) * LD + e];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        x[i][j] = fmaf(ra[i], rc[j], x[i][j]);
        y[i][j] = fmaf(rb[i], rd[j], y[i][j]);
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int group, int D, Strides st, int causal,
                    int window, float scale) {
  constexpr int LD = DP + 1;
  constexpr int CJ = DP / TX;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;             // BT x LD
  float* sdo = sq + BT * LD;    // BT x LD
  float* sk = sdo + BT * LD;    // BT x LD
  float* sv = sk + BT * LD;     // BT x LD
  float* sds = sv + BT * LD;    // BT x LDP: ds, query rows by KV columns

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int h = blockIdx.y;
  const int kvh = h / group;
  // Heaviest causal tiles (the last query rows) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;

  load_tile<T, DP>(sq, q + h * st.q_sh, q0, S, D, st.q_ss);
  load_tile<T, DP>(sdo, dout + h * st.do_sh, q0, S, D, st.do_ss);
  const T* kh = k + kvh * st.k_sh;
  const T* vh = v + kvh * st.v_sh;

  float row_lse[RM], row_delta[RM], acc[RM][CJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    row_lse[i] = qi < S ? lse[(long long)h * S + qi] : 0.f;
    row_delta[i] = qi < S ? delta[(long long)h * S + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // _run_window as loop bounds: causal tiles end at the diagonal; a
  // window starts at the first tile holding a key some row may attend.
  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BT);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BT) * BT;
    }
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done with sk/sv/sds
    load_tile<T, DP>(sk, kh, k0, S, D, st.k_ss);
    load_tile<T, DP>(sv, vh, k0, S, D, st.v_ss);
    __syncthreads();

    float s[RM][RN], dp[RM][RN];
    two_products<DP>(sq, sdo, sk, sv, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kj = k0 + tx + TX * j;
        const float p = keep(qi, kj, S, causal, window)
                            ? expf(s[i][j] * scale - row_lse[i])
                            : 0.f;
        sds[(ty * RM + i) * LDP + tx + TX * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BT; ++n) {
      float ds[RM], kk[CJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = sds[(ty * RM + i) * LDP + n];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kk[c] = sk[n * LD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= S) continue;
    T* row = dq + ((long long)qi * H + h) * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = tx + TX * c;
      if (col < D) store(row + col, acc[i][c] * scale);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int KVH, int group, int D,
                     Strides st, int causal, int window, float scale) {
  constexpr int LD = DP + 1;
  constexpr int CJ = DP / TX;
  extern __shared__ float smem[];
  float* sk = smem;             // BT x LD
  float* sv = sk + BT * LD;     // BT x LD
  float* sq = sv + BT * LD;     // BT x LD
  float* sdo = sq + BT * LD;    // BT x LD
  float* spt = sdo + BT * LD;   // BT x LDP: p^T, KV rows by query columns
  float* sdst = spt + BT * LDP; // BT x LDP: ds^T
  float* slse = sdst + BT * LDP;  // BT
  float* sdelta = slse + BT;      // BT

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int kvh = blockIdx.y;
  // Under causality the first KV tiles see the most query tiles; they
  // have the lowest block index and are scheduled first.
  const int k0 = blockIdx.x * BT;

  load_tile<T, DP>(sk, k + kvh * st.k_sh, k0, S, D, st.k_ss);
  load_tile<T, DP>(sv, v + kvh * st.v_sh, k0, S, D, st.v_ss);

  float acc_k[RM][CJ], acc_v[RM][CJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // The transpose of _run_window: a KV tile [k0, k0 + BT) is seen by query
  // rows from k0 on (causal), and with a window only up to the last row
  // whose window still reaches key k0 + BT - 1, i.e. k0 + BT - 2 + window.
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + BT - 1 + window);
  }

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qh = q + h * st.q_sh;
    const T* doh = dout + h * st.do_sh;
    const float* lse_h = lse + (long long)h * S;
    const float* delta_h = delta + (long long)h * S;
    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DP>(sq, qh, q0, S, D, st.q_ss);
      load_tile<T, DP>(sdo, doh, q0, S, D, st.do_ss);
      for (int i = threadIdx.x; i < BT; i += NT) {
        const int qi = q0 + i;
        slse[i] = qi < S ? lse_h[qi] : 0.f;
        sdelta[i] = qi < S ? delta_h[qi] : 0.f;
      }
      __syncthreads();

      // Transposed tiles: row i of this thread is KV row ty * RM + i,
      // column j is query row tx + TX * j.
      float s[RM][RN], dp[RM][RN];
      two_products<DP>(sk, sv, sq, sdo, s, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kj = k0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int m = tx + TX * j;
          const float p = keep(q0 + m, kj, S, causal, window)
                              ? expf(s[i][j] * scale - slse[m])
                              : 0.f;
          spt[(ty * RM + i) * LDP + m] = p;
          sdst[(ty * RM + i) * LDP + m] = p * (dp[i][j] - sdelta[m]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int m = 0; m < BT; ++m) {
        float pt[RM], dst[RM], qq[CJ], gg[CJ];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pt[i] = spt[(ty * RM + i) * LDP + m];
          dst[i] = sdst[(ty * RM + i) * LDP + m];
        }
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          qq[c] = sq[m * LD + tx + TX * c];
          gg[c] = sdo[m * LD + tx + TX * c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            acc_v[i][c] = fmaf(pt[i], gg[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dst[i], qq[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty * RM + i;
    if (kj >= S) continue;
    const long long row = ((long long)kj * KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = tx + TX * c;
      if (col < D) {
        store(dk + row + col, acc_k[i][c] * scale);
        store(dv + row + col, acc_v[i][c]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dq(const void* const* p, int S, int H, int KVH, int D,
                      const Strides& st, int causal, int window, float scale,
                      cudaStream_t stream) {
  const int smem = (int)((4 * BT * (DP + 1) + BT * LDP) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BT - 1) / BT, H);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])), S, H, H / KVH, D, st, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* const* p, int S, int H, int KVH, int D,
                       const Strides& st, int causal, int window, float scale,
                       cudaStream_t stream) {
  const int smem = (int)((4 * BT * (DP + 1) + 2 * BT * LDP + 2 * BT) *
                         sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BT - 1) / BT, KVH);
  flash_bwd_dkv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<T*>(const_cast<void*>(p[6])),
      static_cast<T*>(const_cast<void*>(p[7])), S, KVH, H / KVH, D, st,
      causal, window, scale);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void* const*, int, int, int, int,
                                 const Strides&, int, int, float,
                                 cudaStream_t);

// The template instances for dtype (0 = f32, 1 = bf16) with head_dim
// padded to 16, 32, 64 or 128.
template <typename T>
Launcher dq_for(int D) {
  return D <= 16 ? &launch_dq<T, 16>
       : D <= 32 ? &launch_dq<T, 32>
       : D <= 64 ? &launch_dq<T, 64>
                 : &launch_dq<T, 128>;
}

template <typename T>
Launcher dkv_for(int D) {
  return D <= 16 ? &launch_dkv<T, 16>
       : D <= 32 ? &launch_dkv<T, 32>
       : D <= 64 ? &launch_dkv<T, 64>
                 : &launch_dkv<T, 128>;
}

bool bad_args(int S, int H, int KVH, int D, int dtype) {
  return S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || D < 1 || D > 128 ||
         (dtype != 0 && dtype != 1);
}

Strides to_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
}

}  // namespace

extern "C" {

// q and dout (S, H, D), k and v (S, KVH, D), with unit stride along D and
// the row and head strides in `strides` (elements: q, k, v, dout, each
// row then head); lse and delta (H, S) f32 contiguous; dq written (S, H,
// D) contiguous in q's type. dtype: 0 = f32, 1 = bf16. window <= 0 means
// none. Returns the CUDA error of the launch (0 on success).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int S, int H, int KVH, int D,
                 const long long* strides, int causal, int window,
                 float scale, int dtype, void* stream) {
  if (bad_args(S, H, KVH, D, dtype)) return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, dout, lse, delta, dq};
  const Launcher f = dtype == 0 ? dq_for<float>(D) : dq_for<__nv_bfloat16>(D);
  return (int)f(
      p, S, H, KVH, D, to_strides(strides), causal, window, scale,
      static_cast<cudaStream_t>(stream));
}

// As flash_bwd_dq; dk and dv written (S, KVH, D) contiguous in k's type,
// each the sum over the H / KVH query heads that share the KV head.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int S, int H, int KVH, int D,
                  const long long* strides, int causal, int window,
                  float scale, int dtype, void* stream) {
  if (bad_args(S, H, KVH, D, dtype)) return (int)cudaErrorInvalidValue;
  const void* p[] = {q, k, v, dout, lse, delta, dk, dv};
  const Launcher f =
      dtype == 0 ? dkv_for<float>(D) : dkv_for<__nv_bfloat16>(D);
  return (int)f(
      p, S, H, KVH, D, to_strides(strides), causal, window, scale,
      static_cast<cudaStream_t>(stream));
}

const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
