// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ with a C
// interface (loaded with ctypes by fiber_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel fiber_tpu/ops/pallas_attention.py:_fwd_kernel,
// with its block-skip predicate _run_window and elementwise mask
// _keep_mask: exact causal / non-causal attention by online softmax,
// grouped-query heads (KV head = h / (H / KVH)), optional causal sliding
// window, -1e30 as the masked score, a fully masked row takes l = 0 -> 1,
// and lse = m + log l is written as (H, S) f32 beside O.
//
// What bounds it on this card: at the shapes the port runs (S = 16384,
// head_dim 32 or 64) attention does ~S/2 multiply-adds per byte it must
// move, far above the H100's ridge, so it is bound by arithmetic. This
// first version does that arithmetic as f32 FMA on the CUDA cores (67
// TFLOP/s peak), which also meets the f32 parity bound that TF32 tensor
// cores could not; wgmma and TMA are later work.
//
// Design. One thread block owns one (query head, 64-row query tile). The
// TPU kernel's sequential innermost grid axis (the KV sweep, which carried
// m, l and acc in VMEM scratch from step to step) becomes a loop inside
// the block, because CUDA blocks share no state. Q stays in shared memory
// for the whole sweep; each 64-row K and V tile is staged in shared memory
// as f32 (bf16 is widened on load); m, l and the output accumulator stay
// in registers. 256 threads form a 16 x 16 grid: a thread owns 4 query
// rows, 4 score columns of the tile and head_dim/16 output columns, and
// the 16 threads of a row group reduce the row max and sum by warp
// shuffles. Tiles entirely above the causal diagonal, or entirely older
// than the window, are never visited (the loop bounds are _run_window's
// predicate); boundary and ragged tiles mask elementwise, so S need not be
// a multiple of the tile. Shared-memory rows have an odd stride, so the
// column walks are free of bank conflicts. q, k and v are read in the
// public (S, heads, head_dim) layout through their strides, so the caller
// makes no transposed copies; O is written contiguous (S, H, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // key/value rows per tile
constexpr int TX = 16;          // threads along the tile's columns
constexpr int TY = 16;          // threads along the tile's rows
constexpr int NT = TX * TY;     // threads per block
constexpr int RM = BM / TY;     // query rows per thread
constexpr int RN = BN / TX;     // score columns per thread
constexpr int LDP = BN + 1;     // row stride of the probability tile
constexpr float kNegInf = -1e30f;
static_assert(BM == BN, "load_tile copies BM rows for Q, K and V alike");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copies a (rows x D) tile starting at sequence row `row0` into shared
// memory as f32 with row stride DP + 1; rows past S and columns past D
// are zero, so they add nothing to the dot products.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S, int D,
                                          long long ss) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < BM * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S && c < D) x = to_f32(src[s * ss + c]);
    dst[r * LD + c] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int group, int D,
                 long long q_ss, long long q_sh, long long k_ss,
                 long long k_sh, long long v_ss, long long v_sh, int causal,
                 int window, float scale) {
  constexpr int LD = DP + 1;
  constexpr int CJ = DP / TX;   // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;             // BM x LD
  float* sk = sq + BM * LD;     // BN x LD
  float* sv = sk + BN * LD;     // BN x LD
  float* sp = sv + BN * LD;     // BM x LDP

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int h = blockIdx.y;
  const int kvh = h / group;
  // Heaviest causal tiles (the last query rows) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;

  load_tile<T, DP>(sq, q + h * q_sh, q0, S, D, q_ss);
  const T* kh = k + kvh * k_sh;
  const T* vh = v + kvh * v_sh;

  float m[RM], l[RM], acc[RM][CJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // _run_window as loop bounds: causal tiles end at the diagonal; a
  // window starts at the first tile holding a key some row may attend.
  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BM);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) kv_begin = (lo / BN) * BN;
    }
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done with sk/sv/sp
    load_tile<T, DP>(sk, kh, k0, S, D, k_ss);
    load_tile<T, DP>(sv, vh, k0, S, D, v_ss);
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sq[(ty * RM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = sk[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      unsigned keep = 0;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kj = k0 + tx + TX * j;
        bool kp = kj < S;
        if (causal) kp = kp && qi >= kj && (window <= 0 || qi - kj < window);
        s[i][j] = kp ? s[i][j] * scale : kNegInf;
        keep |= (kp ? 1u : 0u) << j;
        mt = fmaxf(mt, s[i][j]);
      }
      // The 16 threads of a row group are 16 neighbouring lanes.
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = (keep >> j & 1u) ? expf(s[i][j] - m_new) : 0.f;
        sp[(ty * RM + i) * LDP + tx + TX * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float p[RM], vv[CJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = sp[(ty * RM + i) * LDP + n];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = sv[n * LD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((long long)qi * H + h) * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = tx + TX * c;
      if (col < D) store(orow + col, acc[i][c] / li);
    }
    if (tx == 0) lse[(long long)h * S + qi] = m[i] + logf(li);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int S, int H, int KVH, int D, long long q_ss,
                   long long q_sh, long long k_ss, long long k_sh,
                   long long v_ss, long long v_sh, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int smem =
      (int)((3 * BM * (DP + 1) + BM * LDP) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, H);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, H / KVH, D, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int S, int H, int KVH, int D, long long q_ss,
                     long long q_sh, long long k_ss, long long k_sh,
                     long long v_ss, long long v_sh, int causal, int window,
                     float scale, cudaStream_t st) {
  if (D <= 16)
    return launch<T, 16>(q, k, v, o, lse, S, H, KVH, D, q_ss, q_sh, k_ss,
                         k_sh, v_ss, v_sh, causal, window, scale, st);
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, S, H, KVH, D, q_ss, q_sh, k_ss,
                         k_sh, v_ss, v_sh, causal, window, scale, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, S, H, KVH, D, q_ss, q_sh, k_ss,
                         k_sh, v_ss, v_sh, causal, window, scale, st);
  return launch<T, 128>(q, k, v, o, lse, S, H, KVH, D, q_ss, q_sh, k_ss,
                        k_sh, v_ss, v_sh, causal, window, scale, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, lse, S, H, KVH, D, q_ss, q_sh,
                                k_ss, k_sh, v_ss, v_sh, causal, window,
                                scale, st);
  return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse, S, H, KVH, D, q_ss,
                                      q_sh, k_ss, k_sh, v_ss, v_sh, causal,
                                      window, scale, st);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
