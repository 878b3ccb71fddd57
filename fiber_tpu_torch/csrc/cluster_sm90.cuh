// The thread-block-cluster exchange of the backward kernels' wide route
// (flash_bwd_dq.cu and flash_bwd_dkv.cu, head_dim 257-1024): a cluster of
// n = ceil(head_dim / 128) blocks works on one 64-row tile, block r
// holding depth columns [128 r, 128 r + 128) of its operands. Each block
// computes its partial score tiles (S and dP, or their transposes, over
// its 128 columns of depth) and stores each row straight into the
// receive buffer of the row's owner, through distributed shared memory
// (st.shared::cluster); after a cluster barrier the owner sums the n
// partials of its rows from its own shared memory, in rank order 0..n-1,
// turns them into P and dS and stores those rows into every block of the
// cluster; after a second barrier every block reads the rows it needs
// from its own shared memory. Remote stores are posted, so the latency
// of the network is paid at the barriers, not in loads that wait. Each
// score product is computed once, and each entry of P and dS by exactly
// one block, so every slice uses bit-identical values and the results
// repeat bit for bit without atomics.
//
// Rows of the 64-row tile are owned in runs of own_rows(n) = ceil(64 / n)
// (22 at n = 3, 16 at 4, 8 at 8). A receive buffer holds n runs, one
// from each block (row r own + lr is block r's partial of owned row lr),
// f32, C columns (the other tile's rows) plus 8 of padding a row; the
// finished tile holds all 64 rows in the kernel's operand type (16-bit
// types packed as the products' A operands take them, f32 as it is), C
// + 8 a row. Both paddings keep a warp's fragment accesses free of bank
// conflicts.
//
// The head_dim-256 instances of both kernels (flash_bwd_*_split_kernel)
// pass whole score tiles between the two warp groups of one block in the
// same row layout (scatter_rows, gather_rows), and the dk/dv instance's
// cluster of parts, like the dk/dv wgmma route's at head_dim 129-256,
// sums its partial dk and dv with the same remote stores (st_peer) and
// barriers (cluster_sync).

#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int X_ROWS = 64;   // rows of the exchanged tile
constexpr int X_PAD = 8;     // elements of padding a row, every buffer
constexpr int X_MAX_N = 8;   // largest cluster (portable), 1024 columns

__host__ __device__ constexpr int own_rows(int n) {
  return (X_ROWS + n - 1) / n;
}
// Rows of a receive buffer: n runs of own_rows(n), at the cluster size of
// the route (3 to X_MAX_N blocks) that needs the most.
__host__ __device__ constexpr int recv_rows() {
  int most = 0;
  for (int n = 3; n <= X_MAX_N; ++n)
    most = n * own_rows(n) > most ? n * own_rows(n) : most;
  return most;
}
// Rows of the owned runs, whose lse and delta the dq kernel keeps: the
// smallest cluster's (3 blocks, head_dim 257-384).
constexpr int X_OWN_MAX = own_rows(3);

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Blocks of this block's cluster (1 in a launch without clusters).
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of the cluster's blocks arrives, then waits for all:
// shared-memory writes before it, local and remote, are visible to every
// block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (an address in this block's shared
// memory) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(a)
      : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(x), "f"(y)
               : "memory");
}
__device__ __forceinline__ void st_peer(uint32_t a, const float4& v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_peer(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(a),
               "r"(x), "r"(y)
               : "memory");
}

// Four adjacent entries of a finished tile row into every block of the
// cluster: f32 as they are, a 16-bit type rounded to nearest into two
// packed pairs.
__device__ __forceinline__ void bcast4(float* p, const float (&x)[4],
                                       int n) {
  const float4 v = make_float4(x[0], x[1], x[2], x[3]);
  for (int r = 0; r < n; ++r) st_peer(peer_addr(p, r), v);
}
template <typename T, if_16bit<T> = 0>
__device__ __forceinline__ void bcast4(T* p, const float (&x)[4], int n) {
  const uint32_t lo = pack16<T>(x[0], x[1]), hi = pack16<T>(x[2], x[3]);
  for (int r = 0; r < n; ++r) st_peer(peer_addr(p, r), lo, hi);
}

// Two adjacent entries of a finished tile row, as floats.
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_pair(const f16* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// Two adjacent entries of a tile row from floats: f32 as they are, a
// 16-bit type rounded to nearest into one packed pair.
__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <typename T, if_16bit<T> = 0>
__device__ __forceinline__ void st_pair(T* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack16<T>(x, y);
}

// A warp's 16-row m-tile (rows wrow..) of a C-column partial score tile
// (accumulator fragments) into the receive buffers of the rows' owners:
// `xr` is this block's receive buffer, and the same offset in the owner
// receives; block `rank` writes run `rank` there.
template <int NJ>
__device__ __forceinline__ void push_partial(float* xr,
                                             const float (&acc)[1][NJ][4],
                                             int wrow, int rank, int n,
                                             int lane) {
  constexpr int LX = 8 * NJ + X_PAD;
  const int g = lane >> 2, t = lane & 3;
  const int own = own_rows(n);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    const int o = row / own;
    const uint32_t base =
        peer_addr(xr + (rank * own + row - o * own) * LX + 2 * t, o);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      st_peer(base + 32 * j, acc[0][j][2 * h], acc[0][j][2 * h + 1]);
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// This block's n_own owned rows of the tile: each entry of S and dP is
// the sum of the n blocks' partials in the receive buffers xs and xdp, in
// rank order (from 0, which adds nothing). `finish(lr, c, s, dp)` turns
// the sums (owned row lr, columns c..c + 3) into P and dS and stores them
// (bcast4); NT threads share the work, four columns each.
template <int C, int NT, typename F>
__device__ __forceinline__ void reduce_rows(const float* xs, const float* xdp,
                                            int n_own, int n, F&& finish) {
  constexpr int LX = C + X_PAD;
  const int own = own_rows(n);
  for (int i = threadIdx.x; i < n_own * (C / 4); i += NT) {
    const int lr = i / (C / 4), c = (i % (C / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), dp = s;
    for (int r = 0; r < n; ++r) {
      const int at = (r * own + lr) * LX + c;
      add4(s, *reinterpret_cast<const float4*>(xs + at));
      add4(dp, *reinterpret_cast<const float4*>(xdp + at));
    }
    finish(lr, c, s, dp);
  }
}

// A warp's 16 rows (wrow..) of a finished tile in this block, as the
// accumulator fragments of a 16 x C product (x[0][j]: columns 8j..8j+7),
// the X operand of add_xb.
template <int NJ, typename T>
__device__ __forceinline__ void gather_rows(float (&x)[1][NJ][4],
                                            const T* fin, int wrow,
                                            int lane) {
  constexpr int LF = 8 * NJ + X_PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const T* p = fin + (wrow + g + 8 * h) * LF + 2 * t;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 v = ld_pair(p + 8 * j);
      x[0][j][2 * h] = v.x;
      x[0][j][2 * h + 1] = v.y;
    }
  }
}

// The inverse of gather_rows: a warp's 16 rows of a C-column tile (its
// accumulator fragments) into a tile of this block's shared memory, rows
// C + X_PAD apart, for the warps of another group to gather.
template <int NJ, typename T>
__device__ __forceinline__ void scatter_rows(T* fin,
                                             const float (&x)[1][NJ][4],
                                             int wrow, int lane) {
  constexpr int LF = 8 * NJ + X_PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    T* p = fin + (wrow + g + 8 * h) * LF + 2 * t;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      st_pair(p + 8 * j, x[0][j][2 * h], x[0][j][2 * h + 1]);
  }
}

// The launch of a wide-route kernel: grid, NT threads, smem bytes of
// dynamic shared memory and clusters of n blocks along x. cfg points at
// attr, so it is used where it was made, never copied.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterLaunch(dim3 grid, int nt, int smem, cudaStream_t stream, int n) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(nt);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of n blocks of `kernel` the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <typename K>
int max_clusters(K* kernel, int nt, int smem, int n) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  ClusterLaunch l(dim3(n), nt, smem, nullptr, n);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace
