// Ring exchange for Hopper (sm_90a), plain CUDA C++ with a C interface
// (loaded with ctypes by fiber_tpu_torch/ops/dma_ring.py).
//
// Replaces the TPU kernel fiber_tpu/ops/dma_ring.py:ring_exchange.kernel:
// every rank's copy of each of k arrays moves one step along the mesh
// axis, rank r's block landing on rank (r + 1) mod n, bit for bit (the
// semantics of lax.ppermute with [(i, (i + 1) % n)]). The wrapper hands
// this kernel one (source, destination, bytes) pair per (rank, array).
//
// What bounds it on this card: it is pure data movement, so its least
// time is the bytes it must move, each input read once and each output
// written once, over the 3.35 TB/s of HBM3. At the port's smallest shapes
// (a few hundred KB) the launch itself dominates.
//
// Design. The TPU kernel starts every remote DMA before it waits on any,
// so K and V share the interconnect. Here one launch covers every pair:
// blockIdx.y picks the pair, and the blocks along x grid-stride over its
// bytes with 16-byte vector loads and stores where the source, the
// destination and the size allow it, then copy the remaining tail bytes
// one at a time (a pair whose pointers are not 16-byte aligned goes byte
// by byte). The pair table travels by value in the kernel's parameters,
// so the launch needs no device allocation; kMaxPairs bounds it and the
// wrapper raises beyond it.
//
// No barrier or semaphore. The TPU kernel's neighbour barrier guards a
// remote write into a buffer that the neighbour may still be reading.
// Here the mesh's ranks share one device and every destination is a
// fresh allocation made by the wrapper, ordered after its readers and
// writers by PyTorch's one stream, so stream order gives the same
// guarantee. Ranks on several cards (peer copies over NVLink) are later
// work, and the wrapper refuses them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPairs = 64;
constexpr int kThreads = 256;
// Blocks along x per pair: enough to keep every SM busy on one large
// pair, few enough that each thread moves several vectors.
constexpr int kMaxBlocksPerPair = 512;
constexpr long long kBytesPerBlock = kThreads * 16LL * 4;

struct Pair {
  const unsigned char* src;
  unsigned char* dst;
  long long nbytes;
};

struct Table {
  Pair pairs[kMaxPairs];
};

__global__ void __launch_bounds__(kThreads)
ring_exchange_kernel(const __grid_constant__ Table table) {
  const Pair p = table.pairs[blockIdx.y];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(p.src) |
        reinterpret_cast<std::uintptr_t>(p.dst)) & 15) == 0;
  const long long nvec = aligned ? p.nbytes / 16 : 0;
  const uint4* __restrict__ src4 = reinterpret_cast<const uint4*>(p.src);
  uint4* __restrict__ dst4 = reinterpret_cast<uint4*>(p.dst);
  for (long long i = tid; i < nvec; i += stride) dst4[i] = __ldg(src4 + i);
  for (long long i = nvec * 16 + tid; i < p.nbytes; i += stride)
    p.dst[i] = p.src[i];
}

}  // namespace

extern "C" {

// srcs[i] -> dsts[i], nbytes[i] bytes each, for i < npairs, all on the
// current device, in one launch on `stream`. Returns the CUDA error of
// the launch (0 on success); cudaErrorInvalidValue for a table the
// kernel does not take. A table of zero bytes launches nothing.
int ring_exchange(const void* const* srcs, void* const* dsts,
                  const long long* nbytes, int npairs, void* stream) {
  if (npairs < 0 || npairs > kMaxPairs) return (int)cudaErrorInvalidValue;
  Table table = {};
  long long most = 0;
  for (int i = 0; i < npairs; ++i) {
    if (nbytes[i] < 0) return (int)cudaErrorInvalidValue;
    table.pairs[i].src = static_cast<const unsigned char*>(srcs[i]);
    table.pairs[i].dst = static_cast<unsigned char*>(dsts[i]);
    table.pairs[i].nbytes = nbytes[i];
    if (nbytes[i] > most) most = nbytes[i];
  }
  if (most == 0) return (int)cudaSuccess;
  long long bx = (most + kBytesPerBlock - 1) / kBytesPerBlock;
  if (bx > kMaxBlocksPerPair) bx = kMaxBlocksPerPair;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(npairs));
  ring_exchange_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(table);
  return (int)cudaGetLastError();
}

int ring_exchange_max_pairs() { return kMaxPairs; }

const char* ring_exchange_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
