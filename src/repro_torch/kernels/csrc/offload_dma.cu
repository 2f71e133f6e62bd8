// Double-buffered copy for Hopper (sm_90a): a value-identical copy of a
// flat array, chunk by chunk, through a shared-memory ring fed and
// drained by the Tensor Memory Accelerator's bulk copies.
//
// Replaces the Pallas TPU kernel of the JAX reference
// (src/repro/kernels/offload_dma.py):
//   dma_copy_kernel  <- _dma_copy_kernel  (launched by dma_copy)
//
// What it computes: dst[i] = src[i] for every byte of an nbytes-long
// array, so every dtype copies alike.  The array is cut into chunks of
// chunk_bytes (the wrapper's chunk_elems times the element size); the
// last chunk is short.  The reference zero-pads that tail to a whole
// chunk and slices it off again; here the tail is simply not copied
// past the end, which gives the same values without the padded copy.
//
// Design: the TPU kernel walks the chunks in one grid cell and overlaps
// the fetch of chunk i+1 into one VMEM slot with the drain of chunk i
// from the other.  Here a persistent grid of one CTA per SM walks the
// chunks (chunk c to CTA c mod grid), and each CTA streams its chunks in
// 16 KB tiles through an eight-slot ring (128 KB).  One thread issues
// every copy: cp.async.bulk global -> shared completing on the slot's
// mbarrier (expect_tx of the tile's bytes), then, once that barrier's
// phase completes, cp.async.bulk shared -> global as one bulk group.
// Before a slot is refilled, cp.async.bulk.wait_group.read 2 makes sure
// the store that last read it has finished reading, so six loads and two
// stores are in flight per CTA and no thread touches the data.  The ring
// is the fastest of a sweep of slots, tile sizes, CTAs per SM and stores
// in flight at the logits shape (launch/dma_sweep.py; PERF.md).  Bulk
// copies need 16-byte aligned addresses and sizes: where src and dst
// share their offset modulo 16, each chunk's 16-byte-aligned middle goes
// through the ring and its 0-15-byte ends are copied byte by byte by a
// second warp; otherwise every byte is copied one by one.
//
// What bounds it: it moves 2 * nbytes and computes nothing, so the bound
// is the card's memory rate (3.35 TB/s on an H100 SXM).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;                 // threads per CTA
constexpr int STAGES = 8;               // ring slots
constexpr int TILE = 16384;             // bytes per slot
constexpr int CTAS_PER_SM = 1;          // 128 KB of ring each
constexpr int LAG = 2;                  // stores in flight before a slot is refilled
constexpr int ALIGN = 16;               // bulk copies' alignment

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(unsigned smem, const void* gmem, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem), "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* gmem, unsigned smem, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
               "r"(smem), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct Layout {
  long long nbytes, chunk_bytes, n_chunks;
  unsigned head;   // (16 - src % 16) % 16: bytes before src's first 16-byte boundary
};

// chunk c's bytes [c0, c1) and its 16-byte-aligned middle [a0, a1)
__device__ __forceinline__ void chunk_span(const Layout& L, long long c, long long& c0,
                                           long long& c1, long long& a0, long long& a1) {
  c0 = c * L.chunk_bytes;
  c1 = min(c0 + L.chunk_bytes, L.nbytes);
  const long long first =
      c0 <= L.head ? L.head : L.head + (c0 - L.head + ALIGN - 1) / ALIGN * ALIGN;
  a0 = min(first, c1);
  a1 = a0 + (c1 - a0) / ALIGN * ALIGN;
}

// walks this CTA's tiles in order: the aligned middles of chunks
// blockIdx.x, blockIdx.x + gridDim.x, ..., cut into TILE-byte pieces
struct Tiles {
  long long c, off, end;
  __device__ Tiles() : c((long long)blockIdx.x - gridDim.x), off(0), end(0) {}
  __device__ bool next(const Layout& L, long long& at, unsigned& bytes) {
    while (off >= end) {
      c += gridDim.x;
      if (c >= L.n_chunks) return false;
      long long c0, c1;
      chunk_span(L, c, c0, c1, off, end);
    }
    at = off;
    bytes = (unsigned)min((long long)TILE, end - off);
    off += bytes;
    return true;
  }
};

__global__ void __launch_bounds__(NT)
dma_copy_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                Layout L, int bulk) {
  if (!bulk) {   // src and dst differ in alignment: byte by byte
    for (long long c = blockIdx.x; c < L.n_chunks; c += gridDim.x) {
      const long long c0 = c * L.chunk_bytes, c1 = min(c0 + L.chunk_bytes, L.nbytes);
      for (long long i = c0 + threadIdx.x; i < c1; i += NT) dst[i] = src[i];
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char ring[];   // STAGES x TILE
  __shared__ __align__(8) unsigned long long full[STAGES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {   // each chunk's unaligned ends, [c0, a0) and [a1, c1)
    for (long long c = blockIdx.x; c < L.n_chunks; c += gridDim.x) {
      long long c0, c1, a0, a1;
      chunk_span(L, c, c0, c1, a0, a1);
      if (c0 + lane < a0) dst[c0 + lane] = src[c0 + lane];
      if (a1 + lane < c1) dst[a1 + lane] = src[a1 + lane];
    }
    return;
  }
  if (threadIdx.x != 0) return;

  const unsigned ring0 = smem_addr(ring), bar0 = smem_addr(&full[0]);
  Tiles loads, stores;
  long long at;
  unsigned bytes;
  auto load = [&](long long t) {   // tile t into its slot, if there is one
    long long from;
    unsigned n;
    if (!loads.next(L, from, n)) return;
    const int s = (int)(t % STAGES);
    mbar_expect_tx(bar0 + 8 * s, n);
    bulk_load(ring0 + s * TILE, src + from, n, bar0 + 8 * s);
  };
  for (int t = 0; t < STAGES; ++t) load(t);
  for (long long t = 0; stores.next(L, at, bytes); ++t) {
    const int s = (int)(t % STAGES);
    mbar_wait(bar0 + 8 * s, (unsigned)((t / STAGES) & 1));
    bulk_store(dst + at, ring0 + s * TILE, bytes);
    if (t >= LAG) {
      bulk_wait_read<LAG>();    // the store of tile t - LAG has read its slot
      load(t - LAG + STAGES);
    }
  }
  bulk_wait_all();
}

}  // namespace

// Copies nbytes from src to dst in chunks of chunk_bytes on ``stream``.
// Returns the launch's cudaError_t (0 on success).
extern "C" int dma_copy(const void* src, void* dst, long long nbytes,
                        long long chunk_bytes, void* stream) {
  if (nbytes <= 0 || chunk_bytes <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src), d = reinterpret_cast<uintptr_t>(dst);
  Layout L{nbytes, chunk_bytes, (nbytes + chunk_bytes - 1) / chunk_bytes,
           (unsigned)((ALIGN - s % ALIGN) % ALIGN)};
  const int bulk = s % ALIGN == d % ALIGN;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long max_grid = (long long)CTAS_PER_SM * sms;
  const unsigned grid = (unsigned)(L.n_chunks < max_grid ? L.n_chunks : max_grid);
  const int smem = bulk ? STAGES * TILE : 0;
  if (bulk) {
    err = cudaFuncSetAttribute(dma_copy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dma_copy_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), L, bulk);
  return (int)cudaGetLastError();
}
