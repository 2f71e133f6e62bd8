// Double-buffered copy for Hopper (sm_90a): a value-identical copy of a
// flat array, chunk by chunk, through a two-slot shared-memory ring.
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
// from the other.  A 64-128 KB chunk does not fit twice in a CTA's
// shared memory, so here one CTA owns a chunk and streams it in 16 KB
// tiles through a two-slot ring: cp.async fetches tile i+1 into one slot
// while the threads drain tile i from the other to device memory with
// 16-byte stores.  Each thread drains exactly the bytes it fetched, so
// cp.async.wait_group alone orders the two and no barrier is needed.
// Bytes outside the 16-byte-aligned middle of a chunk (and every byte
// when src or dst is not 16-byte aligned) are copied one by one.
//
// What bounds it: it moves 2 * nbytes and computes nothing, so the bound
// is the card's memory rate (3.35 TB/s on an H100 SXM); several CTAs per
// SM (32 KB of shared memory each) keep enough tiles in flight for it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                  // threads per CTA
constexpr int VEC = 16;                  // bytes per cp.async
constexpr int PER = 4;                   // cp.async per thread per tile
constexpr int TILE = NT * VEC * PER;     // 16 KB per slot

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(NT)
dma_copy_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                long long nbytes, long long chunk_bytes, long long n_chunks, int vec) {
  __shared__ __align__(16) unsigned char ring[2][TILE];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long c0 = c * chunk_bytes;
    const long long c1 = min(c0 + chunk_bytes, nbytes);
    // [c0, a0) and [a1, c1) byte by byte; [a0, a1) through the ring
    long long a0 = c1, a1 = c1;
    if (vec) {
      a0 = min((c0 + VEC - 1) / VEC * VEC, c1);
      a1 = max(c1 / VEC * VEC, a0);
    }
    for (long long i = c0 + threadIdx.x; i < a0; i += NT) dst[i] = src[i];
    for (long long i = a1 + threadIdx.x; i < c1; i += NT) dst[i] = src[i];

    const long long n_tiles = (a1 - a0 + TILE - 1) / TILE;
    auto fetch = [&](long long t, int slot) {
#pragma unroll
      for (int v = 0; v < PER; ++v) {
        const int off = (v * NT + threadIdx.x) * VEC;
        const long long g = a0 + t * TILE + off;
        if (g < a1) cp_async16(&ring[slot][off], src + g);
      }
      cp_async_commit();
    };
    if (n_tiles > 0) fetch(0, 0);
    for (long long t = 0; t < n_tiles; ++t) {
      const int slot = (int)(t & 1);
      if (t + 1 < n_tiles) {
        fetch(t + 1, slot ^ 1);  // in flight while this tile drains
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
#pragma unroll
      for (int v = 0; v < PER; ++v) {
        const int off = (v * NT + threadIdx.x) * VEC;
        const long long g = a0 + t * TILE + off;
        if (g < a1)
          *reinterpret_cast<uint4*>(dst + g) = *reinterpret_cast<const uint4*>(&ring[slot][off]);
      }
    }
  }
}

}  // namespace

// Copies nbytes from src to dst in chunks of chunk_bytes on ``stream``.
// Returns the launch's cudaError_t (0 on success).
extern "C" int dma_copy(const void* src, void* dst, long long nbytes,
                        long long chunk_bytes, void* stream) {
  if (nbytes <= 0 || chunk_bytes <= 0) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  const int vec = (reinterpret_cast<uintptr_t>(src) % VEC == 0) &&
                  (reinterpret_cast<uintptr_t>(dst) % VEC == 0);
  const unsigned grid = (unsigned)(n_chunks < 65535 ? n_chunks : 65535);
  dma_copy_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nbytes,
      chunk_bytes, n_chunks, vec);
  return (int)cudaGetLastError();
}
