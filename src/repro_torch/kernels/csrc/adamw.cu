// AdamW for Hopper (sm_90a): the update of one parameter in one in-place
// pass, and the global gradient norm's clip scale over every gradient in
// two launches.
//
// Replaces no TPU kernel: the JAX reference (src/repro/optim/adamw.py)
// leaves the update to XLA, which fuses it.  Eager PyTorch does not: the
// plain version (optim/adamw.py) runs about 22 elementwise kernels per
// parameter and a cast, a square and a reduction per gradient for the
// norm, each reading and writing fp32 temporaries of the parameter's size
// (about 200 bytes of traffic per parameter).
//
// What it computes, per element and in this order, in fp32 with
// round-to-nearest IEEE operations, each as PyTorch's CUDA kernels take
// the plain version's (the wrapper passes the Python scalars rounded to
// fp32, as PyTorch does; an add with alpha is one fma; a division by a
// Python scalar is a product with its reciprocal, taken in double and
// rounded to fp32; ``clip / x`` in Python is ``x.reciprocal() * clip``):
//   g  = float(g) * scale                         (scale read on the device)
//   m' = fma(1 - b1, g, b1 * m)
//   v' = fma(1 - b2, g * g, b2 * v)
//   u  = (m' * (1 / bc1)) / (sqrt(v' * (1 / bc2)) + eps) + wd * float(p)
//   p' = round(float(p) - lr * u)                 (bf16: nearest even)
// and the clip scale = min(1, (1 / (sqrt(sum of g^2) + 1e-9)) * clip)
// over every gradient, written to a device scalar, so the host never
// waits for it.  Given the same scale, the update equals the plain
// version's on the card bit for bit; the scale differs from it in the
// last bits, since the sum of squares is taken in another order.
//
// What bounds it: bytes.  Per bf16 parameter the update reads g, p, m, v
// (12 B) and writes p, m, v (10 B), and the norm reads g once more: 24 B,
// so 67 GB for a 2.8 B-parameter model, 20 ms at 3.35 TB/s; fp32 takes
// 32 B.  The few FLOPs per element are free.  The design keeps every
// intermediate in registers, so each byte crosses the memory bus once:
// - adamw_kernel: a grid-stride loop of 256-thread CTAs, four per SM,
//   each thread moving 16 bytes per load and store (8 bf16 or 4 fp32
//   elements, m and v as two or one float4) where the four pointers share
//   their phase modulo 16 bytes, with a scalar head and tail; otherwise
//   one element at a time.  It writes in place and allocates nothing.
// - adamw_norm_partial_kernel: one launch over every gradient.  The
//   gradients are cut into ``chunk``-element chunks (a table of pointer,
//   length, first chunk and dtype per tensor, in device memory); each CTA
//   walks chunks blockIdx.x, + gridDim.x, ... and each thread sums its
//   elements' squares in fp32 within a chunk and adds that into an fp64
//   running sum, so the order of every addition is fixed by the grid and
//   the CTA size alone: the same bits on every run, with no atomics.  The
//   CTA's sum (shuffles, then its warps in order) goes to partial[cta].
// - adamw_norm_finish_kernel: one CTA adds the partial sums in a fixed
//   tree and writes the scale, or the fp64 sum itself (adamw_norm_sum),
//   which a sharded caller adds over its mesh and turns into the scale
//   with the same kernel over that one partial (adamw_norm_scale): a sum
//   of one term is the term, so on a one-device mesh the scale has the
//   unsharded bits.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                  // threads per CTA
constexpr int CTAS_PER_SM = 4;
constexpr int FINISH_NT = 1024;          // the finishing CTA's threads

struct Hyper {                           // the update's fp32 scalars
  float b1, a1, b2, a2, rbc1, rbc2, eps, wd, lr;   // rbc: 1 / bc
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename P> __device__ __forceinline__ P from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one element: m, v and p in, their new values out
__device__ __forceinline__ float step(float gf, float s, float& m, float& v, float pf,
                                      const Hyper& h) {
  gf = __fmul_rn(gf, s);
  m = __fmaf_rn(h.a1, gf, __fmul_rn(h.b1, m));
  v = __fmaf_rn(h.a2, __fmul_rn(gf, gf), __fmul_rn(h.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.rbc2)), h.eps);
  float u = __fdiv_rn(__fmul_rn(m, h.rbc1), den);
  u = __fadd_rn(u, __fmul_rn(h.wd, pf));
  return __fsub_rn(pf, __fmul_rn(h.lr, u));
}

template <typename P>
__device__ __forceinline__ void step_one(P* __restrict__ p, const P* __restrict__ g,
                                         float* __restrict__ m, float* __restrict__ v,
                                         long long i, float s, const Hyper& h) {
  float mi = m[i], vi = v[i];
  const float pn = step(to_f(g[i]), s, mi, vi, to_f(p[i]), h);
  m[i] = mi;
  v[i] = vi;
  p[i] = from_f<P>(pn);
}

// elements [0, head) and [head + nvec * VEC, n) one at a time, the middle
// VEC at a time through 16-byte loads and stores (nvec = 0: all scalar)
template <typename P>
__global__ void __launch_bounds__(NT)
adamw_kernel(P* __restrict__ p, const P* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, long long n, long long head, long long nvec,
             const float* __restrict__ scale, Hyper h) {
  constexpr int VEC = 16 / sizeof(P);    // 8 bf16 or 4 fp32 elements
  constexpr int MV = VEC / 4;            // float4s of m (and of v) per vector
  const float s = scale ? *scale : 1.f;
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  for (long long k = tid; k < nvec; k += stride) {
    const long long i = head + k * VEC;
    const uint4 gu = *reinterpret_cast<const uint4*>(g + i);
    uint4 pu = *reinterpret_cast<const uint4*>(p + i);
    const P* ge = reinterpret_cast<const P*>(&gu);
    P* pe = reinterpret_cast<P*>(&pu);
    float4 mv[MV], vv[MV];
#pragma unroll
    for (int j = 0; j < MV; ++j) {
      mv[j] = reinterpret_cast<const float4*>(m + i)[j];
      vv[j] = reinterpret_cast<const float4*>(v + i)[j];
    }
    float* mf = reinterpret_cast<float*>(mv);
    float* vf = reinterpret_cast<float*>(vv);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      pe[e] = from_f<P>(step(to_f(ge[e]), s, mf[e], vf[e], to_f(pe[e]), h));
#pragma unroll
    for (int j = 0; j < MV; ++j) {
      reinterpret_cast<float4*>(m + i)[j] = mv[j];
      reinterpret_cast<float4*>(v + i)[j] = vv[j];
    }
    *reinterpret_cast<uint4*>(p + i) = pu;
  }
  const long long tail = head + nvec * VEC;
  for (long long i = tid; i < head; i += stride) step_one(p, g, m, v, i, s, h);
  for (long long i = tail + tid; i < n; i += stride) step_one(p, g, m, v, i, s, h);
}

struct Entry {                           // one gradient of the norm's table
  long long ptr, n, chunk0, bf16;
};

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

template <typename T>
__device__ __forceinline__ float chunk_sum(const T* __restrict__ x, long long e0, long long e1) {
  constexpr int VEC = 16 / sizeof(T);
  float acc = 0.f;
  long long i = e0;
  if (reinterpret_cast<uintptr_t>(x + e0) % 16 == 0) {   // e0: a multiple of chunk, of 8
    const long long nv = (e1 - e0) / VEC;
#pragma unroll 4
    for (long long k = threadIdx.x; k < nv; k += NT) {
      const uint4 xu = *reinterpret_cast<const uint4*>(x + e0 + k * VEC);
      const T* xe = reinterpret_cast<const T*>(&xu);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) part = __fadd_rn(part, sq(to_f(xe[e])));
      acc = __fadd_rn(acc, part);
    }
    i = e0 + nv * VEC;
  }
  for (long long k = i + threadIdx.x; k < e1; k += NT) acc = __fadd_rn(acc, sq(to_f(x[k])));
  return acc;
}

// the CTA's threads' values added in a fixed order; thread 0 gets the sum
template <int THREADS>
__device__ __forceinline__ double cta_sum(double x) {
  __shared__ double warps[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += warps[w];
  return total;
}

__global__ void __launch_bounds__(NT)
adamw_norm_partial_kernel(const Entry* __restrict__ table, int n_tensors, long long n_chunks,
                          long long chunk, double* __restrict__ partial) {
  double acc = 0.0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int lo = 0, hi = n_tensors - 1;      // the last tensor whose chunk0 <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (__ldg(&table[mid].chunk0) <= c) lo = mid; else hi = mid - 1;
    }
    const long long n = __ldg(&table[lo].n), ptr = __ldg(&table[lo].ptr);
    const long long e0 = (c - __ldg(&table[lo].chunk0)) * chunk;
    const long long e1 = e0 + chunk < n ? e0 + chunk : n;
    acc += __ldg(&table[lo].bf16)
               ? chunk_sum(reinterpret_cast<const __nv_bfloat16*>(ptr), e0, e1)
               : chunk_sum(reinterpret_cast<const float*>(ptr), e0, e1);
  }
  const double total = cta_sum<NT>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(FINISH_NT)
adamw_norm_finish_kernel(const double* __restrict__ partial, int n, float clip,
                         float* __restrict__ scale, double* __restrict__ sum) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += FINISH_NT) acc += partial[i];
  const double total = cta_sum<FINISH_NT>(acc);
  if (threadIdx.x == 0 && sum) {
    *sum = total;
  } else if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn((float)total);
    const float r = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-9f)), clip);
    *scale = r > 1.f ? 1.f : r;          // NaN stays NaN, as torch.clamp
  }
}

int sm_count(int& sms) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev]) {
    sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) cached[dev] = sms;
  return 0;
}

bool aligned16(const void* p, long long i, int size) {
  return (reinterpret_cast<uintptr_t>(p) + (uintptr_t)(i * size)) % 16 == 0;
}

template <typename P>
int launch(void* p, const void* g, void* m, void* v, long long n, const void* scale,
           const Hyper& h, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(P);
  // the first element at which all four pointers are 16-byte aligned
  long long head = n, nvec = 0;
  for (long long i = 0; i < VEC && i < n; ++i)
    if (aligned16(p, i, sizeof(P)) && aligned16(g, i, sizeof(P)) && aligned16(m, i, 4) &&
        aligned16(v, i, 4)) {
      head = i;
      nvec = (n - i) / VEC;
      break;
    }
  if (nvec == 0) head = n;
  int sms = 0;
  const int err = sm_count(sms);
  if (err) return err;
  // threads with work: one per vector, or per element where none is
  // aligned (the scalar head and tail are under VEC elements each)
  const long long work = nvec ? (nvec > VEC ? nvec : VEC) : n;
  const long long want = (work + NT - 1) / NT, most = (long long)CTAS_PER_SM * sms;
  const unsigned grid = (unsigned)(want < most ? want : most);
  adamw_kernel<P><<<grid, NT, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, head, nvec, static_cast<const float*>(scale), h);
  return (int)cudaGetLastError();
}

// The partial sums of squares over n_tensors gradients into ``partial``;
// returns the number written (0 where there are no chunks) in ``grid``.
int norm_partials(const void* table, int n_tensors, long long n_chunks, long long chunk,
                  void* partial, int max_ctas, cudaStream_t s, int& grid) {
  grid = 0;
  if (n_tensors < 0 || n_chunks < 0 || chunk <= 0 || chunk % 8 || max_ctas <= 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(sms);
  if (err) return err;
  long long want = (long long)CTAS_PER_SM * sms;
  if (want > max_ctas) want = max_ctas;
  if (want > n_chunks) want = n_chunks;
  grid = (int)want;
  if (grid == 0) return 0;
  adamw_norm_partial_kernel<<<(unsigned)grid, NT, 0, s>>>(
      static_cast<const Entry*>(table), n_tensors, n_chunks, chunk,
      static_cast<double*>(partial));
  return (int)cudaGetLastError();
}

}  // namespace

// Updates n elements of p (dtype 0: fp32, 1: bf16), with its gradient g
// of the same dtype and the fp32 moments m and v, in place on ``stream``;
// ``scale`` is a device fp32 scalar, or null for 1; a1 = 1 - b1, a2 = 1 -
// b2, rbc1 = 1 / bc1, rbc2 = 1 / bc2.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int adamw(void* p, const void* g, void* m, void* v, long long n, int dtype,
                     const void* scale, float b1, float a1, float b2, float a2, float rbc1,
                     float rbc2, float eps, float wd, float lr, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, a1, b2, a2, rbc1, rbc2, eps, wd, lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch<__nv_bfloat16>(p, g, m, v, n, scale, h, s)
               : launch<float>(p, g, m, v, n, scale, h, s);
}

// The clip scale over n_tensors gradients cut into ``chunk``-element
// chunks (a multiple of 8): ``table`` holds, per gradient, its pointer,
// length, first chunk (the chunks of those before it) and dtype (0 fp32,
// 1 bf16) as four int64, in device memory; ``n_chunks`` is the chunks of
// all; ``partial`` has room for ``max_ctas`` doubles.  Writes min(1, clip
// / (norm + 1e-9)) to the fp32 scalar ``scale``.
extern "C" int adamw_norm(const void* table, int n_tensors, long long n_chunks, long long chunk,
                          void* partial, int max_ctas, float clip, void* scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  const int err = norm_partials(table, n_tensors, n_chunks, chunk, partial, max_ctas, s, grid);
  if (err) return err;
  adamw_norm_finish_kernel<<<1, FINISH_NT, 0, s>>>(static_cast<const double*>(partial), grid,
                                                   clip, static_cast<float*>(scale), nullptr);
  return (int)cudaGetLastError();
}

// adamw_norm's sum of squares, in the same order, written to the fp64
// scalar ``sum`` instead of the scale.
extern "C" int adamw_norm_sum(const void* table, int n_tensors, long long n_chunks,
                              long long chunk, void* partial, int max_ctas, void* sum,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  const int err = norm_partials(table, n_tensors, n_chunks, chunk, partial, max_ctas, s, grid);
  if (err) return err;
  adamw_norm_finish_kernel<<<1, FINISH_NT, 0, s>>>(static_cast<const double*>(partial), grid,
                                                   0.f, nullptr, static_cast<double*>(sum));
  return (int)cudaGetLastError();
}

// The clip scale from the fp64 scalar ``sum`` of squares, as adamw_norm
// takes it from its own.
extern "C" int adamw_norm_scale(const void* sum, float clip, void* scale, void* stream) {
  adamw_norm_finish_kernel<<<1, FINISH_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(sum), 1, clip, static_cast<float*>(scale), nullptr);
  return (int)cudaGetLastError();
}
