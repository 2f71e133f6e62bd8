// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX reference
// (src/repro/kernels/ssd_scan.py):
//   ssd_scan_kernel  <- _ssd_kernel  (launched by ssd_scan)
//
// Layout (the model's, row-major, contiguous): x, y (B, S, H, P);
// dt (B, S, H); A (H,) fp32; Bm, Cm (B, S, N) shared by the heads;
// kv_len (B,) int32.  x, Bm, Cm and y share one dtype (fp32 or bf16); dt
// is fp32 or bf16.  S is a multiple of the chunk length Q.  Every product
// and sum is taken in fp32.
//
// What it computes, per (b, h), from a zero (P, N) state, chunk by chunk
// (la = cumsum(dt * A) within the chunk, dt zeroed at positions >= kv_len
// so padding never enters the state):
//   y     = (C B^T o L o dt) x + exp(la) o (C state^T),
//           L[i][j] = exp(la_i - la_j) for i >= j, 0 above the diagonal
//           (masked before the exp, as the reference);
//   state = exp(la_end) state + (x o exp(la_end - la) dt)^T B.
// Chunks wholly at or past kv_len never run (the chunk loop's trip count
// is ceil(kv_len / Q)) and their rows of y are written as zeros, as the
// TPU kernel pre-zeroes them.  Rows at or past kv_len inside a running
// chunk are unspecified.
//
// Design: the TPU walks the chunks on a sequential grid axis and carries
// the state in VMEM scratch.  Here one CTA of 256 threads owns one
// (b, h) and walks its chunks in a loop, so the state never leaves the
// SM: it lives in shared memory beside the chunk's x, B, C (staged in
// fp32) and the (Q, Q) weight tile, about 130 KB at P = 64, N = 128,
// Q = 64 (dynamic shared memory, raised with cudaFuncSetAttribute).  Each
// of the four products is a register-tiled loop: a thread owns a 4 x 4
// block of the output with strided rows and columns, so each shared
// operand it loads feeds 4 FMAs; rows are padded by one float so the
// column walks hit distinct banks.
//
// What bounds it: at the training path's shape (B = 8, S ~ 400, H = 64,
// P = 64, N = 128, Q = 64, bf16) the function does ~2.6 MFLOP per
// position on ~17 KB, far above the card's operations-per-byte line, so
// the bound is arithmetic.  It computes in fp32 FMA on the CUDA cores,
// so its ceiling is the 67 TFLOP/s fp32 rate, not the tensor cores.  It
// also recomputes C B^T for every head (64x the function's 2QN term per
// position), which a redesign on tensor cores would share across heads.

#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;    // threads per CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[i][j] += sum_k a(m_i, k) * b(n_j, k) for the 4 x 4 register tile with
// rows m_i = tm + sm * i and columns n_j = tn + sn * j
template <typename FA, typename FB>
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], int tm, int sm, int tn, int sn,
                                       int K, FA a, FB b) {
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a(tm + sm * i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b(tn + sn * j, k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__host__ __device__ constexpr size_t smem_floats(int P, int N, int Q) {
  return (size_t)P * (N + 1)        // state
         + (size_t)Q * (P + 1)      // x
         + 2 * (size_t)Q * (N + 1)  // B, C
         + (size_t)Q * (Q + 1)      // weights
         + 2 * (size_t)Q;           // dt, la
}

template <typename T, typename TD>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const int* __restrict__ kv_len,
                T* __restrict__ y, int S, int H, int P, int N, int Q) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int LP = P + 1, LN = N + 1, LQ = Q + 1;
  extern __shared__ float smem[];
  float* st = smem;              // (P, N) state, row stride LN
  float* xs = st + P * LN;       // (Q, P) x of the chunk, row stride LP
  float* bs = xs + Q * LP;       // (Q, N) B of the chunk
  float* cs = bs + Q * LN;       // (Q, N) C of the chunk
  float* w = cs + Q * LN;        // (Q, Q) C B^T o L o dt
  float* dts = w + Q * LQ;       // (Q,) dt, zero at or past kv_len
  float* la = dts + Q;           // (Q,) cumsum(dt * A)

  const int kvl = min(max(kv_len[b], 0), S);
  const int n_chunks = S / Q;
  const int n_valid = (kvl + Q - 1) / Q;
  const float a_h = A[h];
  const int tq = Q / 4, tp = P / 4, tn4 = N / 4;

  for (int i = tid; i < P * LN; i += NT) st[i] = 0.f;

  for (int c = 0; c < n_valid; ++c) {
    const int s0 = c * Q;
    for (int idx = tid; idx < Q * P; idx += NT) {
      const int i = idx / P, p = idx - i * P;
      xs[i * LP + p] = to_f(x[((size_t)(b * S + s0 + i) * H + h) * P + p]);
    }
    for (int idx = tid; idx < Q * N; idx += NT) {
      const int i = idx / N, n = idx - i * N;
      const size_t g = (size_t)(b * S + s0 + i) * N + n;
      bs[i * LN + n] = to_f(Bm[g]);
      cs[i * LN + n] = to_f(Cm[g]);
    }
    for (int i = tid; i < Q; i += NT)
      dts[i] = s0 + i < kvl ? to_f(dt[(size_t)(b * S + s0 + i) * H + h]) : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * a_h;
        la[i] = run;
      }
    }
    __syncthreads();
    const float la_end = la[Q - 1];

    // w = (C B^T) o L o dt
    for (int t = tid; t < tq * tq; t += NT) {
      const int tm = t / tq, tn = t - tm * tq;
      float acc[4][4] = {};
      mma4x4(acc, tm, tq, tn, tq, N,
             [&](int i, int k) { return cs[i * LN + k]; },
             [&](int j, int k) { return bs[j * LN + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tm + tq * i, col = tn + tq * j;
          w[r * LQ + col] = r >= col ? acc[i][j] * expf(la[r] - la[col]) * dts[col] : 0.f;
        }
    }
    __syncthreads();

    // y = exp(la) o (C state^T) + w x
    for (int t = tid; t < tq * tp; t += NT) {
      const int tm = t / tp, tn = t - tm * tp;
      float acc[4][4] = {};
      mma4x4(acc, tm, tq, tn, tp, N,
             [&](int i, int k) { return cs[i * LN + k]; },
             [&](int p, int k) { return st[p * LN + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(la[tm + tq * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      mma4x4(acc, tm, tq, tn, tp, Q,
             [&](int i, int k) { return w[i * LQ + k]; },
             [&](int p, int k) { return xs[k * LP + p]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tm + tq * i, p = tn + tp * j;
          y[((size_t)(b * S + s0 + r) * H + h) * P + p] = from_f<T>(acc[i][j]);
        }
    }
    __syncthreads();

    // x_j <- x_j exp(la_end - la_j) dt_j (x is not read again this chunk)
    for (int idx = tid; idx < Q * P; idx += NT) {
      const int i = idx / P, p = idx - i * P;
      xs[i * LP + p] *= expf(la_end - la[i]) * dts[i];
    }
    __syncthreads();

    // state = exp(la_end) state + x^T B; each thread updates only the
    // state entries of its own tile
    const float decay = expf(la_end);
    for (int t = tid; t < tp * tn4; t += NT) {
      const int tm = t / tn4, tn = t - tm * tn4;
      float acc[4][4] = {};
      mma4x4(acc, tm, tp, tn, tn4, Q,
             [&](int p, int k) { return xs[k * LP + p]; },
             [&](int n, int k) { return bs[k * LN + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& s = st[(tm + tp * i) * LN + tn + tn4 * j];
          s = fmaf(decay, s, acc[i][j]);
        }
    }
    __syncthreads();
  }

  // chunks wholly at or past kv_len never ran: their rows of y are zero
  const T zero = from_f<T>(0.f);
  const size_t pad_elems = (size_t)(n_chunks - n_valid) * Q * P;
  for (size_t idx = tid; idx < pad_elems; idx += NT) {
    const int r = n_valid * Q + (int)(idx / P), p = (int)(idx % P);
    y[((size_t)(b * S + r) * H + h) * P + p] = zero;
  }
}

template <typename T, typename TD>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* kv_len, void* y, int B, int S, int H,
                   int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  auto kern = ssd_scan_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const int*>(kv_len),
      static_cast<T*>(y), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t (0 on success); the kernel runs on ``stream``.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, const void* kv_len, void* y, int B, int S,
                        int H, int P, int N, int Q, int x_dtype, int dt_dtype,
                        void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || S % Q || P % 4 || N % 4 || Q % 4)
    return (int)cudaErrorInvalidValue;
  if (smem_floats(P, N, Q) * sizeof(float) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && dt_dtype == 0)
    err = launch<float, float>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N, Q, s);
  else if (x_dtype == 0 && dt_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N, Q, s);
  else if (x_dtype == 1 && dt_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N, Q, s);
  else if (x_dtype == 1 && dt_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N,
                                               Q, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
