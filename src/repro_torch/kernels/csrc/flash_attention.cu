// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of the JAX reference
// (src/repro/kernels/flash_attention.py):
//   flash_fwd_kernel     <- _flash_kernel          (launched by flash_attention_fwd)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (launched by flash_attention_bwd)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (launched by flash_attention_bwd)
//
// Layout: q, o, do (B, H, S, HD); k, v, dk, dv (B, Hkv, S, HD); lse, delta
// (B, H, S) fp32; kv_len (B,) int32.  All row-major and contiguous.  GQA:
// query head h reads kv head h / (H / Hkv).  Inputs are fp32 or bf16;
// every product and sum is accumulated in fp32.
//
// Masks, as in the reference: key k is visible to query q when
// k < kv_len[b], and (causal) q >= k, and (window > 0) q - k < window.
// Trip counts are clamped as in the TPU kernels: the forward and dq loops
// stop at the causal bound and at ceil(kv_len / BK), a q-tile that starts
// at or past kv_len does no work (its rows come out as 0), and the dk/dv
// loop runs from the causal lower bound to ceil(kv_len / BQ), with a
// k-tile wholly past kv_len skipped (dk = dv = 0 there).  Output rows at
// or past kv_len are otherwise unspecified; dk and dv are exactly 0 there.
//
// What bounds them: at the training path's shapes (B=8, H=12, HD=64,
// S ~ 400, fp32) each kernel does 4-8 * HD FLOPs per visible (q, k) pair
// on O(S * HD) bytes per head, far above the card's ops-per-byte line, so
// the bound is arithmetic.  These first versions compute in fp32 on the
// CUDA cores (no TF32: the model is fp32 and must match the reference to
// fp32 tolerance), so their ceiling is the fp32 FMA rate, not the tensor
// cores.  Design: one CTA of 256 threads per (b, h, 64-row tile); the
// other side's 64-row tiles stream through shared memory; each thread
// owns a 4 x 4 block of the 64 x 64 score tile and a 4 x HD/16 block of
// the output, so every shared-memory operand is reused 4 times from
// registers.  Rows are padded by one float so column walks hit distinct
// banks.  The (64 x 64) score tile never leaves shared memory, so the
// residuals the backward needs stay O(S): q, k, v, o and lse.
// wgmma / TMA versions are later work.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 64;              // key rows per tile
constexpr int NT = 256;             // threads per CTA: 16 x 16, 4 x 4 each
constexpr float NEG_BIG = -FLT_MAX; // finfo(float32).min, the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + R) of an (S, HD) matrix into shared memory with row
// stride LD, as fp32, zero past S
template <typename T, int R, int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < R * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int g = row0 + r;
    dst[r * LD + d] = g < S ? to_f(src[(size_t)g * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int g = row0 + r;
    dst[r] = g < S ? src[g] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int kvl, int causal, int window) {
  bool ok = kp < kvl;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// reductions over the 16 threads that share a row (one half-warp: lanes
// differ only in their low 4 bits)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// forward trip count over key tiles for the q-tile starting at q0
__device__ __forceinline__ int key_tiles(int q0, int S, int kvl, int causal) {
  int n = (S + BK - 1) / BK;
  if (causal) n = min(n, (q0 + BQ + BK - 1) / BK);
  n = min(n, (kvl + BK - 1) / BK);
  return q0 >= kvl ? 0 : n;
}

// ---------------------------------------------------------------------------
// K1: forward.  o = softmax(q k^T * scale) v with an online softmax over
// key tiles; lse = m + log(l) per row.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int S, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LD
  float* sK = sQ + BQ * LD;         // BK x LD
  float* sV = sK + BK * LD;         // BK x LD
  float* sP = sV + BK * LD;         // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int kvl = kv_len[b];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = ((size_t)b * H + h) * S * HD;
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;
  const int n_kt = key_tiles(q0, S, kvl, causal);

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  load_tile<T, BQ, HD, LD>(sQ, q + qoff, q0, S);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // the previous tile's reads are done
    load_tile<T, BK, HD, LD>(sK, k + koff, k0, S);
    load_tile<T, BK, HD, LD>(sV, v + koff, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        s[i][j] = visible(qp, kp, kvl, causal, window) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // m stays finite (>= NEG_BIG), so exp never sees inf - inf
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);   // 0 where masked
        sP[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[qoff + (size_t)qp * HD + tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0) lse[((size_t)b * H + h) * S + qp] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// K2: dq.  p = exp(s - lse) under the forward's masks,
// ds = p * (dp - delta) * scale with dp = do v^T, dq = ds k.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_len, T* __restrict__ dq,
                    int H, int Hkv, int S, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LD
  float* sDO = sQ + BQ * LD;        // BQ x LD
  float* sK = sDO + BQ * LD;        // BK x LD
  float* sV = sK + BK * LD;         // BK x LD
  float* sDS = sV + BK * LD;        // BQ x (BK + 1)
  float* sL = sDS + BQ * (BK + 1);  // BQ
  float* sD = sL + BQ;              // BQ

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int kvl = kv_len[b];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = ((size_t)b * H + h) * S * HD;
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;
  const size_t roff = ((size_t)b * H + h) * S;
  const int n_kt = key_tiles(q0, S, kvl, causal);

  load_tile<T, BQ, HD, LD>(sQ, q + qoff, q0, S);
  load_tile<T, BQ, HD, LD>(sDO, dout + qoff, q0, S);
  load_rows(sL, lse + roff, q0, S);
  load_rows(sD, delta + roff, q0, S);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, HD, LD>(sK, k + koff, k0, S);
    load_tile<T, BK, HD, LD>(sV, v + koff, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * LD + d];
        gv[i] = sDO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, kvl, causal, window)
                            ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sDS[r * (BK + 1) + c] = p * (dp[i][j] - sD[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] += dsv[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[qoff + (size_t)qp * HD + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv for one kv head.  The TPU kernel writes dk/dv per query head
// and sums the GQA group outside; here the CTA loops over the group's
// query heads and sums in registers, so dk/dv come out per kv head.
// dv = p^T do, dk = ds^T q with p, ds as in K2, masked additionally by
// q < kv_len.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, T* __restrict__ dk,
                     T* __restrict__ dv,
                     int H, int Hkv, int S, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;                 // BK x LD
  float* sV = sK + BK * LD;         // BK x LD
  float* sQ = sV + BK * LD;         // BQ x LD
  float* sDO = sQ + BQ * LD;        // BQ x LD
  float* sPT = sDO + BQ * LD;       // BK x (BQ + 1): p transposed
  float* sDST = sPT + BK * (BQ + 1);// BK x (BQ + 1): ds transposed
  float* sL = sDST + BK * (BQ + 1); // BQ
  float* sD = sL + BQ;              // BQ

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int kvl = kv_len[b];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;

  const int lo = causal ? k0 / BQ : 0;
  const int hi = k0 >= kvl ? 0 : min((S + BQ - 1) / BQ, (kvl + BQ - 1) / BQ);

  float gk[4][DC], gv[4][DC];       // rows: keys ty*4+i; cols: tx+16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) gk[i][j] = gv[i][j] = 0.f;

  load_tile<T, BK, HD, LD>(sK, k + koff, k0, S);
  load_tile<T, BK, HD, LD>(sV, v + koff, k0, S);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t qoff = ((size_t)b * H + h) * S * HD;
    const size_t roff = ((size_t)b * H + h) * S;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();
      load_tile<T, BQ, HD, LD>(sQ, q + qoff, q0, S);
      load_tile<T, BQ, HD, LD>(sDO, dout + qoff, q0, S);
      load_rows(sL, lse + roff, q0, S);
      load_rows(sD, delta + roff, q0, S);
      __syncthreads();

      float s[4][4], dp[4][4];      // transposed tiles: [key i][query j]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * LD + d];
          vv[i] = sV[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * LD + d];
          ov[j] = sDO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * ov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qp = q0 + r;
          const bool ok = qp < kvl && visible(qp, k0 + c, kvl, causal, window);
          const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
          sPT[c * (BQ + 1) + r] = p;
          sDST[c * (BQ + 1) + r] = p * (dp[i][j] - sD[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pt[4], dst[4], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt[i] = sPT[(ty * 4 + i) * (BQ + 1) + r];
          dst[i] = sDST[(ty * 4 + i) * (BQ + 1) + r];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          ov[j] = sDO[r * LD + tx + 16 * j];
          qv[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            gv[i][j] += pt[i] * ov[j];
            gk[i][j] += dst[i] * qv[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[koff + (size_t)kp * HD + tx + 16 * j] = from_f<T>(gk[i][j]);
      dv[koff + (size_t)kp * HD + tx + 16 * j] = from_f<T>(gv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: shared-memory sizes, launch, head-dim / dtype dispatch
// ---------------------------------------------------------------------------
template <int HD> constexpr size_t fwd_smem() {
  return sizeof(float) * (BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1));
}
template <int HD> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1) + 2 * BQ);
}
template <int HD> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_len;
  void *o, *lse_out, *dq, *dk, *dv;
  int B, H, Hkv, S, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t run_fwd(const Args& a) {
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = prepare(kern, fwd_smem<HD>());
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, fwd_smem<HD>(), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.kv_len,
      (T*)a.o, (float*)a.lse_out, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<T, HD>;
  cudaError_t e = prepare(kern, dq_smem<HD>());
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, dq_smem<HD>(), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (T*)a.dq, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  cudaError_t e = prepare(kern, dkv_smem<HD>());
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + BK - 1) / BK, a.Hkv, a.B);
  kern<<<grid, NT, dkv_smem<HD>(), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (T*)a.dk, (T*)a.dv, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// which kernel: 0 forward, 1 dq, 2 dk/dv
template <typename T, int HD>
cudaError_t run(int which, const Args& a) {
  if (which == 0) return run_fwd<T, HD>(a);
  if (which == 1) return run_dq<T, HD>(a);
  return run_dkv<T, HD>(a);
}

template <typename T>
cudaError_t run_hd(int which, int hd, const Args& a) {
  switch (hd) {
    case 16: return run<T, 16>(which, a);
    case 32: return run<T, 32>(which, a);
    case 64: return run<T, 64>(which, a);
    case 128: return run<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int which, int hd, int dtype, const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)run_hd<float>(which, hd, a);
  if (dtype == 1) return (int)run_hd<__nv_bfloat16>(which, hd, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// Each returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_len,
                         void* o, void* lse, int B, int H, int Hkv, int S, int hd,
                         int causal, int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.kv_len = kv_len; a.o = o; a.lse_out = lse;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return dispatch(0, hd, dtype, a);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* kv_len, void* dq,
                            int B, int H, int Hkv, int S, int hd, int causal, int window,
                            float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.kv_len = kv_len; a.dq = dq;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return dispatch(1, hd, dtype, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_len,
                             void* dk, void* dv, int B, int H, int Hkv, int S, int hd,
                             int causal, int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.kv_len = kv_len; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return dispatch(2, hd, dtype, a);
}
