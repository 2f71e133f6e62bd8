// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of the JAX reference
// (src/repro/kernels/flash_attention.py):
//   flash_fwd_tc_kernel      <- _flash_kernel          (C entry flash_fwd)
//   flash_bwd_dq_tc_kernel   <- _flash_bwd_dq_kernel   (C entry flash_bwd_dq)
//   flash_bwd_dkv_tc_kernel  <- _flash_bwd_dkv_kernel  (C entry flash_bwd_dkv)
// with all three in bf16 at head dim 256 on Hopper's wgmma and TMA
// (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel,
// flash_bwd_dkv_wgmma_kernel, in flash_bwd_wgmma.cuh), and keeps the first fp32 FMA version of each
// (flash_fwd_fma_kernel, flash_bwd_dq_fma_kernel, flash_bwd_dkv_fma_kernel;
// C entries flash_fwd_fma, flash_bwd_dq_fma, flash_bwd_dkv_fma) as a
// second fp32 witness.
//
// Layout: q, o, do (B, H, S, HD); k, v, dk, dv (B, Hkv, S, HD); lse, delta
// (B, H, S) fp32; kv_len (B,) int32.  All row-major and contiguous.  GQA:
// query head h reads kv head h / (H / Hkv).  Inputs are fp32 or bf16;
// every sum is accumulated in fp32.
//
// Masks, as in the reference: key k is visible to query q when
// k < kv_len[b], and (causal) q >= k, and (window > 0) q - k < window.
// Trip counts are clamped as in the TPU kernels: the forward and dq loops
// stop at the causal bound and at ceil(kv_len / BK), a q-tile that starts
// at or past kv_len does no work (its rows come out as 0), and the dk/dv
// loop runs from the causal lower bound to ceil(kv_len / BQ), with a
// k-tile wholly past kv_len skipped (dk = dv = 0 there).  Output rows at
// or past kv_len are otherwise unspecified; dk and dv are exactly 0 there.
// No atomics: every sum has a fixed order that depends on neither S nor
// kv_len, so a padded call with kv_len gives the unpadded call's valid
// rows bit for bit.
//
// What bounds them: at the training path's shapes (B=8, H=12, HD=64,
// S ~ 400, causal, squad lengths) the forward must move 39 MB (inputs
// over the 64-row tiles that hold valid rows, outputs in full) and does
// 4 HD FLOPs per visible (q, k) pair, the dq kernel 48 MB and 6 HD, the
// dk/dv kernel 58 MB and 8 HD; at the bf16 tensor-core rate the bytes
// bound all three (12, 14 and 17 us; chip_smoke.py's time_flash_kernels
// counts them).
//
// The tensor-core kernels.  One CTA of 4 warps per (b, h, 64-row tile);
// each warp owns 16 rows of it and every product is mma.sync.m16n8k16
// with bf16 operands and fp32 accumulators.
// - Precision.  The bert path is fp32 and must match the reference to
//   fp32 tolerance, which one bf16 (8 bits) or TF32 (11 bits) rounding
//   cannot.  So for fp32 inputs every operand -- q, k, v, do and the
//   score tiles p, ds -- is split into bf16 hi + lo = hi + bf16(x - hi)
//   and each product is issued as hi.hi + hi.lo + lo.hi: about 16
//   mantissa bits survive (tests/test_torch_flash_tc.py emulates this
//   arithmetic against the JAX reference).  The forward's q k^T adds
//   lo.lo: a causal tile's rows with few keys carry a score's error
//   into o nearly whole, and without it the fp32 check at stablelm's
//   and gemma3's full shapes (B 8, 32 or 16 heads) missed TOL by 3e-6
//   in 2 of 15 cases on the card.  bf16 inputs are exact and take one
//   product; their p and ds are rounded to bf16 once.
// - Score tiles stay in registers.  The fp32 accumulator of two adjacent
//   m16n8 score tiles has the layout of one m16k16 A operand, so p (the
//   forward), ds (dq) and p^T, ds^T (dk/dv) feed the next product
//   straight from the registers they were computed in.
// - The streamed tiles (k, v in the forward and dq; q, do, lse, delta in
//   dk/dv) are staged by 16-byte cp.async; the copy of tile i+1 overlaps
//   the math on tile i.  Once a tile has landed, the CTA's threads split
//   it together into bf16 hi (and lo) operand tiles in shared memory,
//   rows padded by 16 bytes, from which every warp reads its fragments
//   with ldmatrix (.trans where the operand is stored k-major: v in the
//   forward, k in dq's ds k, and q, do in dk/dv's second products), free
//   of bank conflicts.  Each operand is split once per CTA, not once per
//   warp.  The forward keeps q's fragments in registers, dq keeps q's and
//   do's (up to HD 64; at HD 80 and 128 they would spill, so they are
//   split once into operand tiles); dk/dv splits its k and v tile once.
// - Head dims 16, 32, 64, 80 (5 k-steps of 16), 128 and 256.  At HD 256
//   a warp's 16 rows of every output column (128 fp32 registers a
//   thread; dk/dv holds two such) and the operand tiles (fp32: 270 KB
//   for dq's or dk/dv's four) do not fit, so the fp32 forward, dq and
//   dk/dv kernels split each tile over CTAs that each write 128 output
//   columns (the forward) or 64 (dq and dk/dv) and recompute the scores
//   over all 256; the operands fixed over a CTA's loop (the forward's q,
//   dq's q and do, dk/dv's k and v) are read per k-step from global
//   memory, where L1 and L2 hold them; and the forward's streamed tile
//   is staged by cp.async (dq and dk/dv split it straight from global
//   memory).  fp32 at 256 is on no path.  The score sums keep their
//   order over the 16 k-steps, so the padded-equals-unpadded property
//   holds at every head dim.
// - bf16 at HD 256 (gemma3's attention) runs all three on the Hopper
//   kernels of flash_bwd_wgmma.cuh (flash_fwd_wgmma_kernel,
//   flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel; the same TPU
//   kernels).  At gemma3's shape (B 8, S 448, 16 / 8 heads, causal,
//   squad lengths) the forward must move 79.9 MB, 0.0239 ms at 3.35
//   TB/s, against 8.7 GFLOP, 0.0088 ms at the bf16 rate; dq and dk/dv
//   105 MB each, 0.0314 ms, against 13.1 and 17.4 GFLOP: the bytes
//   bound all three.  The split design above reached 7.4x, 12x and 33x
//   those bounds, computing each tile's scores 2, 2 and 4 times and
//   re-reading operands from global memory per k-step.  Here one CTA of
//   two warpgroups owns a 64-row tile and all 256 output columns: the
//   scores are computed once, on wgmma (m64nNk16) from shared-memory
//   operands that TMA copies in once per CTA (the tile's own k and v,
//   or q and do, or the forward's two q tiles) or per item through a
//   two-stage ring (q and do, or k and v), with 128-byte swizzle; p and
//   ds feed their products from registers.  In the forward each
//   warpgroup owns one query head of the GQA group (gemma3's group is
//   2), both reading the same k and v stages, so k and v cross from
//   device memory once for two heads; each runs s = q k^T, the online
//   softmax and o += p v on its own.  In dq and dk/dv one warpgroup
//   computes s (and p), the other dp (and ds); p crosses between them
//   in shared memory as fp32, so the arithmetic is the split design's.
//   Each output has one owner (o and lse; dv, dk; or half of dq's
//   columns), the GQA group and the tiles are summed in the same fixed
//   order, and there are no atomics.
// - Masks are applied only on tiles that are not wholly visible (the
//   causal diagonal, the kv_len edge, the window's edge).  On the causal
//   diagonal a warp skips the 16-key (forward, dq) or 16-query (dk/dv)
//   steps wholly masked for its 16 rows.
// - All three launch their longest CTAs first under causal masking: the
//   grid's slowest axis walks the forward's and dq's q-tiles from the
//   last and the dk/dv kernel's key tiles from the first, so the short
//   tail of diagonal-only tiles runs last.
// - Costs they keep: three products per pair of operands (fp32); few
//   CTAs of 4 warps per SM (the dk/dv kernel's 107.5 KB of shared memory
//   at HD 64 allows 2), likely too few to hide the products' latency;
//   the fp32 HD-256 split recomputes the scores.  The wgmma kernels keep
//   one CTA of 8 warps per SM (193, 214 and 222 KB of shared memory),
//   each warpgroup waiting on its own products (the forward's softmax
//   does not overlap its next tile's q k^T), and diagonal tiles computed
//   whole.  The forward's grid is B x Hkv x 7 = 448 CTAs at gemma3's
//   shape, 3.4 waves; a GQA group of 1 leaves its warpgroup 1 idle, and
//   a group of 4 reads k and v once per pair of heads.  chip_smoke.py
//   logs each kernel's registers, shared memory and threads.

// The FMA kernels compute in fp32 on the CUDA cores: one CTA of 256
// threads per (b, h, 64-row tile); the other side's 64-row tiles stream
// through shared memory; each thread owns a 4 x 4 block of the 64 x 64
// score tile and a 4 x HD/16 block of the output.  Rows are padded by
// one float so column walks hit distinct banks.  Their ceiling is the
// 67 TFLOP/s fp32 rate.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda.h>            // CUtensorMap and its enums only; libcuda is not linked
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
// K1 on the CUDA cores (fp32 FMA).  o = softmax(q k^T * scale) v with an
// online softmax over key tiles; lse = m + log(l) per row.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
// K2 on the CUDA cores (fp32 FMA): dq.  p = exp(s - lse) under the
// forward's masks, ds = p * (dp - delta) * scale with dp = do v^T,
// dq = ds k.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
// K3 on the CUDA cores (fp32 FMA): dk, dv for one kv head.  The TPU kernel
// writes dk/dv per query head and sums the GQA group outside; here the CTA
// loops over the group's query heads and sums in registers, so dk/dv come
// out per kv head.
// dv = p^T do, dk = ds^T q with p, ds as in K2, masked additionally by
// q < kv_len.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  int* info;   // set: describe the kernel (describe) instead of launching it
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// threads per CTA, dynamic shared memory, registers and local memory a
// thread, into info[0..3]
template <typename Kern>
cudaError_t describe(Kern kern, int threads, size_t smem, int* info) {
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, kern);
  if (e != cudaSuccess) return e;
  info[0] = threads;
  info[1] = (int)smem;
  info[2] = at.numRegs;
  info[3] = (int)at.localSizeBytes;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// the tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

constexpr int NW = 4;               // warps per CTA, 16 rows each
constexpr int TPB = NW * 32;        // threads per CTA
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b for one m16n8k16 tile: bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
// (v0, v1) as a bf16 pair hi and, with SPLIT, the pair of what hi leaves
// out, lo; without SPLIT one rounding to bf16
template <bool SPLIT>
__device__ __forceinline__ void split(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = pack(h);
  if (SPLIT) lo = pack(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
}

// an A operand (m16 x k16) and a B operand (k16 x n8), hi and lo halves
struct FragA { unsigned hi[4], lo[4]; };
struct FragB { unsigned hi[2], lo[2]; };

// two adjacent elements of q (in global memory) as an operand pair:
// fp32 ones are split, bf16 ones are exact and taken as they are
__device__ __forceinline__ void pair_of(const float* p, unsigned& hi, unsigned& lo) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split<true>(x.x, x.y, hi, lo);
}
__device__ __forceinline__ void pair_of(const __nv_bfloat16* p, unsigned& hi, unsigned&) {
  hi = *reinterpret_cast<const unsigned*>(p);
}

// the B operands of two adjacent n8 tiles from bf16 operand rows (hi, and
// lo with SPLIT) by one ldmatrix.x4 each: rows along n (trans = false:
// the operand is stored n-major, as k rows are) or along k (trans = true,
// as v rows are)
__device__ __forceinline__ void load_b(FragB& b0, FragB& b1, const __nv_bfloat16* hi,
                                       const __nv_bfloat16* lo, bool split, bool trans) {
  unsigned r[4];
  if (trans) ldsm_x4_t(r, hi); else ldsm_x4(r, hi);
  b0.hi[0] = r[0]; b0.hi[1] = r[1]; b1.hi[0] = r[2]; b1.hi[1] = r[3];
  if (split) {
    if (trans) ldsm_x4_t(r, lo); else ldsm_x4(r, lo);
    b0.lo[0] = r[0]; b0.lo[1] = r[1]; b1.lo[0] = r[2]; b1.lo[1] = r[3];
  }
}

// d += a b as hi.hi + hi.lo + lo.hi (SPLIT) or one product
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.hi, b.hi[0], b.hi[1]);
  if (SPLIT) {
    mma(d, a.hi, b.lo[0], b.lo[1]);
    mma(d, a.lo, b.hi[0], b.hi[1]);
  }
}

// d += a b as mma3 and lo.lo besides (SPLIT): the forward's scores,
// whose error the few-key rows of a causal tile pass on to o undamped
template <bool SPLIT>
__device__ __forceinline__ void mma4(float (&d)[4], const FragA& a, const FragB& b) {
  mma3<SPLIT>(d, a, b);
  if (SPLIT) mma(d, a.lo, b.lo[0], b.lo[1]);
}

// the A operand of k-step j from the fp32 accumulators of score tiles 2j
// and 2j+1 (their m16n8 layout is the m16k16 operand's)
template <bool SPLIT>
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c0)[4], const float (&c1)[4]) {
  split<SPLIT>(c0[0], c0[1], a.hi[0], a.lo[0]);
  split<SPLIT>(c0[2], c0[3], a.hi[1], a.lo[1]);
  split<SPLIT>(c1[0], c1[1], a.hi[2], a.lo[2]);
  split<SPLIT>(c1[2], c1[3], a.hi[3], a.lo[3]);
}

// sum over the 4 lanes that share a fragment row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// W columns of rows [row0, row0 + 64) of a matrix with row stride SLD
// into shared memory (row stride LD elements) by 16-byte cp.async; rows
// at or past S zero-filled
template <typename T, int W, int LD, int SLD = W>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int row0,
                                           int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = W / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += TPB) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? row0 + r : 0) * SLD + c, ok);
  }
}

// 64 contiguous rows of W elements (rows at or past n_valid read as 0)
// into bf16 operand rows of stride W + 8: hi, and for fp32 lo; all the
// CTA's threads, 16 bytes of the source each
template <typename T, int W>
__device__ __forceinline__ void split_rows(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                           const T* src, int n_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = W / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += TPB) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const bool ok = r < n_valid;
    __nv_bfloat16* dst = hi + r * (W + 8) + c;
    if constexpr (sizeof(T) == 4) {
      const float4 x = ok ? *reinterpret_cast<const float4*>(src + (size_t)r * W + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      uint2 h, l;
      split<true>(x.x, x.y, h.x, l.x);
      split<true>(x.z, x.w, h.y, l.y);
      *reinterpret_cast<uint2*>(dst) = h;
      *reinterpret_cast<uint2*>(lo + (dst - hi)) = l;
    } else {
      *reinterpret_cast<uint4*>(dst) =
          ok ? *reinterpret_cast<const uint4*>(src + (size_t)r * W + c) : make_uint4(0, 0, 0, 0);
    }
  }
}

// an A operand (rows row, row + 8; columns col, col + 1, col + 8, col + 9
// with col = 16 ks + 2t) straight from an (S, HD) matrix in global
// memory, rows at or past S as 0
template <typename T, int HD>
__device__ __forceinline__ void a_global(FragA& a, const T* __restrict__ src, int row, int S,
                                         int col) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = row + (r & 1) * 8;
    a.hi[r] = a.lo[r] = 0u;
    if (rr < S) pair_of(src + (size_t)rr * HD + col + (r >> 1) * 8, a.hi[r], a.lo[r]);
  }
}

// shared memory a block can use on the card (227 KB)
constexpr size_t SMEM_MAX = 232448;

// Above HD 128 (HD 256, fp32) a thread cannot hold a warp's 16 rows of
// every output column and what the scores need beside them: each (b, h,
// tile) is split over NSPLIT = HD / HO CTAs, each of which recomputes the
// scores over all of HD and writes HO output columns (128 in the forward;
// 64 in dq and in dk/dv, which holds two accumulators), and the operands
// that stay fixed over the loop (the forward's q, dq's q and do, dk/dv's
// k and v) are read per k-step from global memory (L1 and L2 hold them)
// instead of registers or operand tiles.  Up to HD 128, NSPLIT = 1 and
// HO = HD.  bf16 at HD 256 runs the wgmma kernels (flash_bwd_wgmma.cuh),
// which split nothing, so no bf16 instance of these layouts has NSPLIT
// above 1.
template <typename T, int HD> struct FwdLayout {
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int HO = HD > 128 ? 128 : HD;              // o columns per CTA
  static constexpr int NSPLIT = HD / HO;
  static constexpr bool QREG = HD <= 128;                     // q in registers
  static constexpr int LDS = HD + 8;                          // bf16 operand rows: k
  static constexpr int LDV = HO + 8;                          // v's HO columns
  static constexpr size_t KPLANE = (size_t)64 * LDS;          // one operand tile
  static constexpr size_t VPLANE = (size_t)64 * LDV;
  static constexpr size_t RAW = (size_t)64 * (HD + HO) * sizeof(T);       // staged k, v
  static constexpr size_t SMEM = RAW + (SPLIT ? 2 : 1) * (KPLANE + VPLANE) * 2;
  static_assert(SMEM <= SMEM_MAX, "forward shared memory");
};

// ---------------------------------------------------------------------------
// K1 on the tensor cores: o = softmax(q k^T * scale) v, online softmax over
// 64-key tiles; lse = m + log(l) per row.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(TPB)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, float* __restrict__ lse,
                    int H, int Hkv, int S, int causal, int window, float scale) {
  using L = FwdLayout<T, HD>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int KS = HD / 16;       // k-steps over HD
  constexpr int DN = L::HO / 8;     // n8 tiles over this CTA's o columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* raw = reinterpret_cast<T*>(smem_raw);
  // k (all HD columns) and v (this CTA's HO) as bf16 operands: k hi, v hi
  // (, k lo, v lo)
  __nv_bfloat16* ops = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::RAW);
  __nv_bfloat16 *kh = ops, *vh = ops + L::KPLANE;
  __nv_bfloat16 *kl = vh + L::VPLANE, *vl = kl + L::KPLANE;

  const int h = blockIdx.x / L::NSPLIT, b = blockIdx.y;
  const int n0 = (blockIdx.x % L::NSPLIT) * L::HO;   // this CTA's first o column
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int q0 = qt * BQ;
  const int hk = h / (H / Hkv);
  const int kvl = kv_len[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row of it
  const size_t qoff = ((size_t)b * H + h) * S * HD;
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;
  const int n_kt = key_tiles(q0, S, kvl, causal);
  const int r0 = q0 + 16 * warp + g;           // this lane's rows r0, r0 + 8

  auto stage_kv = [&](int kt) {
    stage_rows<T, HD, HD>(raw, k + koff, kt * BK, S);
    stage_rows<T, L::HO, L::HO, HD>(raw + 64 * HD, v + koff + n0, kt * BK, S);
    cp_async_commit();
  };
  if (n_kt > 0) stage_kv(0);

  // q as A operands: rows r0 (+8), columns 16 ks + 2t (+1, +8, +9); kept
  // in registers up to HD 128
  FragA qa[L::QREG ? KS : 1];
  if constexpr (L::QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) a_global<T, HD>(qa[ks], q + qoff, r0, S, 16 * ks + 2 * t);
  }

  float acc[DN][4], m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();                   // tile kt staged; tile kt-1's operands read
    split_rows<T, HD>(kh, kl, raw, 64);
    split_rows<T, L::HO>(vh, vl, raw + 64 * HD, 64);
    __syncthreads();
    if (kt + 1 < n_kt) stage_kv(kt + 1);   // in flight while tile kt computes
    // on the causal diagonal this warp's rows see keys < 16 (warp + 1)
    const bool diag = causal && k0 == q0;
    const int n_nt = diag ? 2 * warp + 2 : 8;

    // s = q k^T: 8 tiles of 8 keys, two at a time
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      FragA qk;
      if constexpr (L::QREG) qk = qa[ks];
      else a_global<T, HD>(qk, q + qoff, r0, S, 16 * ks + 2 * t);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (2 * np >= n_nt) continue;
        const int at = (16 * np + (lm >> 1) * 8 + lr) * L::LDS + (lm & 1) * 8 + 16 * ks;
        FragB b0, b1;
        load_b(b0, b1, kh + at, kl + at, SPLIT, false);
        mma4<SPLIT>(sc[2 * np], qk, b0);
        mma4<SPLIT>(sc[2 * np + 1], qk, b1);
      }
    }

    // masks only where the tile is not wholly visible
    const bool full = k0 + BK <= kvl && (!causal || k0 + BK <= q0 + 1) &&
                      (window <= 0 || q0 + BQ - 1 - k0 < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale;
        if (!full && !visible(r0 + (e >> 1) * 8, k0 + 8 * nt + 2 * t + (e & 1), kvl, causal,
                              window))
          x = -INFINITY;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // m stays finite (>= NEG_BIG), so exp never sees inf - inf
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[nt][e] - m[e >> 1]) * LOG2E);   // 0 where masked
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];   // this lane's part
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // o += p v, p from the score registers (k-step j: keys 16 j .. 16 j + 15)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j >= n_nt) continue;
      FragA pa;
      acc_to_a<SPLIT>(pa, sc[2 * j], sc[2 * j + 1]);
      const int at = (16 * j + (lm & 1) * 8 + lr) * L::LDV + (lm >> 1) * 8;
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        FragB b0, b1;
        load_b(b0, b1, vh + at + 16 * np, vl + at + 16 * np, SPLIT, true);
        mma3<SPLIT>(acc[2 * np], pa, b0);
        mma3<SPLIT>(acc[2 * np + 1], pa, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      store_pair(o + qoff + (size_t)row * HD + n0 + 8 * n + 2 * t, acc[n][2 * i] / lc,
                 acc[n][2 * i + 1] / lc);
    if (t == 0 && n0 == 0) lse[((size_t)b * H + h) * S + row] = m[i] + logf(lc);
  }
}

// dk/dv on mma.sync: every head dim in fp32, and up to 128 in bf16 (bf16
// at 256 is flash_bwd_dkv_wgmma_kernel)
template <typename T, int HD> struct DkvLayout {
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int HO = HD > 128 ? 64 : HD;               // dk, dv columns per CTA
  static constexpr int NSPLIT = HD / HO;
  static constexpr bool KGLOBAL = HD > 128;                   // k, v read from global
  static constexpr int LDS = HD + 8;                          // bf16 operand rows
  static constexpr size_t PLANE = (size_t)64 * LDS;           // one operand tile
  static constexpr int NH = KGLOBAL ? 2 : 4;                  // (k, v,) q, do hi
  static constexpr size_t LO = NH * PLANE;                    // lo plane after its hi
  static constexpr size_t OPS = (SPLIT ? 2 : 1) * LO * 2;
  static constexpr size_t ROWS = 2 * 64 * sizeof(float);      // lse, delta of a tile
  static constexpr size_t RAW0 = (size_t)2 * 64 * HD * sizeof(T) + ROWS;  // staged q, do
  // the next item's q, do staged by cp.async where they fit beside the
  // operands (else split straight from global memory)
  static constexpr bool STAGE = OPS + RAW0 + ROWS <= SMEM_MAX;
  static constexpr size_t RAW = STAGE ? RAW0 : 0;
  static constexpr size_t SMEM = OPS + RAW + ROWS;
  static_assert(SMEM <= SMEM_MAX, "dk/dv shared memory");
};

// ---------------------------------------------------------------------------
// K3 on the tensor cores: dk, dv for one 64-key tile of one kv head, the
// GQA group's query heads summed in the accumulators.  Per 64-query tile
// (transposed, keys as rows): s^T = k q^T, dp^T = v do^T,
// p^T = exp(s^T scale - lse) under the forward's masks and q < kv_len,
// ds^T = p^T (dp^T - delta) scale, dv += p^T do, dk += ds^T q.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(TPB)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kv_len, T* __restrict__ dk,
                        T* __restrict__ dv,
                        int H, int Hkv, int S, int causal, int window, float scale) {
  using L = DkvLayout<T, HD>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int KS = HD / 16;
  constexpr int DN = L::HO / 8;            // n8 tiles over this CTA's columns
  constexpr int QW = HD <= 64 ? 64 : 32;   // query columns per pass (registers)
  constexpr size_t LO = L::LO;             // lo plane of an operand, after its hi
  constexpr int QP = L::KGLOBAL ? 0 : 2;   // q's plane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16 operands: (k, v,) q, do hi (then their lo); then the staged q,
  // do, lse, delta of the next tile; then this tile's lse, delta
  __nv_bfloat16* ops = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const __nv_bfloat16 *kh = ops, *vh = ops + L::PLANE;
  __nv_bfloat16 *qh = ops + QP * L::PLANE, *dh = ops + (QP + 1) * L::PLANE;
  T* raw = reinterpret_cast<T*>(smem_raw + L::OPS);
  float* raw_rows = reinterpret_cast<float*>(raw + 2 * 64 * HD);
  float* rows = reinterpret_cast<float*>(smem_raw + L::OPS + L::RAW);   // lse, delta

  // the grid's slowest axis walks the key tiles from the first: under
  // causal masking the longest first
  const int k0 = blockIdx.z * BK, hk = blockIdx.x / L::NSPLIT, b = blockIdx.y;
  const int n0 = (blockIdx.x % L::NSPLIT) * L::HO;   // this CTA's first column
  const int group = H / Hkv;
  const int kvl = kv_len[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row of it
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;
  const int kr0 = 16 * warp + g;               // this lane's key rows kr0, kr0 + 8

  const int lo = causal ? k0 / BQ : 0;
  const int hi = k0 >= kvl ? 0 : min((S + BQ - 1) / BQ, (kvl + BQ - 1) / BQ);
  const int n_it = max(hi - lo, 0);
  const int n_items = group * n_it;

  auto stage_item = [&](int i) {
    const int h = hk * group + i / n_it, q0 = (lo + i % n_it) * BQ;
    const size_t qoff = ((size_t)b * H + h) * S * HD;
    const size_t roff = ((size_t)b * H + h) * S;
    stage_rows<T, HD, HD>(raw, q + qoff, q0, S);
    stage_rows<T, HD, HD>(raw + 64 * HD, dout + qoff, q0, S);
    for (int r = threadIdx.x; r < 2 * BQ; r += TPB) {
      const int qp = q0 + (r % BQ);
      const bool ok = qp < S;
      cp_async4(raw_rows + r, (r < BQ ? lse : delta) + roff + (ok ? qp : 0), ok);
    }
    cp_async_commit();
  };
  if constexpr (L::STAGE) {
    if (n_items > 0) stage_item(0);
  }
  // this tile's k and v as operands, zero past S
  if constexpr (!L::KGLOBAL) {
    split_rows<T, HD>(ops, ops + LO, k + koff + (size_t)k0 * HD, S - k0);
    split_rows<T, HD>(ops + L::PLANE, ops + L::PLANE + LO, v + koff + (size_t)k0 * HD, S - k0);
  }

  float gk[DN][4], gv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  const int a_at = (16 * warp + (lm & 1) * 8 + lr) * L::LDS + (lm >> 1) * 8;

  for (int i = 0; i < n_items; ++i) {
    const int q0 = (lo + i % n_it) * BQ;
    if constexpr (L::STAGE) {
      cp_async_wait<0>();
      __syncthreads();                 // item i staged; item i-1's operands read
      split_rows<T, HD>(qh, qh + LO, raw, 64);
      split_rows<T, HD>(dh, dh + LO, raw + 64 * HD, 64);
      for (int r = threadIdx.x; r < 2 * BQ; r += TPB) rows[r] = raw_rows[r];
      __syncthreads();
      if (i + 1 < n_items) stage_item(i + 1);   // in flight while item i computes
    } else {
      const int h = hk * group + i / n_it;
      const size_t qoff = ((size_t)b * H + h) * S * HD;
      const size_t roff = ((size_t)b * H + h) * S;
      __syncthreads();                 // item i-1's operands read
      split_rows<T, HD>(qh, qh + LO, q + qoff + (size_t)q0 * HD, S - q0);
      split_rows<T, HD>(dh, dh + LO, dout + qoff + (size_t)q0 * HD, S - q0);
      for (int r = threadIdx.x; r < 2 * BQ; r += TPB) {
        const int qp = q0 + (r % BQ);
        rows[r] = qp < S ? (r < BQ ? lse : delta)[roff + qp] : 0.f;
      }
      __syncthreads();
    }
    const bool full = k0 + BK <= kvl && q0 + BQ <= kvl && (!causal || k0 + BK <= q0 + 1) &&
                      (window <= 0 || q0 + BQ - 1 - k0 < window);
    // on the causal diagonal this warp's keys are seen by queries >= 16 warp
    const int nt_lo = causal && q0 == k0 ? 2 * warp : 0;

#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += QW) {
      if (c0 + QW <= 8 * nt_lo) continue;      // the whole pass is masked
      float sc[QW / 8][4], dp[QW / 8][4];
#pragma unroll
      for (int nt = 0; nt < QW / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        FragA ka, va;
        if constexpr (L::KGLOBAL) {
          a_global<T, HD>(ka, k + koff, k0 + kr0, S, 16 * ks + 2 * t);
          a_global<T, HD>(va, v + koff, k0 + kr0, S, 16 * ks + 2 * t);
        } else {
          ldsm_x4(ka.hi, kh + a_at + 16 * ks);
          ldsm_x4(va.hi, vh + a_at + 16 * ks);
          if (SPLIT) {
            ldsm_x4(ka.lo, kh + LO + a_at + 16 * ks);
            ldsm_x4(va.lo, vh + LO + a_at + 16 * ks);
          }
        }
#pragma unroll
        for (int np = 0; np < QW / 16; ++np) {
          if (c0 / 8 + 2 * np + 1 < nt_lo) continue;
          const int at = (c0 + 16 * np + (lm >> 1) * 8 + lr) * L::LDS + 16 * ks + (lm & 1) * 8;
          FragB q0b, q1b, d0b, d1b;
          load_b(q0b, q1b, qh + at, qh + LO + at, SPLIT, false);
          load_b(d0b, d1b, dh + at, dh + LO + at, SPLIT, false);
          mma3<SPLIT>(sc[2 * np], ka, q0b);
          mma3<SPLIT>(sc[2 * np + 1], ka, q1b);
          mma3<SPLIT>(dp[2 * np], va, d0b);
          mma3<SPLIT>(dp[2 * np + 1], va, d1b);
        }
      }
      // p^T and ds^T in place of s^T and dp^T
#pragma unroll
      for (int nt = 0; nt < QW / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * nt + 2 * t + (e & 1);
          const int qp = q0 + c, kp = k0 + kr0 + (e >> 1) * 8;
          const bool ok = c0 / 8 + nt >= nt_lo &&
                          (full || (qp < kvl && visible(qp, kp, kvl, causal, window)));
          const float p = ok ? exp2f((sc[nt][e] * scale - rows[c]) * LOG2E) : 0.f;
          sc[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - rows[BQ + c]) * scale;
        }
      // dv += p^T do, dk += ds^T q (k-step j: queries c0 + 16 j .. + 15)
#pragma unroll
      for (int j = 0; j < QW / 16; ++j) {
        if (c0 / 8 + 2 * j + 1 < nt_lo) continue;
        FragA pa, da;
        acc_to_a<SPLIT>(pa, sc[2 * j], sc[2 * j + 1]);
        acc_to_a<SPLIT>(da, dp[2 * j], dp[2 * j + 1]);
        const int at = (c0 + 16 * j + (lm & 1) * 8 + lr) * L::LDS + (lm >> 1) * 8 + n0;
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          FragB o0b, o1b, q0b, q1b;
          load_b(o0b, o1b, dh + at + 16 * np, dh + LO + at + 16 * np, SPLIT, true);
          load_b(q0b, q1b, qh + at + 16 * np, qh + LO + at + 16 * np, SPLIT, true);
          mma3<SPLIT>(gv[2 * np], pa, o0b);
          mma3<SPLIT>(gv[2 * np + 1], pa, o1b);
          mma3<SPLIT>(gk[2 * np], da, q0b);
          mma3<SPLIT>(gk[2 * np + 1], da, q1b);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + kr0 + 8 * i;
    if (kp >= S) continue;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const size_t at = koff + (size_t)kp * HD + n0 + 8 * n + 2 * t;
      store_pair(dk + at, gk[n][2 * i], gk[n][2 * i + 1]);
      store_pair(dv + at, gv[n][2 * i], gv[n][2 * i + 1]);
    }
  }
}

// dq on mma.sync: every head dim in fp32, and up to 128 in bf16 (bf16 at
// 256 is flash_bwd_dq_wgmma_kernel)
template <typename T, int HD> struct DqLayout {
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int HO = HD <= 128 ? HD : 64;              // dq columns per CTA
  static constexpr int NSPLIT = HD / HO;
  static constexpr bool QREG = HD <= 64;                      // q, do in registers
  static constexpr bool QGLOBAL = HD > 128;                   // q, do read from global
  static constexpr int LDS = HD + 8;                          // bf16 operand rows
  static constexpr size_t PLANE = (size_t)64 * LDS;           // one operand tile
  static constexpr int NH = QREG || QGLOBAL ? 2 : 4;          // k, v (, q, do) hi
  static constexpr size_t LO = NH * PLANE;                    // lo plane after its hi
  static constexpr size_t OPS = (SPLIT ? 2 : 1) * LO * 2;
  // the next tile's k, v staged by cp.async where they fit beside the
  // operands (else split straight from global memory)
  static constexpr size_t RAW0 = (size_t)2 * 64 * HD * sizeof(T);
  static constexpr bool STAGE = RAW0 + OPS <= SMEM_MAX;
  static constexpr size_t RAW = STAGE ? RAW0 : 0;
  static constexpr size_t SMEM = RAW + OPS;
  static_assert(SMEM <= SMEM_MAX, "dq shared memory");
};

// ---------------------------------------------------------------------------
// K2 on the tensor cores: dq for one 64-row q tile of one head.  Per
// 64-key tile: s = q k^T, dp = do v^T, p = exp(s scale - lse) under the
// forward's masks, ds = p (dp - delta) scale, dq += ds k.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(TPB)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ kv_len, T* __restrict__ dq,
                       int H, int Hkv, int S, int causal, int window, float scale) {
  using L = DqLayout<T, HD>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int KS = HD / 16;       // k-steps over HD
  constexpr int DN = L::HO / 8;     // n8 tiles over this CTA's dq columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* raw = reinterpret_cast<T*>(smem_raw);
  // bf16 operands: k hi, v hi (, q hi, do hi); then their lo planes
  __nv_bfloat16* ops = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::RAW);
  __nv_bfloat16 *kh = ops, *vh = ops + L::PLANE;
  const __nv_bfloat16 *qh = ops + 2 * L::PLANE, *dh = ops + 3 * L::PLANE;

  const int h = blockIdx.x / L::NSPLIT, b = blockIdx.y;
  const int n0 = (blockIdx.x % L::NSPLIT) * L::HO;   // this CTA's first dq column
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int q0 = qt * BQ;
  const int hk = h / (H / Hkv);
  const int kvl = kv_len[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row of it
  const size_t qoff = ((size_t)b * H + h) * S * HD;
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;
  const size_t roff = ((size_t)b * H + h) * S;
  const int n_kt = key_tiles(q0, S, kvl, causal);
  const int r0 = q0 + 16 * warp + g;           // this lane's rows r0, r0 + 8

  auto stage_kv = [&](int kt) {
    stage_rows<T, HD, HD>(raw, k + koff, kt * BK, S);
    stage_rows<T, HD, HD>(raw + 64 * HD, v + koff, kt * BK, S);
    cp_async_commit();
  };
  if constexpr (L::STAGE) {
    if (n_kt > 0) stage_kv(0);
  }

  // q and do as A operands (rows r0 (+8), columns 16 ks + 2t (+1, +8,
  // +9)): in registers up to HD 64, operand tiles read by ldmatrix at HD
  // 80 and 128, read from global memory per k-step above
  FragA qreg[L::QREG ? KS : 1], dreg[L::QREG ? KS : 1];
  if constexpr (L::QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a_global<T, HD>(qreg[ks], q + qoff, r0, S, 16 * ks + 2 * t);
      a_global<T, HD>(dreg[ks], dout + qoff, r0, S, 16 * ks + 2 * t);
    }
  } else if constexpr (!L::QGLOBAL) {
    if (n_kt > 0) {
      split_rows<T, HD>(ops + 2 * L::PLANE, ops + 2 * L::PLANE + L::LO,
                        q + qoff + (size_t)q0 * HD, S - q0);
      split_rows<T, HD>(ops + 3 * L::PLANE, ops + 3 * L::PLANE + L::LO,
                        dout + qoff + (size_t)q0 * HD, S - q0);
    }
  }
  // this lane's rows of lse and delta
  float ls[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    ls[i] = row < S ? lse[roff + row] : 0.f;
    dl[i] = row < S ? delta[roff + row] : 0.f;
  }

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int a_at = (16 * warp + (lm & 1) * 8 + lr) * L::LDS + (lm >> 1) * 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if constexpr (L::STAGE) {
      cp_async_wait<0>();
      __syncthreads();                 // tile kt staged; tile kt-1's operands read
      split_rows<T, HD>(kh, kh + L::LO, raw, 64);
      split_rows<T, HD>(vh, vh + L::LO, raw + 64 * HD, 64);
      __syncthreads();
      if (kt + 1 < n_kt) stage_kv(kt + 1);   // in flight while tile kt computes
    } else {
      __syncthreads();                 // tile kt-1's operands read
      split_rows<T, HD>(kh, kh + L::LO, k + koff + (size_t)k0 * HD, S - k0);
      split_rows<T, HD>(vh, vh + L::LO, v + koff + (size_t)k0 * HD, S - k0);
      __syncthreads();
    }
    // on the causal diagonal this warp's rows see keys < 16 (warp + 1)
    const int n_nt = causal && k0 == q0 ? 2 * warp + 2 : 8;
    // masks only where the tile is not wholly visible
    const bool full = k0 + BK <= kvl && (!causal || k0 + BK <= q0 + 1) &&
                      (window <= 0 || q0 + BQ - 1 - k0 < window);

    // s = q k^T and dp = do v^T: 8 tiles of 8 keys, two at a time
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      FragA qa, da;
      if constexpr (L::QREG) {
        qa = qreg[ks];
        da = dreg[ks];
      } else if constexpr (L::QGLOBAL) {
        a_global<T, HD>(qa, q + qoff, r0, S, 16 * ks + 2 * t);
        a_global<T, HD>(da, dout + qoff, r0, S, 16 * ks + 2 * t);
      } else {
        ldsm_x4(qa.hi, qh + a_at + 16 * ks);
        ldsm_x4(da.hi, dh + a_at + 16 * ks);
        if (SPLIT) {
          ldsm_x4(qa.lo, qh + L::LO + a_at + 16 * ks);
          ldsm_x4(da.lo, dh + L::LO + a_at + 16 * ks);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (2 * np >= n_nt) continue;
        const int at = (16 * np + (lm >> 1) * 8 + lr) * L::LDS + 16 * ks + (lm & 1) * 8;
        FragB k0b, k1b, v0b, v1b;
        load_b(k0b, k1b, kh + at, kh + L::LO + at, SPLIT, false);
        load_b(v0b, v1b, vh + at, vh + L::LO + at, SPLIT, false);
        mma3<SPLIT>(sc[2 * np], qa, k0b);
        mma3<SPLIT>(sc[2 * np + 1], qa, k1b);
        mma3<SPLIT>(dp[2 * np], da, v0b);
        mma3<SPLIT>(dp[2 * np + 1], da, v1b);
      }
    }

    // ds in place of s
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kp = k0 + 8 * nt + 2 * t + (e & 1);
        const bool ok = nt < n_nt && (full || visible(r0 + 8 * i, kp, kvl, causal, window));
        const float p = ok ? exp2f((sc[nt][e] * scale - ls[i]) * LOG2E) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - dl[i]) * scale;
      }

    // dq += ds k, ds from the score registers (k-step j: keys 16 j ..
    // 16 j + 15), k read k-major
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j >= n_nt) continue;
      FragA a;
      acc_to_a<SPLIT>(a, sc[2 * j], sc[2 * j + 1]);
      const int at = (16 * j + (lm & 1) * 8 + lr) * L::LDS + (lm >> 1) * 8 + n0;
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        FragB b0, b1;
        load_b(b0, b1, kh + at + 16 * np, kh + L::LO + at + 16 * np, SPLIT, true);
        mma3<SPLIT>(acc[2 * np], a, b0);
        mma3<SPLIT>(acc[2 * np + 1], a, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      store_pair(dq + qoff + (size_t)row * HD + n0 + 8 * n + 2 * t, acc[n][2 * i],
                 acc[n][2 * i + 1]);
  }
}

template <typename T, int HD>
cudaError_t run_fwd(const Args& a) {
  using L = FwdLayout<T, HD>;
  auto kern = flash_fwd_tc_kernel<T, HD>;
  cudaError_t e = prepare(kern, L::SMEM);
  if (e != cudaSuccess) return e;
  if (a.info) return describe(kern, TPB, L::SMEM, a.info);
  dim3 grid(a.H * L::NSPLIT, a.B, (a.S + BQ - 1) / BQ);
  kern<<<grid, TPB, L::SMEM, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.kv_len,
      (T*)a.o, (float*)a.lse_out, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dkv(const Args& a) {
  using L = DkvLayout<T, HD>;
  auto kern = flash_bwd_dkv_tc_kernel<T, HD>;
  cudaError_t e = prepare(kern, L::SMEM);
  if (e != cudaSuccess) return e;
  if (a.info) return describe(kern, TPB, L::SMEM, a.info);
  dim3 grid(a.Hkv * L::NSPLIT, a.B, (a.S + BK - 1) / BK);
  kern<<<grid, TPB, L::SMEM, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (T*)a.dk, (T*)a.dv, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dq(const Args& a) {
  using L = DqLayout<T, HD>;
  auto kern = flash_bwd_dq_tc_kernel<T, HD>;
  cudaError_t e = prepare(kern, L::SMEM);
  if (e != cudaSuccess) return e;
  if (a.info) return describe(kern, TPB, L::SMEM, a.info);
  dim3 grid(a.H * L::NSPLIT, a.B, (a.S + BQ - 1) / BQ);
  kern<<<grid, TPB, L::SMEM, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (T*)a.dq, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace tc

#include "flash_bwd_wgmma.cuh"

// the FMA kernels
template <typename T, int HD>
cudaError_t run_fwd(const Args& a) {
  auto kern = flash_fwd_fma_kernel<T, HD>;
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
  auto kern = flash_bwd_dq_fma_kernel<T, HD>;
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
  auto kern = flash_bwd_dkv_fma_kernel<T, HD>;
  cudaError_t e = prepare(kern, dkv_smem<HD>());
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + BK - 1) / BK, a.Hkv, a.B);
  kern<<<grid, NT, dkv_smem<HD>(), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (T*)a.dk, (T*)a.dv, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// which kernel: 0 forward, 1 dq, 2 dk/dv on the tensor cores (every head
// dim of run_hd; all three in bf16 at 256 on wgmma); 3 forward, 4
// dk/dv, 5 dq on the CUDA cores (head dims 16, 32, 64, 128 only: no FMA
// case is built at 80 or 256)
template <typename T, int HD>
cudaError_t run(int which, const Args& a) {
  constexpr bool FMA = HD == 16 || HD == 32 || HD == 64 || HD == 128;
  constexpr bool WGMMA = std::is_same<T, __nv_bfloat16>::value && HD == 256;
  switch (which) {
    case 0:
      if constexpr (WGMMA) return wg::run_fwd(a);
      else return tc::run_fwd<T, HD>(a);
    case 1:
      if constexpr (WGMMA) return wg::run_dq(a);
      else return tc::run_dq<T, HD>(a);
    case 2:
      if constexpr (WGMMA) return wg::run_dkv(a);
      else return tc::run_dkv<T, HD>(a);
    default: break;
  }
  if constexpr (FMA) {
    switch (which) {
      case 3: return run_fwd<T, HD>(a);
      case 4: return run_dkv<T, HD>(a);
      case 5: return run_dq<T, HD>(a);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_hd(int which, int hd, const Args& a) {
  switch (hd) {
    case 16: return run<T, 16>(which, a);
    case 32: return run<T, 32>(which, a);
    case 64: return run<T, 64>(which, a);
    case 80: return run<T, 80>(which, a);
    case 128: return run<T, 128>(which, a);
    case 256: return run<T, 256>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int dispatch(int which, int hd, int dtype, const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  // the tensor-core kernels copy and load 16-byte pieces of every tensor
  const bool outs16 = which == 0   ? aligned16(a.o)
                      : which == 1 ? aligned16(a.dout) && aligned16(a.dq)
                                   : aligned16(a.dout) && aligned16(a.dk) && aligned16(a.dv);
  if (which <= 2 && !(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && outs16))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)run_hd<float>(which, hd, a);
  if (dtype == 1) return (int)run_hd<__nv_bfloat16>(which, hd, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// Each returns the cudaError_t of the launch (0 = launched;
// cudaErrorInvalidValue, launching nothing, for a case it does not take).
// flash_fwd, flash_bwd_dq and flash_bwd_dkv run the tensor-core kernels
// (bf16 at 256: the wgmma kernels) and take every head dim
// 16, 32, 64, 80, 128, 256 with 16-byte aligned tensors; flash_fwd_fma,
// flash_bwd_dq_fma and flash_bwd_dkv_fma the fp32 FMA kernels of the same
// functions, at head dims 16, 32, 64, 128.

namespace {

int fwd_entry(int which, const void* q, const void* k, const void* v, const void* kv_len,
              void* o, void* lse, int B, int H, int Hkv, int S, int hd, int causal,
              int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.kv_len = kv_len; a.o = o; a.lse_out = lse;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return dispatch(which, hd, dtype, a);
}

int dq_entry(int which, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* kv_len, void* dq, int B, int H,
             int Hkv, int S, int hd, int causal, int window, float scale, int dtype,
             void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.kv_len = kv_len; a.dq = dq;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return dispatch(which, hd, dtype, a);
}

int dkv_entry(int which, const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kv_len, void* dk, void* dv,
              int B, int H, int Hkv, int S, int hd, int causal, int window, float scale,
              int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.kv_len = kv_len; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return dispatch(which, hd, dtype, a);
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_len,
                         void* o, void* lse, int B, int H, int Hkv, int S, int hd,
                         int causal, int window, float scale, int dtype, void* stream) {
  return fwd_entry(0, q, k, v, kv_len, o, lse, B, H, Hkv, S, hd, causal, window, scale,
                   dtype, stream);
}

extern "C" int flash_fwd_fma(const void* q, const void* k, const void* v, const void* kv_len,
                             void* o, void* lse, int B, int H, int Hkv, int S, int hd,
                             int causal, int window, float scale, int dtype, void* stream) {
  return fwd_entry(3, q, k, v, kv_len, o, lse, B, H, Hkv, S, hd, causal, window, scale,
                   dtype, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* kv_len, void* dq,
                            int B, int H, int Hkv, int S, int hd, int causal, int window,
                            float scale, int dtype, void* stream) {
  return dq_entry(1, q, k, v, dout, lse, delta, kv_len, dq, B, H, Hkv, S, hd, causal, window,
                  scale, dtype, stream);
}

extern "C" int flash_bwd_dq_fma(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* kv_len, void* dq, int B, int H, int Hkv, int S,
                                int hd, int causal, int window, float scale, int dtype,
                                void* stream) {
  return dq_entry(5, q, k, v, dout, lse, delta, kv_len, dq, B, H, Hkv, S, hd, causal, window,
                  scale, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_len,
                             void* dk, void* dv, int B, int H, int Hkv, int S, int hd,
                             int causal, int window, float scale, int dtype, void* stream) {
  return dkv_entry(2, q, k, v, dout, lse, delta, kv_len, dk, dv, B, H, Hkv, S, hd, causal,
                   window, scale, dtype, stream);
}

// The launch configuration of the kernel that flash_fwd (which 0),
// flash_bwd_dq (1) or flash_bwd_dkv (2) runs at this head dim and dtype:
// threads per CTA, dynamic shared memory in bytes, registers and local
// memory a thread, into info[0..3].  Launches nothing.
extern "C" int flash_kernel_config(int which, int hd, int dtype, int* info) {
  if (which < 0 || which > 2 || info == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.info = info;
  if (dtype == 0) return (int)run_hd<float>(which, hd, a);
  if (dtype == 1) return (int)run_hd<__nv_bfloat16>(which, hd, a);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_fma(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* kv_len, void* dk, void* dv, int B, int H,
                                 int Hkv, int S, int hd, int causal, int window,
                                 float scale, int dtype, void* stream) {
  return dkv_entry(4, q, k, v, dout, lse, delta, kv_len, dk, dv, B, H, Hkv, S, hd, causal,
                   window, scale, dtype, stream);
}
