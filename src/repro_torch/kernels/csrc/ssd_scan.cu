// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a): two kernels of one
// function.
//
// Replaces the Pallas TPU kernel of the JAX reference
// (src/repro/kernels/ssd_scan.py):
//   ssd_scan_tc_kernel   <- _ssd_kernel  (launched by ssd_scan)
//   ssd_scan_fma_kernel  <- _ssd_kernel  (launched by ssd_scan_fma)
//
// Layout (the model's, row-major, contiguous): x, y (B, S, H, P);
// dt (B, S, H); A (H,) fp32; Bm, Cm (B, S, N) shared by the heads;
// kv_len (B,) int32.  S is a multiple of the chunk length Q.
//
// What both compute, per (b, h), from a zero (P, N) state, chunk by chunk
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
// ssd_scan_tc_kernel, the tensor-core kernel (bf16 x, B, C; Q = 64; two
// instances of (P, N): (64, 128), the mamba2 configs', and (50, 16),
// hymba's SSD heads; H a multiple of 4; dt fp32 or bf16).
//
// What bounds it: at the mamba2 path's shape (B = 8, S = 448, H = 64,
// P = 64, N = 128, Q = 64, squad lengths: 49 of 56 chunks run) the
// function reads x, dt, B and C over the chunks it runs and writes y in
// full, 57.5 MB, and does 7.4 GFLOP: 0.0172 ms of bytes at 3.35 TB/s
// against 0.0075 ms of bf16 tensor-core work, so the card's bound is
// bytes.  At hymba's (the same B, S, H and lengths; P = 50, N = 16) it
// is 43.6 MB and 1.77 GFLOP: 0.0130 ms of bytes against 0.0018 ms of
// work, bytes again, by more.  The kernel does ~2.5x the function's
// products (the hi/lo halves below), still under the bytes.
//
// Design:
// - Grid: one CTA of 16 warps per (b, group of G = 4 heads), 128 CTAs at
//   the main shape, one wave on 132 SMs; the CTA walks the chunks in a
//   loop, as the TPU's sequential grid axis.  Four warps own a head, each
//   16 rows of its P = 64 (P padded to 64 at P = 50).  A warp keeps its
//   16 x N slice of the head's fp32 state in registers for the whole
//   scan, as the accumulator of the state product: the state never
//   leaves the SM and is never rounded.
// - C B^T is computed once per (b, chunk) into shared memory (fp32, one
//   16 x 16 tile per warp) and shared by the G heads; each head then
//   applies its own mask L and dt as it builds its weights.
// - All four products run on the tensor cores as mma.sync.m16n8k16 with
//   bf16 operands and fp32 accumulation.  C B^T takes bf16 C and B and is
//   exact up to fp32 sums.  The other three have one fp32 operand (the
//   weights w = C B^T o L o dt, the carried state, the decayed x), which
//   is split into bf16 hi + lo = hi + bf16(v - hi) and issued as two
//   products: about 16 mantissa bits survive, where one bf16 rounding of
//   w or of the carried state would compound over the chunks.  Tiles of
//   w wholly above the diagonal are skipped.  The state operand of
//   C state^T comes straight from the accumulator registers: the m16n8
//   accumulator layout of state (P x N) is the k16 x n8 operand layout
//   of state^T, so no shuffle or shared-memory round trip is needed.
// - Loads overlap compute: chunk c+1's B, C, x and dt go into the second
//   of two shared-memory stages with cp.async while chunk c computes.
//   Rows are padded by 16 bytes, so every ldmatrix is free of bank
//   conflicts.
// - cumsum(dt * A) is a warp scan (two positions per lane, shfl_up).
// - Deterministic: no atomics; every sum has a fixed order that depends
//   on neither S nor kv_len, so a padded call with kv_len gives the
//   unpadded call's rows bit for bit.
// - Costs it keeps: the four warps of a head each build the head's whole
//   w (their y columns need all of it), so each w entry's exp is
//   computed four times (fast exp2 on the SFU); y is stored as 4-byte
//   pairs straight from the accumulators.
// - Hymba's instance, P = 50, N = 16.  (a) P is not a multiple of 16:
//   each head's x rows are staged padded to PP = 64 columns, so the warp
//   layout (4 warps a head, 16 warps, one 16 x 16 tile of C B^T each)
//   is mamba2's; the 14 padded columns are zeroed once in both stages
//   and never copied into, so the padded state rows stay 0, and y
//   columns >= P are never stored.  The fourth warp of a head carries 2
//   live columns of its 16 (22 % of the x and state products are
//   padding; the bytes bound the kernel, not the products).  (b) A head's x row
//   is 100 bytes, so heads 1-3 of a group start 4-byte but not 16-byte
//   aligned: x is copied as 4-byte bf16 pairs by cp.async straight into
//   the padded rows (the group's 400 bytes per position are contiguous
//   and coalesced across a warp); B, C (32-byte rows) and dt stay
//   16-byte copies.  y is stored as pairs (even columns, aligned), and
//   the rows of skipped chunks are zeroed as the group's 400 contiguous
//   bytes in 16-byte pieces (16-byte aligned because h0 and H are
//   multiples of 4).  (c) N = 16: C B^T, C state^T and each state
//   product are one k-step; a warp's state slice is 16 x 16 (8
//   registers); a stage is 40 KB, 100 KB of shared memory in all.
//   The grid stays B x H / G = 128 CTAs of 512 threads, one wave on 132
//   SMs: a second CTA per SM would fit in shared memory but there is no
//   second wave to fill it, and G = 2 (256 CTAs, C B^T shared by 2
//   heads) was not measured.
//
// ssd_scan_fma_kernel, the fp32 FMA kernel: every other case the
// wrapper's dispatch rule sends it (fp32 x, B, C; small P, N or Q, as in
// the reference's SSD cases and the reduced mamba2; P = 50, N = 16 in
// fp32); chip_smoke.py also times it in turns with the tensor-core
// kernel at both of that kernel's shapes.  One CTA of 256 threads owns
// one (b, h) and walks its chunks; the state, the chunk's x, B, C
// (staged in fp32) and the Q x Q weight tile live in shared memory; each
// product is a 4 x 4 register tile per thread over shared operands
// padded by one float.  Its ceiling is the 67 TFLOP/s fp32 rate, and it
// recomputes C B^T for every head.
// A head dim P that is not a multiple of 4 (50) is tiled at
// P4 = P rounded up to 4: the staged x has P4 columns whose last P4 - P
// stay zero, so the padded state rows stay zero and the padded y columns
// are never stored (4 % more work at P = 50).  x is read element by
// element, so a row of P bf16 values (100 bytes at P = 50) needs no
// alignment.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int G = 4;            // heads per CTA
constexpr int Q = 64;           // chunk length
constexpr int LCB = Q + 8;      // fp32 row stride of C B^T
static_assert(Q == 64, "the warp scan gives each lane two positions");

// The instance's shape: head dim P, tiled at PP = P rounded up to 16
// (the m16 rows of a warp's state slice, the n8 pairs of its y columns);
// WPH warps own a head, 16 of its PP rows each; the staged x keeps the
// G heads' rows padded to PP columns, plus 16 bytes.
template <int P> struct Inst {
  static constexpr int PP = (P + 15) / 16 * 16;
  static constexpr int WPH = PP / 16;          // warps per head
  static constexpr int NW = G * WPH;           // warps per CTA
  static constexpr int NT = NW * 32;           // threads per CTA
  static constexpr int LX = G * PP + 8;        // bf16 row stride of the staged x
  static_assert((Q / 16) * (Q / 16) == NW, "one 16 x 16 tile of C B^T per warp");
  static_assert(P % 2 == 0 && G * P % 8 == 0,
                "x and y rows as bf16 pairs, a group's y row as 16-byte pieces");
};

template <int N> constexpr int LN = N + 8;  // bf16 row stride of B, C

template <int P, int N, typename TD>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * sizeof(__nv_bfloat16) * Q * LN<N>            // B, C
         + sizeof(__nv_bfloat16) * Q * Inst<P>::LX        // x of the G heads
         + sizeof(TD) * Q * G;                            // dt of the G heads
}
template <int P, int N, typename TD>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * stage_bytes<P, N, TD>() + sizeof(float) * (Q * LCB + 2 * G * Q);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "n"(BYTES)
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
// (v0, v1) as a bf16 pair hi and the pair of what hi leaves out, lo
__device__ __forceinline__ void split(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
}
__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

template <int P, int N, typename TD>
__global__ void __launch_bounds__(Inst<P>::NT, 1)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x, const TD* __restrict__ dt,
                   const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, const int* __restrict__ kv_len,
                   __nv_bfloat16* __restrict__ y, int S, int H) {
  using I = Inst<P>;
  constexpr int ln = LN<N>, PP = I::PP, WPH = I::WPH, NT = I::NT, LX = I::LX;
  const int h0 = blockIdx.x * G, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = warp / WPH, wp = warp % WPH;    // head in the group, its p-block
  const int gr = lane >> 2, tq = lane & 3;       // mma fragment row, column pair
  const int lm = lane >> 3, lr = lane & 7;       // ldmatrix: matrix, row of it

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage_B = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * stage_bytes<P, N, TD>());
  };
  auto stage_C = [&](int s) { return stage_B(s) + Q * ln; };
  auto stage_x = [&](int s) { return stage_C(s) + Q * ln; };
  auto stage_dt = [&](int s) { return reinterpret_cast<TD*>(stage_x(s) + Q * LX); };
  float* cb = reinterpret_cast<float*>(smem + 2 * stage_bytes<P, N, TD>());  // (Q, Q)
  float* la_s = cb + Q * LCB;                                              // (G, Q)
  float* dt_s = la_s + G * Q;                                              // (G, Q)

  const int kvl = min(max(kv_len[b], 0), S);
  const int n_chunks = S / Q;
  const int n_valid = (kvl + Q - 1) / Q;

  // chunk c's B, C, x and dt into stage s, one cp.async group
  auto load_chunk = [&](int c, int s) {
    const size_t row0 = (size_t)b * S + (size_t)c * Q;
    __nv_bfloat16 *bs = stage_B(s), *cs = stage_C(s), *xs = stage_x(s);
    constexpr int per_row_bc = N / 8;             // 16-byte pieces
    for (int i = tid; i < Q * per_row_bc; i += NT) {
      const int r = i / per_row_bc, k = (i % per_row_bc) * 8;
      cp_async<16>(bs + r * ln + k, Bm + (row0 + r) * N + k);
      cp_async<16>(cs + r * ln + k, Cm + (row0 + r) * N + k);
    }
    if constexpr (P == PP) {
      constexpr int per_row_x = G * P / 8;        // 16-byte pieces
      for (int i = tid; i < Q * per_row_x; i += NT) {
        const int r = i / per_row_x, k = (i % per_row_x) * 8;
        cp_async<16>(xs + r * LX + k, x + ((row0 + r) * H + h0) * P + k);
      }
    } else {
      // a head's row (100 bytes at P = 50) is 4-byte aligned only: bf16
      // pairs, each into its head's padded row
      constexpr int per_row_x = G * P / 2;
      for (int i = tid; i < Q * per_row_x; i += NT) {
        const int r = i / per_row_x, e = (i % per_row_x) * 2;
        cp_async<4>(xs + r * LX + (e / P) * PP + e % P, x + ((row0 + r) * H + h0) * P + e);
      }
    }
    for (int r = tid; r < Q; r += NT)
      cp_async<(int)(G * sizeof(TD))>(stage_dt(s) + r * G, dt + (row0 + r) * H + h0);
    cp_async_commit();
  };

  // this warp's 16 x N slice of its head's state: rows 16 wp + gr (+8),
  // columns 8 nt + 2 tq (+1), the m16n8 accumulator layout
  float st[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[nt][r] = 0.f;

  // the padded columns P .. PP - 1 of each head's x rows, in both
  // stages, are zero for the whole scan (no copy writes them): the
  // padded state rows stay zero and the padded y columns are never stored
  if constexpr (P != PP) {
    constexpr int pad = PP - P;
    for (int i = tid; i < 2 * Q * G * pad; i += NT) {
      const int row = i / (G * pad), c = i % (G * pad);
      stage_x(row / Q)[(row % Q) * LX + (c / pad) * PP + P + c % pad] = __float2bfloat16(0.f);
    }
  }
  if (n_valid > 0) load_chunk(0, 0);
  for (int c = 0; c < n_valid; ++c) {
    const int s = c & 1, s0 = c * Q;
    if (c + 1 < n_valid) {
      load_chunk(c + 1, s ^ 1);      // in flight while chunk c computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16 *bs = stage_B(s), *cs = stage_C(s), *xs = stage_x(s);

    // la = cumsum(dt * A) for head `warp`, dt zeroed at or past kv_len
    if (warp < G) {
      const TD* dts = stage_dt(s);
      const int i0 = 2 * lane;
      const float d0 = s0 + i0 < kvl ? to_f(dts[i0 * G + warp]) : 0.f;
      const float d1 = s0 + i0 + 1 < kvl ? to_f(dts[(i0 + 1) * G + warp]) : 0.f;
      const float v0 = d0 * A[h0 + warp], v1 = d1 * A[h0 + warp];
      float run = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) excl = 0.f;
      la_s[warp * Q + i0] = excl + v0;
      la_s[warp * Q + i0 + 1] = (excl + v0) + v1;
      dt_s[warp * Q + i0] = d0;
      dt_s[warp * Q + i0 + 1] = d1;
    }

    // C B^T, one 16 x 16 tile per warp, shared by the G heads
    {
      const int tm = warp / (Q / 16), tn = warp % (Q / 16);
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        unsigned a[4], bf[4];
        ldsm_x4(a, cs + (16 * tm + (lm & 1) * 8 + lr) * ln + 16 * ks + (lm >> 1) * 8);
        ldsm_x4(bf, bs + (16 * tn + (lm >> 1) * 8 + lr) * ln + 16 * ks + (lm & 1) * 8);
        mma(acc[0], a, bf[0], bf[1]);
        mma(acc[1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = 16 * tm + gr, col = 16 * tn + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(cb + r * LCB + col) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(cb + (r + 8) * LCB + col) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();

    const float* la = la_s + g * Q;
    const float* dtz = dt_s + g * Q;
    const float la_end = la[Q - 1];
    const int pcol = g * PP + 16 * wp;           // this warp's x columns

    // y rows of 16 at a time: exp(la) o (C state^T), then + w x
#pragma unroll 1
    for (int mi = 0; mi < Q / 16; ++mi) {
      float yacc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        unsigned a[4];
        ldsm_x4(a, cs + (16 * mi + (lm & 1) * 8 + lr) * ln + 16 * ks + (lm >> 1) * 8);
#pragma unroll
        for (int ps = 0; ps < 2; ++ps) {
          unsigned h0r, l0r, h1r, l1r;
          split(st[2 * ks][2 * ps], st[2 * ks][2 * ps + 1], h0r, l0r);
          split(st[2 * ks + 1][2 * ps], st[2 * ks + 1][2 * ps + 1], h1r, l1r);
          mma(yacc[ps], a, h0r, h1r);
          mma(yacc[ps], a, l0r, l1r);
        }
      }
      const int i_lo = 16 * mi + gr, i_hi = i_lo + 8;
      const float e_lo = __expf(la[i_lo]), e_hi = __expf(la[i_hi]);
#pragma unroll
      for (int ps = 0; ps < 2; ++ps) {
        yacc[ps][0] *= e_lo;
        yacc[ps][1] *= e_lo;
        yacc[ps][2] *= e_hi;
        yacc[ps][3] *= e_hi;
      }
      const float la_lo = la[i_lo], la_hi = la[i_hi];
      for (int kj = 0; kj <= mi; ++kj) {
        // w = C B^T o L o dt on this fragment, split into hi + lo
        const int j0 = 16 * kj + 2 * tq;
        unsigned whi[4], wlo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = (q & 1) ? i_hi : i_lo;
          const float lai = (q & 1) ? la_hi : la_lo;
          const int j = j0 + (q >> 1) * 8;
          const float2 c2 = *reinterpret_cast<const float2*>(cb + i * LCB + j);
          const float w0 = i >= j ? c2.x * __expf(lai - la[j]) * dtz[j] : 0.f;
          const float w1 = i >= j + 1 ? c2.y * __expf(lai - la[j + 1]) * dtz[j + 1] : 0.f;
          split(w0, w1, whi[q], wlo[q]);
        }
        unsigned xb[4];
        ldsm_x4_t(xb, xs + (16 * kj + (lm & 1) * 8 + lr) * LX + pcol + (lm >> 1) * 8);
        mma(yacc[0], whi, xb[0], xb[1]);
        mma(yacc[0], wlo, xb[0], xb[1]);
        mma(yacc[1], whi, xb[2], xb[3]);
        mma(yacc[1], wlo, xb[2], xb[3]);
      }
#pragma unroll
      for (int ps = 0; ps < 2; ++ps) {
        const int p = 16 * wp + 8 * ps + 2 * tq;
        if (P != PP && p >= P) continue;         // a padded column
        __nv_bfloat16* yr = y + (((size_t)b * S + s0 + i_lo) * H + h0 + g) * P + p;
        *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(yacc[ps][0], yacc[ps][1]);
        *reinterpret_cast<__nv_bfloat162*>(yr + (size_t)8 * H * P) =
            __floats2bfloat162_rn(yacc[ps][2], yacc[ps][3]);
      }
    }

    // state = exp(la_end) state + (x o exp(la_end - la) dt)^T B
    const float decay = __expf(la_end);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[nt][r] *= decay;
#pragma unroll 1
    for (int ks = 0; ks < Q / 16; ++ks) {
      // x^T of rows j (the k of this product) and this warp's 16 p as the
      // A operand, each column j scaled by exp(la_end - la_j) dt_j
      unsigned xa[4], ahi[4], alo[4];
      ldsm_x4_t(xa, xs + (16 * ks + (lm >> 1) * 8 + lr) * LX + pcol + (lm & 1) * 8);
      const int j0 = 16 * ks + 2 * tq;
      float sc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + (q >> 1) * 8 + (q & 1);
        sc[q] = __expf(la_end - la[j]) * dtz[j];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = unpack(xa[q]);
        const int o = (q >> 1) * 2;                  // a4..a7 hold j + 8
        split(v.x * sc[o], v.y * sc[o + 1], ahi[q], alo[q]);
      }
#pragma unroll
      for (int nq = 0; nq < N / 16; ++nq) {
        unsigned bf[4];
        ldsm_x4_t(bf, bs + (16 * ks + (lm & 1) * 8 + lr) * ln + 16 * nq + (lm >> 1) * 8);
        mma(st[2 * nq], ahi, bf[0], bf[1]);
        mma(st[2 * nq], alo, bf[0], bf[1]);
        mma(st[2 * nq + 1], ahi, bf[2], bf[3]);
        mma(st[2 * nq + 1], alo, bf[2], bf[3]);
      }
    }
    __syncthreads();   // stage s and C B^T are rewritten next
  }

  // chunks wholly at or past kv_len never ran: their rows of y are zero,
  // written for the whole group (G P contiguous values, 16-byte aligned
  // since h0 and H are multiples of G)
  constexpr int per_row = G * P / 8;
  const size_t pad_vecs = (size_t)(n_chunks - n_valid) * Q * per_row;
  for (size_t i = tid; i < pad_vecs; i += NT) {
    const int r = n_valid * Q + (int)(i / per_row), k = (int)(i % per_row) * 8;
    *reinterpret_cast<uint4*>(y + (((size_t)b * S + r) * H + h0) * P + k) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int P, int N, typename TD>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* kv_len, void* y, int B, int S, int H,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N, TD>();
  auto kern = ssd_scan_tc_kernel<P, N, TD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H / G, B), Inst<P>::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const TD*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(y), S, H);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the fp32 FMA kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int NT = 256;    // threads per CTA

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
  return (size_t)((P + 3) & ~3) * (N + 1)      // state
         + (size_t)Q * (((P + 3) & ~3) + 1)    // x
         + 2 * (size_t)Q * (N + 1)  // B, C
         + (size_t)Q * (Q + 1)      // weights
         + 2 * (size_t)Q;           // dt, la
}

template <typename T, typename TD>
__global__ void __launch_bounds__(NT)
ssd_scan_fma_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const int* __restrict__ kv_len,
                    T* __restrict__ y, int S, int H, int P, int N, int Q) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int P4 = (P + 3) & ~3;   // P tiled in 4s; columns >= P stay zero
  const int LP = P4 + 1, LN = N + 1, LQ = Q + 1;
  extern __shared__ float smem[];
  float* st = smem;              // (P4, N) state, row stride LN
  float* xs = st + P4 * LN;      // (Q, P4) x of the chunk, row stride LP
  float* bs = xs + Q * LP;       // (Q, N) B of the chunk
  float* cs = bs + Q * LN;       // (Q, N) C of the chunk
  float* w = cs + Q * LN;        // (Q, Q) C B^T o L o dt
  float* dts = w + Q * LQ;       // (Q,) dt, zero at or past kv_len
  float* la = dts + Q;           // (Q,) cumsum(dt * A)

  const int kvl = min(max(kv_len[b], 0), S);
  const int n_chunks = S / Q;
  const int n_valid = (kvl + Q - 1) / Q;
  const float a_h = A[h];
  const int tq = Q / 4, tp = P4 / 4, tn4 = N / 4;

  for (int i = tid; i < P4 * LN; i += NT) st[i] = 0.f;
  for (int i = tid; i < Q * LP; i += NT) xs[i] = 0.f;
  __syncthreads();             // the zeroed columns >= P before any load

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
          if (p < P) y[((size_t)(b * S + s0 + r) * H + h) * P + p] = from_f<T>(acc[i][j]);
        }
    }
    __syncthreads();

    // x_j <- x_j exp(la_end - la_j) dt_j (x is not read again this chunk;
    // exp(la_end - la_j) <= 1, so the zero columns stay zero)
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
  auto kern = ssd_scan_fma_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const int*>(kv_len),
      static_cast<T*>(y), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace simt

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue, launching nothing,
// for a case the kernel does not take); the kernel runs on ``stream``.

// The tensor-core kernel: bf16 x, B, C (x_dtype 1), Q = 64, (P, N) =
// (64, 128) (mamba2) or (50, 16) (hymba), H a multiple of 4, every
// pointer 16-byte aligned.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, const void* kv_len, void* y, int B, int S, int H,
                        int P, int N, int Q, int x_dtype, int dt_dtype, void* stream) {
  const bool mamba2 = P == 64 && N == 128, hymba = P == 50 && N == 16;
  if (B <= 0 || S <= 0 || H <= 0 || H % tc::G || !(mamba2 || hymba) || Q != tc::Q || S % Q ||
      x_dtype != 1 || (dt_dtype != 0 && dt_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(dt) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (mamba2)
    err = dt_dtype == 0 ? tc::launch<64, 128, float>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, s)
                        : tc::launch<64, 128, bf16>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, s);
  else
    err = dt_dtype == 0 ? tc::launch<50, 16, float>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, s)
                        : tc::launch<50, 16, bf16>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, s);
  return (int)err;
}

// The fp32 FMA kernel: x, B, C and dt in float32 or bfloat16; any P >= 1;
// N and Q multiples of 4; the tiles fit in shared memory.
extern "C" int ssd_scan_fma(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* kv_len, void* y, int B, int S,
                            int H, int P, int N, int Q, int x_dtype, int dt_dtype,
                            void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || P <= 0 || S % Q || N % 4 || Q % 4)
    return (int)cudaErrorInvalidValue;
  if (simt::smem_floats(P, N, Q) * sizeof(float) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && dt_dtype == 0)
    err = simt::launch<float, float>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N, Q, s);
  else if (x_dtype == 0 && dt_dtype == 1)
    err = simt::launch<float, __nv_bfloat16>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N, Q, s);
  else if (x_dtype == 1 && dt_dtype == 0)
    err = simt::launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P, N, Q, s);
  else if (x_dtype == 1 && dt_dtype == 1)
    err = simt::launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, kv_len, y, B, S, H, P,
                                                    N, Q, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
