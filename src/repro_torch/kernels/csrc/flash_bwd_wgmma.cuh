// K1, K2 and K3 in bf16 at head dim 256, on Hopper's warpgroup products:
//   flash_fwd_wgmma_kernel      <- _flash_kernel          (C entry flash_fwd)
//   flash_bwd_dq_wgmma_kernel   <- _flash_bwd_dq_kernel   (C entry flash_bwd_dq)
//   flash_bwd_dkv_wgmma_kernel  <- _flash_bwd_dkv_kernel  (C entry flash_bwd_dkv)
// of src/repro/kernels/flash_attention.py.  Part of flash_attention.cu, which
// includes this file inside its anonymous namespace after the other
// tensor-core kernels and uses that file's BQ, BK, NEG_BIG, visible,
// key_tiles, Args, prepare and tc::; the design and what bounds them are
// in that file's note.
//
// One CTA of two warpgroups (256 threads) per 64-row tile.  TMA copies
// fill a two-stage ring guarded by mbarriers (full: the stage has landed;
// empty: both warpgroups are done with it); thread 0 of warpgroup 1 issues
// them, refilling a stage as soon as it is empty.  The warpgroups multiply
// with wgmma (m64nNk16, bf16 operands from 128-byte-swizzled shared memory
// or, for the score tiles, from registers; fp32 accumulators) and each
// owns its outputs whole:
//   fwd:   each takes one query head of the GQA group (its q tile loaded
//          once), s = q k^T, the online softmax, o += p v over the key
//          tiles both read from the ring;
//   dk/dv: 0 computes s^T = k q^T, p^T and dv += p^T do; 1 computes
//          dp^T = v do^T, ds^T = p^T (dp^T - delta) scale, dk += ds^T q;
//   dq:    0 computes s = q k^T and p; 1 computes dp = do v^T and ds; each
//          adds ds k into its 128 of dq's columns.
// In the backward p passes from 0 to 1 in fp32 (and ds from 1 to 0 as
// bf16 operands in dq) through shared memory, under two named barriers.
// With 8 warps a thread may hold 255 registers: the forward's and dk/dv's
// 128 accumulator and 32 score registers fit.  (A separate loading warp
// or warpgroup puts a third warp on an SM sub-partition, whose 16,384
// registers then cap each thread at 168; ptxas did not honour setmaxnreg
// 40 / 232 there, and dk/dv spilled.)  Costs they keep: each warpgroup
// waits on its own products (no overlap of one tile's softmax with the
// next tile's scores), and diagonal tiles are computed whole.

namespace wg {

constexpr int HD = 256;
constexpr int THREADS = 256;             // warpgroups 0 and 1
constexpr uint32_t BOX = 64 * 64 * 2;    // a TMA box: 64 rows of 64 bf16 (128 bytes)
constexpr uint32_t TILE = 4 * BOX;       // 64 rows x 256 columns
constexpr uint32_t STAGE = 2 * TILE;     // a ring stage: two tiles
// shared memory (bytes from a 1 KiB boundary): two fixed tiles, the ring,
// p in fp32, (dq) ds as bf16 operands, then the mbarriers (full[2],
// empty[2], fixed tiles)
constexpr uint32_t RING = 2 * TILE, P = RING + 2 * STAGE, DS = P + 64 * 64 * 4;
constexpr uint32_t DKV_BARS = DS, DQ_BARS = DS + 64 * 64 * 2;
constexpr size_t DKV_SMEM = DKV_BARS + 5 * 8 + 1024;   // + the alignment slack
constexpr size_t DQ_SMEM = DQ_BARS + 5 * 8 + 1024;
// the forward: two q tiles and the ring, then its mbarriers
constexpr uint32_t FWD_BARS = P;
constexpr size_t FWD_SMEM = FWD_BARS + 5 * 8 + 1024;
static_assert(DKV_SMEM <= tc::SMEM_MAX && DQ_SMEM <= tc::SMEM_MAX && FWD_SMEM <= tc::SMEM_MAX,
              "shared memory");
// about 10 s: a lost arrival traps (a failed launch) instead of hanging the card
constexpr long long WAIT_CYCLES = 20000000000LL;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (shared-memory addresses)
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and have the phase also wait for `bytes` of TMA copies
__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > WAIT_CYCLES) __trap();
}
// named barriers 1 and 2 between the consumer warpgroups (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// one 64 x 64 box of a (slabs, S, 256) tensor: columns c0.., rows r0.. of
// slab z (rows past S read as zero)
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                        int r0, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(r0), "r"(z)
      : "memory");
}
// rows r0 .. r0 + 63 of slab z, all 256 columns: four boxes
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar, int r0,
                                         int z) {
#pragma unroll
  for (int c = 0; c < 4; ++c) tma_box(dst + c * BOX, map, bar, 64 * c, r0, z);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the products write these registers asynchronously: keep the compiler
// from moving their reads above wg_wait
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a shared-memory matrix descriptor, 128-byte swizzle: start address; lbo,
// the stride between 64-column blocks (MN-major only); sbo, the stride
// between groups of 8 rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
// k-step ks (columns 16 ks .. 16 ks + 15) of a 64 x 256 tile, K-major: the
// rows are the product's M or N
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return desc(tile + (ks >> 2) * BOX + (ks & 3) * 32, 16, 1024);
}
// k-step ks (rows 16 ks .. 16 ks + 15) of a 64 x 256 tile from column n0 (a
// multiple of 64), MN-major: the columns are the product's N
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int ks, int n0) {
  return desc(tile + (n0 / 64) * BOX + ks * 2048, BOX, 1024);
}

// the products: the accumulator of m64nN holds, for warp w and lane
// 4 g + t, rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8 (d[4 j + 2],
// d[4 j + 3]) at columns 8 j + 2 t, + 1 -- each warp's 16 rows as
// mma.sync's m16n8 tiles side by side
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the A operand of k-step j (columns 16 j .. 16 j + 15) from a 64-column
// accumulator: the m16k16 fragment is the m16n8 tiles 2 j and 2 j + 1,
// rounded to bf16 once
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&s)[32], int j) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = tc::pack(__floats2bfloat162_rn(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]));
}

// the tile's masks: wholly visible, or element by element
__device__ __forceinline__ bool tile_visible(int q0, int k0, int kvl, int causal, int window) {
  return k0 + BK <= kvl && (!causal || k0 + BK <= q0 + 1) &&
         (window <= 0 || q0 + BQ - 1 - k0 < window);
}

// ---------------------------------------------------------------------------
// K3: dk, dv for one 64-key tile of one kv head.  The items are the GQA
// group's query heads (outer) and the 64-query tiles from the causal lower
// bound to ceil(kv_len / 64) (inner), summed in the accumulators in that
// order; the tile's k and v are loaded once, each item's q and do through
// the ring.  Queries at or past kv_len are masked besides the forward's
// masks.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ kv_len, T* __restrict__ dk,
                           T* __restrict__ dv, int H, int Hkv, int S, int causal, int window,
                           float scale) {
  static_assert(std::is_same<T, __nv_bfloat16>::value && D == HD, "bf16 at head dim 256 only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles start on 1 KiB
  float* sp = reinterpret_cast<float*>(smem_raw + (base - raw) + P);   // p^T, fragment order
  const uint32_t full = base + DKV_BARS, empty = full + 16, kv_bar = full + 32;

  // the grid's slowest axis walks the key tiles from the first: under
  // causal masking the longest first
  const int k0 = blockIdx.z * BK, hk = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const int kvl = kv_len[b];
  const int lo = causal ? k0 / BQ : 0;
  const int hi = k0 >= kvl ? 0 : min((S + BQ - 1) / BQ, (kvl + BQ - 1) / BQ);
  const int n_it = max(hi - lo, 0);
  const int n_items = group * n_it;
  // warpgroup 0: s^T, p^T, dv; warpgroup 1: dp^T, ds^T, dk (made
  // warp-uniform for the compiler)
  const bool first = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0;
  const int tid = threadIdx.x % 128, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool loader = threadIdx.x == 128;

  // item i's q and do into stage i % 2
  auto load_item = [&](int i) {
    const int s = i & 1, h = hk * group + i / n_it, q0 = (lo + i % n_it) * BQ;
    const uint32_t st = base + RING + s * STAGE;
    bar_arrive_tx(full + 8 * s, STAGE);
    tma_tile(st, tq, full + 8 * s, q0, b * H + h);
    tma_tile(st + TILE, tdo, full + 8 * s, q0, b * H + h);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, THREADS);
    }
    bar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader && n_items > 0) {
    bar_arrive_tx(kv_bar, 2 * TILE);
    tma_tile(base, tk, kv_bar, k0, b * Hkv + hk);
    tma_tile(base + TILE, tv, kv_bar, k0, b * Hkv + hk);
    for (int i = 0; i < min(n_items, 2); ++i) load_item(i);
  }

  const int kr0 = k0 + 16 * (tid >> 5) + g;   // this thread's key rows kr0, kr0 + 8
  const uint32_t a_tile = first ? base : base + TILE;   // k or v
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  if (n_items > 0) bar_wait(kv_bar, 0);

  for (int i = 0; i < n_items; ++i) {
    const int s = i & 1, h = hk * group + i / n_it, q0 = (lo + i % n_it) * BQ;
    const uint32_t qt = base + RING + s * STAGE, dt = qt + TILE;
    // lse (0) or delta (1) at this thread's query columns 8 j + 2 t (+ 1),
    // in flight during the scores' products
    const float* rows = (first ? lse : delta) + ((size_t)b * H + h) * S;
    float rv[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int qp = q0 + 8 * (c >> 1) + 2 * t + (c & 1);
      rv[c] = qp < S ? rows[qp] : 0.f;
    }
    bar_wait(full + 8 * s, (i >> 1) & 1);

    // s^T = k q^T or dp^T = v do^T: 16 k-steps over the head dim
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) mma_ss_n64(sc, kmajor(a_tile, ks), kmajor(first ? qt : dt, ks));
    wg_commit();
    wg_wait();
    pin(sc);

    if (first) {
      // p^T = exp(s^T scale - lse) under the masks, handed to warpgroup 1
      const bool whole = q0 + BQ <= kvl && tile_visible(q0, k0, kvl, causal, window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1), qp = q0 + c, kp = kr0 + 8 * ((e >> 1) & 1);
        const bool ok = whole || (qp < kvl && visible(qp, kp, kvl, causal, window));
        sc[e] = ok ? exp2f((sc[e] * scale - rv[2 * (e >> 2) + (e & 1)]) * tc::LOG2E) : 0.f;
      }
      if (i > 0) named_sync(1);            // warpgroup 1 has read the last p^T
#pragma unroll
      for (int e = 0; e < 32; ++e) sp[e * 128 + tid] = sc[e];
      named_arrive(2);
    } else {
      // ds^T = p^T (dp^T - delta) scale
      named_sync(2);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sc[e] = sp[e * 128 + tid] * (sc[e] - rv[2 * (e >> 2) + (e & 1)]) * scale;
      if (i + 1 < n_items) named_arrive(1);
    }

    // dv += p^T do or dk += ds^T q: 4 k-steps of 16 queries, 256 columns
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) to_a(a[j], sc, j);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_rs_n256(acc, a[j], mnmajor(first ? dt : qt, j, 0));
    wg_commit();
    wg_wait();
    pin(acc);
    bar_arrive(empty + 8 * s);
    // the stage is refilled once both warpgroups are done with it
    if (loader && i + 2 < n_items) {
      bar_wait(empty + 8 * s, (i >> 1) & 1);
      load_item(i + 2);
    }
  }

  T* out = first ? dv : dk;
  const size_t koff = ((size_t)b * Hkv + hk) * S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kr0 + 8 * i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      tc::store_pair(out + koff + (size_t)kp * HD + 8 * j + 2 * t, acc[4 * j + 2 * i],
                     acc[4 * j + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K2: dq for one 64-row q tile of one head.  q and do are loaded once, the
// key tiles (k, v) through the ring, up to the causal bound and
// ceil(kv_len / 64).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ kv_len, T* __restrict__ dq, int H, int Hkv,
                          int S, int causal, int window, float scale) {
  static_assert(std::is_same<T, __nv_bfloat16>::value && D == HD, "bf16 at head dim 256 only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* sp = reinterpret_cast<float*>(sm + P);          // p, in fragment order
  uint32_t* sds = reinterpret_cast<uint32_t*>(sm + DS);   // ds as bf16 operands
  const uint32_t full = base + DQ_BARS, empty = full + 16, q_bar = full + 32;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;   // longest first
  const int q0 = qt * BQ;
  const int hk = h / (H / Hkv);
  const int kvl = kv_len[b];
  const int n_kt = key_tiles(q0, S, kvl, causal);
  // warpgroup 0: s, p; warpgroup 1: dp, ds; each adds ds k into its half
  // of dq's columns (made warp-uniform for the compiler)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const bool first = wgi == 0;
  const int n0 = 128 * wgi;
  const int tid = threadIdx.x % 128, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool loader = threadIdx.x == 128;

  // key tile kt's k and v into stage kt % 2
  auto load_keys = [&](int kt) {
    const int s = kt & 1;
    const uint32_t st = base + RING + s * STAGE;
    bar_arrive_tx(full + 8 * s, STAGE);
    tma_tile(st, tk, full + 8 * s, kt * BK, b * Hkv + hk);
    tma_tile(st + TILE, tv, full + 8 * s, kt * BK, b * Hkv + hk);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, THREADS);
    }
    bar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader && n_kt > 0) {
    bar_arrive_tx(q_bar, 2 * TILE);
    tma_tile(base, tq, q_bar, q0, b * H + h);
    tma_tile(base + TILE, tdo, q_bar, q0, b * H + h);
    for (int kt = 0; kt < min(n_kt, 2); ++kt) load_keys(kt);
  }

  const int r0 = q0 + 16 * (tid >> 5) + g;   // this thread's rows r0, r0 + 8
  const size_t roff = ((size_t)b * H + h) * S;
  float rv[2];                               // lse (0) or delta (1) of those rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    rv[i] = row < S ? (first ? lse : delta)[roff + row] : 0.f;
  }
  const uint32_t a_tile = first ? base : base + TILE;   // q or do
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  if (n_kt > 0) bar_wait(q_bar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * BK;
    const uint32_t kt_tile = base + RING + s * STAGE, vt_tile = kt_tile + TILE;
    bar_wait(full + 8 * s, (kt >> 1) & 1);

    // s = q k^T or dp = do v^T: 16 k-steps over the head dim
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      mma_ss_n64(sc, kmajor(a_tile, ks), kmajor(first ? kt_tile : vt_tile, ks));
    wg_commit();
    wg_wait();
    pin(sc);

    uint32_t a[4][4];
    if (first) {
      // p = exp(s scale - lse) under the masks, handed to warpgroup 1;
      // ds comes back as bf16 operands
      const bool whole = tile_visible(q0, k0, kvl, causal, window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, kp = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const bool ok = whole || visible(r0 + 8 * i, kp, kvl, causal, window);
        sc[e] = ok ? exp2f((sc[e] * scale - rv[i]) * tc::LOG2E) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) sp[e * 128 + tid] = sc[e];
      named_arrive(1);
      named_sync(2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[j][r] = sds[(4 * j + r) * 128 + tid];
    } else {
      // ds = p (dp - delta) scale
      named_sync(1);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sc[e] = sp[e * 128 + tid] * (sc[e] - rv[(e >> 1) & 1]) * scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        to_a(a[j], sc, j);
#pragma unroll
        for (int r = 0; r < 4; ++r) sds[(4 * j + r) * 128 + tid] = a[j][r];
      }
      named_arrive(2);
    }

    // dq[:, n0 .. n0 + 127] += ds k: 4 k-steps of 16 keys
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_rs_n128(acc, a[j], mnmajor(kt_tile, j, n0));
    wg_commit();
    wg_wait();
    pin(acc);
    bar_arrive(empty + 8 * s);
    // the stage is refilled once both warpgroups are done with it
    if (loader && kt + 2 < n_kt) {
      bar_wait(empty + 8 * s, (kt >> 1) & 1);
      load_keys(kt + 2);
    }
  }

  const size_t qoff = roff * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      tc::store_pair(dq + qoff + (size_t)row * HD + n0 + 8 * j + 2 * t, acc[4 * j + 2 * i],
                     acc[4 * j + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K1: o and lse for one 64-row q tile of up to two query heads of one kv
// head's GQA group, one head per warpgroup (the CTA's pair pr takes the
// group's heads 2 pr and 2 pr + 1; with an odd group the last pair's
// warpgroup 1 only keeps the ring turning).  Both q tiles are loaded
// once, the key tiles (k, v) through the ring, up to the causal bound and
// ceil(kv_len / 64), so one k and v read serves two heads.  Per key tile
// each warpgroup computes s = q k^T, the online softmax on it in fp32 and
// o += p v with p rounded to bf16 once, from registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                       T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int S,
                       int causal, int window, float scale) {
  static_assert(std::is_same<T, __nv_bfloat16>::value && D == HD, "bf16 at head dim 256 only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + FWD_BARS, empty = full + 16, q_bar = full + 32;

  const int group = H / Hkv, pairs = (group + 1) / 2;
  const int hk = blockIdx.x / pairs, pr = blockIdx.x % pairs, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;   // longest first
  const int q0 = qt * BQ;
  const int kvl = kv_len[b];
  const int n_kt = key_tiles(q0, S, kvl, causal);
  const int n_heads = min(group - 2 * pr, 2);   // this CTA's query heads
  // warpgroup wgi owns head h (made warp-uniform for the compiler)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const bool active = wgi < n_heads;
  const int h = hk * group + 2 * pr + wgi;
  const int tid = threadIdx.x % 128, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool loader = threadIdx.x == 128;

  // key tile kt's k and v into stage kt % 2
  auto load_keys = [&](int kt) {
    const int s = kt & 1;
    const uint32_t st = base + RING + s * STAGE;
    bar_arrive_tx(full + 8 * s, STAGE);
    tma_tile(st, tk, full + 8 * s, kt * BK, b * Hkv + hk);
    tma_tile(st + TILE, tv, full + 8 * s, kt * BK, b * Hkv + hk);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, THREADS);
    }
    bar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader && n_kt > 0) {
    bar_arrive_tx(q_bar, n_heads * TILE);
    for (int i = 0; i < n_heads; ++i) tma_tile(base + i * TILE, tq, q_bar, q0, b * H + h - wgi + i);
    for (int kt = 0; kt < min(n_kt, 2); ++kt) load_keys(kt);
  }

  const int r0 = q0 + 16 * (tid >> 5) + g;   // this thread's rows r0, r0 + 8
  const uint32_t q_tile = base + wgi * TILE;
  float acc[128], m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  if (n_kt > 0) bar_wait(q_bar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * BK;
    const uint32_t k_tile = base + RING + s * STAGE, v_tile = k_tile + TILE;
    bar_wait(full + 8 * s, (kt >> 1) & 1);
    if (active) {
      // s = q k^T: 16 k-steps over the head dim
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) mma_ss_n64(sc, kmajor(q_tile, ks), kmajor(k_tile, ks));
      wg_commit();
      wg_wait();
      pin(sc);

      // the online softmax: masks only where the tile is not wholly
      // visible; m stays finite (>= NEG_BIG), so exp never sees inf - inf
      const bool whole = tile_visible(q0, k0, kvl, causal, window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, kp = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        float x = sc[e] * scale;
        if (!whole && !visible(r0 + 8 * i, kp, kvl, causal, window)) x = -INFINITY;
        sc[e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], tc::quad_max(mx[i]));
        corr[i] = exp2f((m[i] - m_new) * tc::LOG2E);
        m[i] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const float p = exp2f((sc[e] - m[i]) * tc::LOG2E);   // 0 where masked
        sc[e] = p;
        rs[i] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];   // this lane's part
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }

      // o += p v: 4 k-steps of 16 keys, all 256 columns, p from registers
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) to_a(a[j], sc, j);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_rs_n256(acc, a[j], mnmajor(v_tile, j, 0));
      wg_commit();
      wg_wait();
      pin(acc);
    }
    bar_arrive(empty + 8 * s);
    // the stage is refilled once both warpgroups are done with it
    if (loader && kt + 2 < n_kt) {
      bar_wait(empty + 8 * s, (kt >> 1) & 1);
      load_keys(kt + 2);
    }
  }
  if (!active) return;

  const size_t roff = ((size_t)b * H + h) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const float lc = fmaxf(tc::quad_sum(l[i]), 1e-30f);
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      tc::store_pair(o + (roff + row) * HD + 8 * j + 2 * t, acc[4 * j + 2 * i] / lc,
                     acc[4 * j + 2 * i + 1] / lc);
    if (t == 0) lse[roff + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (the
// library does not link libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a contiguous (slabs, S, 256) bf16 tensor as 64 x 64 boxes with 128-byte
// swizzle, the layout wgmma reads; rows past S read as zero, so no box
// reaches into the next slab
bool tile_map(CUtensorMap* map, const void* ptr, int S, int slabs) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {HD, (cuuint64_t)S, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {HD * 2, (cuuint64_t)S * HD * 2};   // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, 64, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool maps(const Args& a, CUtensorMap& tq, CUtensorMap& tk, CUtensorMap& tv, CUtensorMap& tdo) {
  return tile_map(&tq, a.q, a.S, a.B * a.H) && tile_map(&tk, a.k, a.S, a.B * a.Hkv) &&
         tile_map(&tv, a.v, a.S, a.B * a.Hkv) && tile_map(&tdo, a.dout, a.S, a.B * a.H);
}

cudaError_t run_fwd(const Args& a) {
  auto kern = flash_fwd_wgmma_kernel<__nv_bfloat16, HD>;
  cudaError_t e = prepare(kern, FWD_SMEM);
  if (e != cudaSuccess) return e;
  if (a.info) return describe(kern, THREADS, FWD_SMEM, a.info);
  CUtensorMap tq, tk, tv;
  if (!(tile_map(&tq, a.q, a.S, a.B * a.H) && tile_map(&tk, a.k, a.S, a.B * a.Hkv) &&
        tile_map(&tv, a.v, a.S, a.B * a.Hkv)))
    return cudaErrorInvalidValue;
  dim3 grid(a.Hkv * ((a.H / a.Hkv + 1) / 2), a.B, (a.S + BQ - 1) / BQ);
  kern<<<grid, THREADS, FWD_SMEM, a.stream>>>(tq, tk, tv, (const int*)a.kv_len,
                                              (__nv_bfloat16*)a.o, (float*)a.lse_out, a.H,
                                              a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t run_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_wgmma_kernel<__nv_bfloat16, HD>;
  cudaError_t e = prepare(kern, DKV_SMEM);
  if (e != cudaSuccess) return e;
  if (a.info) return describe(kern, THREADS, DKV_SMEM, a.info);
  CUtensorMap tq, tk, tv, tdo;
  if (!maps(a, tq, tk, tv, tdo)) return cudaErrorInvalidValue;
  dim3 grid(a.Hkv, a.B, (a.S + BK - 1) / BK);
  kern<<<grid, THREADS, DKV_SMEM, a.stream>>>(
      tq, tk, tv, tdo, (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t run_dq(const Args& a) {
  auto kern = flash_bwd_dq_wgmma_kernel<__nv_bfloat16, HD>;
  cudaError_t e = prepare(kern, DQ_SMEM);
  if (e != cudaSuccess) return e;
  if (a.info) return describe(kern, THREADS, DQ_SMEM, a.info);
  CUtensorMap tq, tk, tv, tdo;
  if (!maps(a, tq, tk, tv, tdo)) return cudaErrorInvalidValue;
  dim3 grid(a.H, a.B, (a.S + BQ - 1) / BQ);
  kern<<<grid, THREADS, DQ_SMEM, a.stream>>>(
      tq, tk, tv, tdo, (const float*)a.lse, (const float*)a.delta, (const int*)a.kv_len,
      (__nv_bfloat16*)a.dq, a.H, a.Hkv, a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace wg
