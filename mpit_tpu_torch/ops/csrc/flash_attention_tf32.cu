// K4, K5 and K6 for float32 on Hopper's tensor cores (sm_90a), at float32
// accuracy: 3xTF32.
//
// Replaces, for float32 inputs, the Pallas kernels of
// mpit_tpu/ops/flash_attention.py:
//   K4  `_fa_kernel` (:233; `_fa_2d`, both output modes)  -> fa_fwd_tf32_kernel
//   K5  `_fa_bwd_fused_kernel` (:623; `_fa_2d_bwd(fused=True)`)
//                                                          -> fa_bwd_tf32_kernel
//                                                             + dq_reduce_kernel
//   K6  `_fa_bwd_dq_kernel` (:536) and `_fa_bwd_dkdv_kernel` (:576;
//       `_fa_2d_bwd(fused=False)`)                         -> fa_bwd_dq_tf32_kernel,
//                                                             fa_bwd_dkdv_tf32_kernel
// bfloat16 K4, K5 and K6 run in flash_attention_tc.cu.  The contract: the
// validity rule and the dead / edge / full triage (`triage` in
// flash_common.cuh), the -1e30 sentinel for the running max and -inf in
// the public m and lse of dead rows, both output modes, any offsets, D a
// multiple of 8 up to 128, every sum in float32, and K5's dQ as float32
// partials, one slot a key tile, which dead pairs never write and one
// deterministic reduction sums; K6 needs no transient.  No atomics: the
// same bits every run.
//
// 3xTF32.  One TF32 product keeps 11 bits of each operand, some 5e-4 of
// an attention output here, past the reference's 2e-5.  So each float32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna:
// to nearest, ties away; x - hi is exact), and each product is lo.hi +
// hi.lo + hi.hi, three TF32 products into float32 accumulators; lo.lo,
// 2^-22 of the product, is dropped.  Emulated on the CPU
// (tests/test_torch_flash_tf32.py), the outputs stay within a few 1e-7 of
// float32.  The tensor cores' float32 accumulation, though, is not
// float32's: each step adds its products to the accumulator and cuts the
// sum toward zero, so what a long-lived accumulator loses grows with its
// steps.  A first design that kept dV in one accumulator across K5's
// sweep put it 6.6e-5 from its twin at L 1,024, D 32, twice the limit,
// and one that kept K4's O across the key tiles put the LM gang's Adam
// steps 2x past their limit.  So dV and dK take each q tile's product in
// a fresh accumulator and add it by float32 adds, as do K6's dQ each key
// tile's dS.K (up to 1,024 key tiles at L 32,768, summed by float32 adds)
// and K4's O each key tile's P.V up to K4_FRESH_PV_MAX_DM; a product over
// the head width keeps each step's hi.hi apart from the cross terms, taken
// from zero and added in float32 (K4's S; K6's S and dP; K5's S^T, dP^T
// and dQ partials up to K5_APART_MAX_DM).  At D 128 the registers, which
// hold O in K4 and dK and dV in K5, have no room for the rest: there O
// sums across key tiles in one accumulator (rescaled by each tile's alpha;
// 1.4e-6 from its twin at L 8,192, the limit 2e-5), as do K5's S^T, dP^T
// and dQ partials over the head width.  Against float64 on the card the outputs lie about as
// close as the float32 twins' do, dV and dK closer
// (tools/torch_flash_f32.py --truth).
//
// Bound on this card: operations.  At lm_longcontext's attention (N 8, L
// 8,192, D 128, causal: 268,468,224 valid pairs) the forward does 4 D
// flops a pair, 137 GFLOP, as three TF32 passes at 495 TFLOP/s: 0.833 ms;
// the backward 10 D, 344 GFLOP: 2.08 ms, and K5's dQ partials, one float32
// (32 q rows, D) block a live (q tile, key tile) pair, move ~1.1 GB each
// way over 128-key tiles (0.33 ms to read at 3.35 TB/s).  K6 does 14 D a
// pair (both kernels recompute S and dP) and moves no partials; at the
// 32k LM's attention (4,295,098,368 pairs) the backward's 10 D is 5.5
// TFLOP, 33.3 ms in three passes.
//
// Route: mma.sync.m16n8k8 with TF32 operands, not wgmma.  wgmma's .tf32
// form reads shared-memory operands K-major only (no transpose bit), so V
// in O += P.V, dO in dV += P^T.dO, Q in dK += dS^T.Q and K in dQ = dS.K
// would each need a transposed copy, hi and lo, beside the one the other
// product reads: more shared memory than a block has at D 128.  mma.sync's
// fragments are loaded by the threads themselves, from any layout, so one
// copy of a tile serves both products, and an operand is split as it is
// loaded; its peak is below wgmma's.
//
// Design, simple first.  Eight warps a block; a warp owns 16 rows of the
// product's M (q rows in K4 and K6's dQ, keys in K5 and K6's dK and dV)
// and runs m16n8k8 over them.  The
// threads copy each tile from device memory into shared memory, 16 bytes a
// thread (rows past L and columns past d as zeros, which pads D to 32, 64
// or 128), between two barriers of the block; no copy overlaps a product.
// A tile read as B (the operand loaded anew for every 8 columns of the
// output) is stored split, its hi and lo planes side by side, so each load
// feeds the tensor cores directly; a tile read as A is stored as loaded and
// split in registers, where one A fragment serves every n-tile of its
// k-step.  Rows are padded to D + 4 floats, so the fragments' two access
// patterns (8 rows by 4 columns, and 4 row pairs by 8 columns) both hit 32
// different banks; K in K5, read as A by rows and as dQ's B by columns, to
// D + 8.  A product's accumulator holds columns 2 tc and 2 tc + 1 of each
// 8-column tile in thread tc of a quad; taken as the A fragment of the next
// product it stands at k = tc and tc + 4, and that product's B rows are
// read in the same order (2 tc, then 2 tc + 1), so P, P^T and dS^T never
// leave registers as A operands.  Under the causal mask the live tiles of
// a row of tiles form one contiguous range (`live_range`): dead tiles are
// never loaded, and only edge tiles mask element by element (keys past Lk
// among them).  q rows past Lq load as zeros, with lse and delta 0: their
// P is finite and their dS 0, and their dQ is not written.
// - K4: a block owns 128 q rows of one head (Q as loaded) and walks the
//   live 64-key tiles (K and V split).  S = Q.K^T, the online softmax on
//   the accumulator in registers (a row lies in the four threads of a quad:
//   two shuffles), O += P.V.  Blocks run heaviest first (the last q tiles).
// - K5: a block owns 128 keys of one head (K and V as loaded), dK and dV
//   in registers across the sweep over the live 32-row q tiles (Q and dO
//   split; lse and delta rows).  S^T = K.Q^T and dP^T = V.dO^T; P^T =
//   exp(scale s - lse) and dS^T = P^T (dP^T - delta) in registers; dV +=
//   P^T.dO and dK += dS^T.Q.  dS^T also goes to shared memory, and after
//   the block's barrier this pair's dQ = dS.K over all 128 keys (a warp 16
//   q rows by D / 4 columns, K split as it is loaded) is written as one
//   float32 partial into the slot of the key tile.  dq_reduce_kernel sums,
//   for each q tile, only its live key tiles' slots in ascending order.
// - K6, dK and dV: K5's sweep without its dQ product and partials (one
//   body, `bwd_kv_tf32_body`, given no dQ scratch), so dK and dV are K5's,
//   bit for bit.  dS^T still goes through shared memory for dK: kept in
//   registers beside dK and dV, it made ptxas spill at D 128.
// - K6, dQ: a block owns 128 q rows of one head in K4's shape (8 warps of
//   16 rows; Q and dO as loaded, once, and the rows' lse and delta in
//   registers) and walks the live key tiles (K and V split): S = Q.K^T
//   and dP = dO.V^T, P = exp(scale s - lse) and dS = P (dP - delta) in
//   registers, then dQ += dS.K with dS the A operand straight from the
//   accumulators and K read by columns from the plane S read by rows;
//   dQ is scaled once at the end.  Key tiles of 64, of 32 at D 128,
//   where Q and dO (128 rows each) and K and V split (64 keys) would pass
//   the block's 227 KB.  Blocks run heaviest first.
#include "flash_common.cuh"

#include <type_traits>

namespace {

constexpr int NT = 256;               // threads a block: 8 warps
constexpr int F_BQ = 128, F_BK = 64;  // K4: q rows a block (16 a warp), keys a tile
constexpr int B_BK = 128, B_BQ = 32;  // K5, K6's dK/dV: keys a block (16 a warp), q rows a tile
constexpr int D_BQ = 128;             // K6's dQ: q rows a block (16 a warp); keys a tile: DqSmem
// Accuracy where registers allow it (see the header): K4 takes each key
// tile's P.V in fresh accumulators up to this head width; K5's sweep (K6's
// dK/dV kernel too) keeps hi.hi apart in S^T, dP^T and its dQ partials up
// to this one.  At D 128 either made ptxas spill.  K6's dQ kernel, with
// only dQ to hold, keeps S and dP apart at every width.
constexpr int K4_FRESH_PV_MAX_DM = 64;
constexpr int K5_APART_MAX_DM = 64;

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + what neither keeps (about 2^-22 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
}

// d += a.b over one m16n8k8 tile, TF32 in, float32 accumulate.  Fragments
// (g = lane / 4, tc = lane % 4): a0..a3 hold A (row, k) = (g, tc), (g + 8,
// tc), (g, tc + 4), (g + 8, tc + 4); b0, b1 hold B (k, column) = (tc, g),
// (tc + 4, g); d0..d3 hold (g, 2 tc), (g, 2 tc + 1), (g + 8, 2 tc), (g + 8,
// 2 tc + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b at float32 accuracy: the two cross terms, then hi.hi.
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// d = a.b over one m16n8k8 tile, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4], const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
                 "f"(0.f));
}

// a.b at float32 accuracy, added over k-steps: the cross terms into dl
// (some 2^-11 of dh, so the bits its sums cut weigh nothing), and each
// step's hi.hi taken from zero and added to dh in float32; the product is
// dh + dl.
__device__ __forceinline__ void mma_3x(float (&dh)[4], float (&dl)[4],
                                       const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                       const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(dl, al, bh);
  mma_tf32(dl, ah, bl);
  float t[4];
  mma_tf32_from_zero(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) dh[e] += t[e];
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] = 0.f;
}

// d = hi + lo, tile by tile.
template <int N>
__device__ __forceinline__ void add_apart(float (&d)[N][4], const float (&hi)[N][4],
                                          const float (&lo)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] = hi[t][e] + lo[t][e];
}

// A load from shared memory kept in program order with the products
// around it (volatile), so the compiler does not hoist a loop's loads far
// ahead of their products and run out of registers.
__device__ __forceinline__ uint32_t ld_shared(const float* p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

// B's two values for thread (g, tc) from its hi and lo planes: at `at` and
// `at + step` floats.
__device__ __forceinline__ void b_frag(const float* hi, const float* lo, int at, int step,
                                       uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  bh[0] = ld_shared(hi + at);
  bh[1] = ld_shared(hi + at + step);
  bl[0] = ld_shared(lo + at);
  bl[1] = ld_shared(lo + at + step);
}

// An A fragment of a row-major tile (stride ld floats) at `p` = (row g,
// column tc) of the 16 x 8 block, split.
__device__ __forceinline__ void a_frag(const float* p, int ld, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  split4(x, ah, al);
}

// An accumulator tile taken as the A fragment of the next product: its
// columns 2 tc, 2 tc + 1 stand at k = tc, tc + 4 (the B rows are read in
// that order), split.
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split4(x, ah, al);
}

// Rows row0 .. row0 + ROWS - 1 of a (rows, d) float32 matrix into a (ROWS,
// LD) tile in shared memory, 16 bytes a thread: as loaded (lo null), or
// split into its hi plane `dst` and lo plane `lo`.  Rows past `rows` and
// columns past d (up to DM) read as 0.  src starts on 16 bytes and d is a
// multiple of 8, so every row does.
template <int ROWS, int DM, int LD>
__device__ __forceinline__ void load_tile(float* dst, float* lo, const float* __restrict__ src,
                                          int row0, int rows, int d) {
  constexpr int Q4 = DM / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * Q4; idx += NT) {
    const int r = idx / Q4, c = (idx % Q4) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && c < d) x = *reinterpret_cast<const float4*>(src + (size_t)row * d + c);
    if (lo == nullptr) {
      *reinterpret_cast<float4*>(dst + r * LD + c) = x;
    } else {
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = h;
      *reinterpret_cast<uint4*>(lo + r * LD + c) = l;
    }
  }
}

// A.B^T over the head width: this warp's 16 rows of A by the N x 8 rows of
// B.  A is read by rows from `a` (the thread's row gr, column tc; stride
// LDA), B from its hi and lo planes (stride DM + 4).  APART keeps each
// k-step's hi.hi apart from the cross terms; else the product sums in one
// accumulator over the head width (at D 128 K5's registers hold dK and dV
// beside it: none is left for more).
template <int DM, int LDA, int N, bool APART>
__device__ __forceinline__ void product_nt(float (&d)[N][4], const float* a, const float* bhi,
                                           const float* blo, int gr, int tc) {
  constexpr int LD = DM + 4;
  float lo[APART ? N : 1][4];
  zero(d);
  zero(lo);
#pragma unroll 1
  for (int kc = 0; kc < DM / 8; ++kc) {
    uint32_t ah[4], al[4];
    a_frag(a + kc * 8, LDA, ah, al);
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      uint32_t bh[2], bl[2];
      b_frag(bhi, blo, (nt * 8 + gr) * LD + kc * 8 + tc, 4, bh, bl);
      if constexpr (APART)
        mma_3x(d[nt], lo[nt], ah, al, bh, bl);
      else
        mma_3x(d[nt], ah, al, bh, bl);
    }
  }
  if constexpr (APART) add_apart(d, d, lo);
}

// ---------------------------------------------------------------------------
// K4: forward
// ---------------------------------------------------------------------------

template <int DM>
struct FwdSmem {
  static constexpr int LD = DM + 4;
  // Q as loaded (F_BQ rows), K and V split (F_BK rows, hi and lo each).
  static constexpr size_t BYTES = ((size_t)F_BQ * LD + 4 * (size_t)F_BK * LD) * sizeof(float);
};

template <int DM, bool PARTIAL>
__global__ void __launch_bounds__(NT, 1)
fa_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, Geo g) {
  constexpr int LD = FwdSmem<DM>::LD, ND = DM / 8, NK = F_BK / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKh = sQ + F_BQ * LD;
  float* sKl = sKh + F_BK * LD;
  float* sVh = sKl + F_BK * LD;
  float* sVl = sVh + F_BK * LD;

  const int n_tiles = (g.lq + F_BQ - 1) / F_BQ;
  const int i = n_tiles - 1 - (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int r0 = warp * 16;                 // this warp's local q rows
  const int row_lo = i * F_BQ + r0 + gr;    // this thread's rows: row_lo, row_lo + 8
  const size_t qbase = (size_t)n * g.lq * g.d, kbase = (size_t)n * g.lk * g.d;
  int j_lo, j_hi;
  live_range<F_BQ, F_BK, false>(g, i, (g.lk + F_BK - 1) / F_BK, j_lo, j_hi);

  load_tile<F_BQ, DM, LD>(sQ, nullptr, q + qbase, i * F_BQ, g.lq, g.d);
  float oacc[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[t][e] = 0.f;
  float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};

  for (int j = j_lo; j < j_hi; ++j) {
    const int kind = triage<F_BQ, F_BK>(g, i, j);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<F_BK, DM, LD>(sKh, sKl, k + kbase, j * F_BK, g.lk, g.d);
    load_tile<F_BK, DM, LD>(sVh, sVl, v + kbase, j * F_BK, g.lk, g.d);
    __syncthreads();

    // S = Q.K^T: A (Q) by rows, B (K) by rows as K^T's columns.
    float s[NK][4];
    product_nt<DM, LD, NK, true>(s, sQ + (r0 + gr) * LD + tc, sKh, sKl, gr, tc);

    // The online softmax, on the accumulator in registers.  A masked score
    // is -inf; m starts at the finite sentinel, so exp(s - m) is 0 there
    // and never NaN.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = __fmul_rn(s[t][e], g.scale);  // rounded alone, as the twin does
        if (kind == 1 && !valid(g, row_lo + 8 * h, j * F_BK + t * 8 + 2 * tc + (e & 1)))
          x = -INFINITY;
        s[t][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[t][e] - m[e >> 1]);
        s[t][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = alpha[h] * l[h] + rs[h];
    }

    // O = alpha O + P.V: P from the accumulator S, V's rows 2 tc and 2 tc
    // + 1 of each 8-key step.
    if constexpr (DM <= K4_FRESH_PV_MAX_DM) {
      // Each 8 columns' P.V over the tile in a fresh accumulator, then
      // O = alpha O + P.V in float32.
      uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) acc_as_a(s[kk], ph[kk], pl[kk]);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t bh[2], bl[2];
          b_frag(sVh, sVl, (kk * 8 + 2 * tc) * LD + dt * 8 + gr, LD, bh, bl);
          mma_3x(pv, ph[kk], pl[kk], bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[dt][e] = oacc[dt][e] * alpha[e >> 1] + pv[e];
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[dt][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ph[4], pl[4];
        acc_as_a(s[kk], ph, pl);
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          uint32_t bh[2], bl[2];
          b_frag(sVh, sVl, (kk * 8 + 2 * tc) * LD + dt * 8 + gr, LD, bh, bl);
          mma_3x(oacc[dt], ph, pl, bh, bl);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= g.lq) continue;
    const size_t ro = ((size_t)n * g.lq + row) * g.d;
    const size_t so = (size_t)n * g.lq + row;
    const float m_pub = m[h] == BIG_NEG ? -INFINITY : m[h];
    if (PARTIAL) {
#pragma unroll
      for (int t = 0; t < ND; ++t) {
        const int col = t * 8 + 2 * tc;
        if (col < g.d)
          *reinterpret_cast<float2*>(acc_out + ro + col) =
              make_float2(oacc[t][2 * h], oacc[t][2 * h + 1]);
      }
      if (tc == 0) {
        m_out[so] = m_pub;
        l_out[so] = l[h];
      }
    } else {
      const float den = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
      for (int t = 0; t < ND; ++t) {
        const int col = t * 8 + 2 * tc;
        if (col < g.d)
          *reinterpret_cast<float2*>(o + ro + col) =
              make_float2(oacc[t][2 * h] / den, oacc[t][2 * h + 1] / den);
      }
      if (lse != nullptr && tc == 0) lse[so] = m_pub + logf(den);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: fused backward, key tiles outer
// ---------------------------------------------------------------------------

// acc += C^T.B over the q tile: C^T (P^T or dS^T, this warp's keys by
// the tile's q rows) as split A fragments whose k = tc and tc + 4 stand
// for q rows 2 tc and 2 tc + 1 of each 8-row step; B (dO or Q) from its
// planes, rows 2 tc and 2 tc + 1 of each step.  Each 8 columns' product
// over the tile takes a fresh accumulator, then is added.
template <int ND, int NQ, int LD>
__device__ __forceinline__ void tile_product(float (&acc)[ND][4], const uint32_t (&ah)[NQ][4],
                                             const uint32_t (&al)[NQ][4], const float* bhi,
                                             const float* blo, int gr, int tc) {
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      uint32_t bh[2], bl[2];
      b_frag(bhi, blo, (kk * 8 + 2 * tc) * LD + dt * 8 + gr, LD, bh, bl);
      mma_3x(t, ah[kk], al[kk], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] += t[e];
  }
}

// tile_product's fragments of C^T from a product's accumulators: tile kk's
// columns 2 tc, 2 tc + 1 stand at k = tc and tc + 4, split.
template <int N>
__device__ __forceinline__ void accs_as_a(const float (&c)[N][4], uint32_t (&ah)[N][4],
                                          uint32_t (&al)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) acc_as_a(c[kk], ah[kk], al[kk]);
}

template <int DM>
struct BwdSmem {
  static constexpr int LD = DM + 4;
  static constexpr int LDK = DM + 8;    // K: read as A by rows and as dQ's B by columns
  static constexpr int LDS = B_BK + 4;  // dS: B_BQ q rows by B_BK keys
  // K and V as loaded (B_BK rows), Q and dO split (B_BQ rows, hi and lo
  // each), dS, the q tile's lse and delta rows.
  static constexpr size_t BYTES =
      ((size_t)B_BK * LDK + (size_t)B_BK * LD + 4 * (size_t)B_BQ * LD + (size_t)B_BQ * LDS +
       2 * B_BQ) * sizeof(float);
};

// The sweep of one block's 128 keys over their live q tiles, dK and dV in
// registers.  Given a dQ scratch (K5) it also writes each live pair's dQ
// partial into dqp; K6's dK/dV kernel passes none (null, the same for
// every thread of the launch) and skips that work.  A run-time switch, not
// a template flag: compiled without the dQ code, the sweep made ptxas
// spill at D 128 (24 bytes), where K5's does not.
template <int DM>
__device__ __forceinline__ void bwd_kv_tf32_body(const float* __restrict__ q,
                                                 const float* __restrict__ k,
                                                 const float* __restrict__ v,
                                                 const float* __restrict__ dout,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 float* __restrict__ dk, float* __restrict__ dv,
                                                 float* __restrict__ dqp, const Geo& g) {
  using S = BwdSmem<DM>;
  constexpr int LD = S::LD, LDK = S::LDK, LDS = S::LDS;
  constexpr int ND = DM / 8;    // n-tiles of the head width
  constexpr int NQ = B_BQ / 8;  // n-tiles (and k-steps) of a q tile
  constexpr int NDQ = DM / 32;  // dQ n-tiles a warp: 2 row tiles x ND over 8 warps
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + B_BK * LDK;
  float* sQh = sV + B_BK * LD;
  float* sQl = sQh + B_BQ * LD;
  float* sOh = sQl + B_BQ * LD;  // dO
  float* sOl = sOh + B_BQ * LD;
  float* sDS = sOl + B_BQ * LD;
  float* sLse = sDS + B_BQ * LDS;
  float* sDelta = sLse + B_BQ;

  const int j = (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int kr0 = warp * 16;  // this warp's local keys; this thread's: kr0 + gr, + 8
  const size_t qbase = (size_t)n * g.lq * g.d, kbase = (size_t)n * g.lk * g.d;
  const size_t sbase = (size_t)n * g.lq;
  int i_lo, i_hi;
  live_range<B_BQ, B_BK, true>(g, j, (g.lq + B_BQ - 1) / B_BQ, i_lo, i_hi);

  load_tile<B_BK, DM, LDK>(sK, nullptr, k + kbase, j * B_BK, g.lk, g.d);
  load_tile<B_BK, DM, LD>(sV, nullptr, v + kbase, j * B_BK, g.lk, g.d);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  for (int i = i_lo; i < i_hi; ++i) {
    const int kind = triage<B_BQ, B_BK>(g, i, j);
    __syncthreads();  // every warp is done with the previous tile's Q, dO and dS
    load_tile<B_BQ, DM, LD>(sQh, sQl, q + qbase, i * B_BQ, g.lq, g.d);
    load_tile<B_BQ, DM, LD>(sOh, sOl, dout + qbase, i * B_BQ, g.lq, g.d);
    if (threadIdx.x < B_BQ) {
      // 0 past Lq, where the Q and dO rows are zeros.
      const int row = i * B_BQ + threadIdx.x;
      sLse[threadIdx.x] = row < g.lq ? lse[sbase + row] : 0.f;
      sDelta[threadIdx.x] = row < g.lq ? delta[sbase + row] : 0.f;
    }
    __syncthreads();

    // S^T = K.Q^T, then dP^T = V.dO^T, this warp's 16 keys by B_BQ q rows:
    // A (K, V) by rows, B (Q, dO) by rows as their transposes' columns.
    constexpr bool APART = DM <= K5_APART_MAX_DM;
    float st[NQ][4], dpt[NQ][4];
    product_nt<DM, LDK, NQ, APART>(st, sK + (kr0 + gr) * LDK + tc, sQh, sQl, gr, tc);
    product_nt<DM, LD, NQ, APART>(dpt, sV + (kr0 + gr) * LD + tc, sOh, sOl, gr, tc);

    // P^T = exp(scale s - lse), then dS^T = P^T (dP^T - delta), each
    // operation rounded on its own (no contraction), as the twin rounds
    // them.  A dead q row has lse = -inf and no valid key, so its exp is
    // never taken; a full tile has no dead row.  dS^T also goes to shared
    // memory as dS (q rows by keys), for dK and K5's dQ.
#pragma unroll
    for (int t = 0; t < NQ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = t * 8 + 2 * tc + (e & 1), key = kr0 + gr + 8 * (e >> 1);
        const bool ok = kind == 2 || valid(g, i * B_BQ + qc, j * B_BK + key);
        const float p =
            ok ? expf(__fsub_rn(__fmul_rn(st[t][e], g.scale), sLse[qc])) : 0.f;
        st[t][e] = p;
        dpt[t][e] = p * (dpt[t][e] - sDelta[qc]);
        sDS[qc * LDS + key] = dpt[t][e];
      }

    // dV += P^T.dO, P^T from the accumulators; then dK += dS^T.Q, dS^T
    // read back from this warp's own keys of dS (so its registers are free
    // during dV's product), k = tc and tc + 4 as q rows 2 tc, 2 tc + 1.
    {
      uint32_t ah[NQ][4], al[NQ][4];
      accs_as_a(st, ah, al);
      tile_product<ND, NQ, LD>(dva, ah, al, sOh, sOl, gr, tc);
    }
    __syncwarp();  // this warp's dS rows are stored
    {
      uint32_t ah[NQ][4], al[NQ][4];
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const float* p = sDS + (kk * 8 + 2 * tc) * LDS + kr0 + gr;
        const float x[4] = {p[0], p[8], p[LDS], p[LDS + 8]};
        split4(x, ah[kk], al[kk]);
      }
      tile_product<ND, NQ, LD>(dka, ah, al, sQh, sQl, gr, tc);
    }
    if (dqp != nullptr) {
      __syncthreads();  // dS is whole

      // This pair's dQ = dS.K (unscaled): this warp's 16 q rows by NDQ
      // n-tiles over all B_BK keys; K split as it is loaded.
      const int mt = warp & 1, dq_nt0 = (warp >> 1) * NDQ;  // this warp's dQ rows, columns
      float dqa[NDQ][4], dqa_lo[APART ? NDQ : 1][4];
      zero(dqa);
      zero(dqa_lo);
#pragma unroll 1
      for (int kk = 0; kk < B_BK / 8; ++kk) {
        uint32_t ah[4], al[4];
        a_frag(sDS + (mt * 16 + gr) * LDS + kk * 8 + tc, LDS, ah, al);
#pragma unroll
        for (int x = 0; x < NDQ; ++x) {
          const float* kb = sK + (kk * 8 + tc) * LDK + (dq_nt0 + x) * 8 + gr;
          uint32_t bh[2], bl[2];
          split(kb[0], bh[0], bl[0]);
          split(kb[4 * LDK], bh[1], bl[1]);
          if constexpr (APART)
            mma_3x(dqa[x], dqa_lo[x], ah, al, bh, bl);
          else
            mma_3x(dqa[x], ah, al, bh, bl);
        }
      }
      if constexpr (APART) add_apart(dqa, dqa, dqa_lo);
      float* dqp_j = dqp + ((size_t)j * g.n + n) * g.lq * g.d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i * B_BQ + mt * 16 + gr + 8 * h;
        if (row >= g.lq) continue;
#pragma unroll
        for (int x = 0; x < NDQ; ++x) {
          const int col = (dq_nt0 + x) * 8 + 2 * tc;
          if (col < g.d)
            *reinterpret_cast<float2*>(dqp_j + (size_t)row * g.d + col) =
                make_float2(dqa[x][2 * h], dqa[x][2 * h + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = j * B_BK + kr0 + gr + 8 * h;
    if (row >= g.lk) continue;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int col = t * 8 + 2 * tc;
      if (col >= g.d) continue;
      const size_t at = ((size_t)n * g.lk + row) * g.d + col;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(g.scale * dka[t][2 * h], g.scale * dka[t][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[t][2 * h], dva[t][2 * h + 1]);
    }
  }
}

template <int DM>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dqp,
                   Geo g) {
  bwd_kv_tf32_body<DM>(q, k, v, dout, lse, delta, dk, dv, dqp, g);
}

// ---------------------------------------------------------------------------
// K6: two kernels, dK and dV with key tiles outer, dQ with q tiles outer
// ---------------------------------------------------------------------------

// dqp is null: the sweep without the dQ work.
template <int DM>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dqp, Geo g) {
  bwd_kv_tf32_body<DM>(q, k, v, dout, lse, delta, dk, dv, dqp, g);
}

template <int DM>
struct DqSmem {
  static constexpr int LD = DM + 4;
  // Keys a tile: 64, but 32 at D 128, where 64 would pass the block's
  // shared memory (Q and dO 135 KB, K and V split 135 KB).
  static constexpr int BK = DM <= 64 ? 64 : 32;
  // Q and dO as loaded (D_BQ rows), K and V split (BK rows, hi and lo each).
  static constexpr size_t BYTES = (2 * (size_t)D_BQ * LD + 4 * (size_t)BK * LD) * sizeof(float);
};

template <int DM>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, Geo g) {
  using S = DqSmem<DM>;
  constexpr int LD = S::LD, BK = S::BK, ND = DM / 8, NK = BK / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + D_BQ * LD;  // dO
  float* sKh = sO + D_BQ * LD;
  float* sKl = sKh + BK * LD;
  float* sVh = sKl + BK * LD;
  float* sVl = sVh + BK * LD;

  const int n_tiles = (g.lq + D_BQ - 1) / D_BQ;
  const int i = n_tiles - 1 - (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int r0 = warp * 16;               // this warp's local q rows
  const int row_lo = i * D_BQ + r0 + gr;  // this thread's rows: row_lo, row_lo + 8
  const size_t qbase = (size_t)n * g.lq * g.d, kbase = (size_t)n * g.lk * g.d;
  int j_lo, j_hi;
  live_range<D_BQ, BK, false>(g, i, (g.lk + BK - 1) / BK, j_lo, j_hi);

  load_tile<D_BQ, DM, LD>(sQ, nullptr, q + qbase, i * D_BQ, g.lq, g.d);
  load_tile<D_BQ, DM, LD>(sO, nullptr, dout + qbase, i * D_BQ, g.lq, g.d);
  // This thread's rows' lse and delta: 0 past Lq, where Q and dO are zeros.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    row_lse[h] = row < g.lq ? lse[(size_t)n * g.lq + row] : 0.f;
    row_delta[h] = row < g.lq ? delta[(size_t)n * g.lq + row] : 0.f;
  }
  float dqa[ND][4];
  zero(dqa);

  for (int j = j_lo; j < j_hi; ++j) {
    const int kind = triage<D_BQ, BK>(g, i, j);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<BK, DM, LD>(sKh, sKl, k + kbase, j * BK, g.lk, g.d);
    load_tile<BK, DM, LD>(sVh, sVl, v + kbase, j * BK, g.lk, g.d);
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T, this warp's 16 q rows by the tile's keys:
    // A (Q, dO) by rows, B (K, V) by rows as their transposes' columns.
    float s[NK][4], dp[NK][4];
    product_nt<DM, LD, NK, true>(s, sQ + (r0 + gr) * LD + tc, sKh, sKl, gr, tc);
    product_nt<DM, LD, NK, true>(dp, sO + (r0 + gr) * LD + tc, sVh, sVl, gr, tc);

    // P = exp(scale s - lse) and dS = P (dP - delta), rounded as K5 and
    // the twin round them; dS in dp's registers.
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok =
            kind == 2 || valid(g, row_lo + 8 * h, j * BK + t * 8 + 2 * tc + (e & 1));
        const float p =
            ok ? expf(__fsub_rn(__fmul_rn(s[t][e], g.scale), row_lse[h])) : 0.f;
        dp[t][e] = p * (dp[t][e] - row_delta[h]);
      }

    // dQ += dS.K: dS from the accumulators, K's rows 2 tc and 2 tc + 1 of
    // each 8-key step; each 8 columns' product over the tile in a fresh
    // accumulator, added in float32.
    uint32_t ah[NK][4], al[NK][4];
    accs_as_a(dp, ah, al);
    tile_product<ND, NK, LD>(dqa, ah, al, sKh, sKl, gr, tc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= g.lq) continue;
    float* out = dq + qbase + (size_t)row * g.d;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int col = t * 8 + 2 * tc;
      if (col < g.d)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(g.scale * dqa[t][2 * h], g.scale * dqa[t][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename K>
int launch(K kernel, size_t smem, long long blocks, cudaStream_t stream, void** args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel((const void*)kernel, dim3((unsigned)blocks), dim3(NT), args, smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Calls f(integral_constant<DM>) for the padded head width of the call.
template <typename F>
int by_width(int d, F&& f) {
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// Each entry point takes float32 q, k, v (do) whose addresses are
// multiples of 16 bytes, launches on `stream` and returns
// cudaGetLastError() after its launches (0 on success); it allocates
// nothing.

// K4.  partial = 0: o and, when lse is not null, lse.  partial = 1: acc
// (like q), m and l.
extern "C" int mpit_fa_fwd_tf32(const float* q, const float* k, const float* v, float* o,
                                float* lse, float* acc, float* m, float* l, int n, int lq,
                                int lk, int d, int q_offset, int kv_offset, float scale,
                                int causal, int partial, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g) || misaligned(q) || misaligned(k) || misaligned(v))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lq + F_BQ - 1) / F_BQ) * n;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    const size_t smem = FwdSmem<DM>::BYTES;
    void* args[] = {&q, &k, &v, &o, &lse, &acc, &m, &l, &g};
    return partial ? launch(fa_fwd_tf32_kernel<DM, true>, smem, blocks, s, args)
                   : launch(fa_fwd_tf32_kernel<DM, false>, smem, blocks, s, args);
  });
}

// The key tile of K5 here: dqp holds ceil(lk / 128) slots.
extern "C" int mpit_fa_bwd_tf32_block_k() { return B_BK; }

// K5: dk, dv and dq.  dqp is the scratch of the dQ partials (float32,
// (ceil(lk / 128), n, lq, d)): the sweep writes the live pairs' slots, a
// second launch sums them into dq.
extern "C" int mpit_fa_bwd_fused_tf32(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* delta,
                                      float* dq, float* dk, float* dv, float* dqp, int n,
                                      int lq, int lk, int d, int q_offset, int kv_offset,
                                      float scale, int causal, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g) || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lk + B_BK - 1) / B_BK) * n;
  const int err = by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &dqp, &g};
    return launch(fa_bwd_tf32_kernel<DM>, BwdSmem<DM>::BYTES, blocks, s, args);
  });
  if (err != 0) return err;
  return launch_dq_reduce<float, B_BQ, B_BK>(dqp, dq, g, s);
}

// K6, first kernel: dq, q tiles outer.
extern "C" int mpit_fa_bwd_dq_tf32(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dq, int n, int lq, int lk, int d, int q_offset,
                                   int kv_offset, float scale, int causal, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g) || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lq + D_BQ - 1) / D_BQ) * n;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dq, &g};
    return launch(fa_bwd_dq_tf32_kernel<DM>, DqSmem<DM>::BYTES, blocks, s, args);
  });
}

// K6, second kernel: dk and dv, K5's sweep without its dQ.
extern "C" int mpit_fa_bwd_dkdv_tf32(const float* q, const float* k, const float* v,
                                     const float* dout, const float* lse, const float* delta,
                                     float* dk, float* dv, int n, int lq, int lk, int d,
                                     int q_offset, int kv_offset, float scale, int causal,
                                     void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g) || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lk + B_BK - 1) / B_BK) * n;
  float* no_dqp = nullptr;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &no_dqp, &g};
    return launch(fa_bwd_dkdv_tf32_kernel<DM>, BwdSmem<DM>::BYTES, blocks, s, args);
  });
}
