// K4, K5 and K6 for bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces, for bfloat16 inputs, the Pallas kernels of
// mpit_tpu/ops/flash_attention.py:
//   K4  `_fa_kernel` (:233; `_fa_2d`, both output modes)  -> fa_fwd_tc_kernel
//   K5  `_fa_bwd_fused_kernel` (:623; `_fa_2d_bwd(fused=True)`)
//                                                          -> fa_bwd_tc_kernel
//                                                             + dq_reduce_kernel
//   K6  `_fa_bwd_dq_kernel` (:536) and `_fa_bwd_dkdv_kernel` (:576;
//       `_fa_2d_bwd(fused=False)`, with `_bwd_p_ds` :499)
//                                                          -> fa_bwd_dq_tc_kernel
//                                                             + fa_bwd_dkdv_tc_kernel
// float32 inputs go to flash_attention_tf32.cu (3xTF32: one TF32 pass
// misses the reference's float32 tolerances).  The contract is the
// float32 kernels' (the validity rule, `triage` in
// flash_common.cuh, the -1e30 sentinel and -inf in the public m and lse,
// P and dS rounded to bfloat16 before their products, every product
// accumulated in float32), and both backward schedules give the same bits
// every run, with no atomics; K6 needs no transient beyond dq, dk and dv.
//
// Bound on this card, at the LM's shapes (causal, N heads, L, D):
//   lm_longcontext (N 8, L 8,192, D 128): the forward does 4 D flops per
//   valid pair, 137 GFLOP (0.139 ms at 989 TFLOP/s), and moves 67 MB
//   (0.020 ms); the backward 10 D flops, 344 GFLOP (0.347 ms).  K5's dQ
//   partials add bytes of their own: one float32 (q tile, D) block per live
//   (q tile, key tile) pair, written once and read once by the reduction,
//   1.1 GB each way (0.65 ms at 3.35 TB/s) with 128-key tiles.
//   lm_default (N 64, L 1,024, D 32): 4.3 and 10.7 GFLOP, 17 and 27 MB;
//   the bytes bound the forward (5.1 us); the partials move 75 MB.
//   lm_longcontext_32k (N 8, L 32,768, D 128): the backward 5.5 TFLOP
//   (5.56 ms), where K5's partials would take 32 GiB: K6's ground.  K6
//   does 14 D flops a valid pair, not 10: both its kernels recompute S and
//   dP.
// So the products must run on the tensor cores, and the partials must be
// few.
//
// Design: one thread of a block issues every copy by TMA, from 3-D
// tensor maps over the contiguous (N, L, D) arrays built on the host per
// call: a box never reaches another head, rows past L and columns past d
// arrive as zeros (which pads D to 32, 64 or 128), and the tiles land in
// shared memory in bf16, swizzled (128 B, or 64 B at D 32) as the wgmma
// descriptors read them; the copy's bytes complete an mbarrier the
// consumers wait on.  Two warpgroups run wgmma.mma_async (m64nNk16, bf16
// in, f32 accumulate).  Under the causal mask the live tiles of a row of
// tiles form one contiguous range, computed alike by every thread from
// `triage`: dead tiles are never loaded, and only edge tiles mask element
// by element.
// - K4: a block owns 128 q rows of one head, 64 a consumer warpgroup,
//   beside a producer warpgroup whose one thread issues the copies and
//   whose registers the consumers take (setmaxnreg: 240 and 24 a
//   thread); mbarriers carry each stage back to it (each consumer warp
//   arrives when its products are done).  Q is loaded once; 128-key tiles
//   of K and V stream through two stages.  S = Q.K^T reads both from
//   shared memory; the online softmax works on the accumulator in
//   registers (a row lies in the four threads of a quad: two shuffles);
//   P is rounded to bf16 and repacked in registers as the A
//   operand of O += P.V (the accumulator layout of two n8 tiles is the A
//   layout of one k16 step), never touching shared memory; V is the B
//   operand as stored, MN-major (the transpose bit), with no transpose
//   pass.  Blocks run heaviest first (the last q tiles).
// - K5: a block owns 128 keys of one head, 64 a warpgroup, with their dK
//   and dV accumulators in registers across the sweep over the live
//   64-row q tiles, and no producer warpgroup: beside it ptxas found too
//   few registers to keep K5's products asynchronous at D 128 (its note
//   C7512: 3.4 ms at N 8, L 8,192 against 1.4 ms without it).
//   Warp 0 feeds the pipeline: K and V once, then each q tile's Q and dO
//   into one of two stages (refilled after the block's barrier on the
//   tile that used it), with the tile's lse and delta rows, which its
//   lanes load a tile ahead.  With the keys as the product's M, S^T =
//   K.Q^T and dP^T = V.dO^T come out keyed by row in registers, so P^T
//   and dS^T are rounded and repacked there as the A operands of dV +=
//   P^T.dO and dK += dS^T.Q (dO and Q MN-major).  dS^T goes through shared
//   memory once, in bf16 and swizzled by hand (two buffers, so one
//   barrier a tile suffices), for this pair's dQ = dS.K over all 128
//   keys, each warpgroup half of the head width (A and B MN-major), which
//   the block writes as one float32 partial into the slot of its key
//   tile.  Dead pairs write nothing.  dq_reduce_kernel then sums, for each
//   q tile, only its live key tiles' slots in ascending order: the same
//   bits every run, no atomics.
// - K6's dK/dV kernel is K5's sweep (one body, `bwd_kv_tc_body`, on a
//   WITH_DQ flag) without dS^T in shared memory, the dQ product and the
//   partials.
// - K6's dQ kernel takes K4's shape: a block owns 128 q rows of one head,
//   64 a warpgroup, with its Q and dO loaded once and the rows' lse and
//   delta in registers; K and V tiles stream through two stages over the
//   live key range, the heaviest blocks first.  As in K5, no producer
//   warpgroup: thread 0 issues the copies and the block's barrier on a
//   tile frees its stage, so each thread may hold 255 registers.  Per
//   tile, S = Q.K^T and dP = dO.V^T (both K-major from shared memory);
//   P and dS are formed on the accumulators in registers (no online
//   softmax: lse is given), dS is rounded and repacked as the A operand of
//   dQ += dS.K, K the B operand read MN-major.  The tile is 64 keys at D
//   128 (S and dP 32 floats a thread each, dQ 64), 128 keys below.  Each
//   dQ row is one thread's sum over the key tiles in order: the same bits
//   every run.
#include "flash_common.cuh"

#include <cuda.h>  // CUtensorMap and its enums

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

template <int V>
using int_ = std::integral_constant<int, V>;

// K4: two consumer warpgroups and one producer warpgroup, of which one
// thread issues the copies.  K5 and K6: two warpgroups, whose first warp
// also issues the copies (a third warpgroup would leave ptxas too few
// registers to keep K5's products asynchronous at D 128).
constexpr int CONSUMERS = 256, CONSUMER_WARPS = 8, F_NT = CONSUMERS + 128, B_NT = 256;
// K4: 128 q rows a block (64 a warpgroup), 128-key tiles in two stages.
constexpr int F_BQ = 128, F_BK = 128, F_STAGES = 2;
// K5 and K6's dK/dV kernel: 128 keys a block (64 a warpgroup), 64-row q
// tiles in two stages.
constexpr int B_BK = 128, B_BQ = 64, B_STAGES = 2;
// K6's dQ kernel: 128 q rows a block (64 a warpgroup), key tiles in two
// stages (DqTiles).
constexpr int D_BQ = 128, D_STAGES = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous machinery: mbarriers, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialized barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The producer's arrival, announcing the bytes its copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity (phase c,
// counted from 0, has parity c & 1).  A phase that never completes (a copy
// that cannot land) traps after some 2^28 polls, seconds at the least,
// rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) asm volatile("trap;");
  }
}

// One TMA box of a 3-D tensor map, at coordinates (column, row, head), into
// shared memory; its bytes complete the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, and the swizzle (1: 128 B, 2: 64 B).  K-major tiles
// (rows of the product's K contiguous) take stride = the bytes of 8 rows
// and no leading offset; MN-major tiles (V, whose rows are the product's
// K) take stride = 8 rows and leading = the bytes between two swizzle-atom
// columns of the tile.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lead, uint32_t stride,
                                              int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits for every committed group but the newest.
__device__ __forceinline__ void wg_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The producer warpgroup hands registers to the two consumer warpgroups:
// 24 + 2 x 240 a thread fill the register file, as 3 x 168 do at launch.
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// The registers a wgmma reads or writes asynchronously are pinned here, so
// that the compiler neither reads an accumulator before the wait nor
// reuses an A operand's registers while the product may still read them.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int x = 0; x < R; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) asm volatile("" : "+r"(a[x][y])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate, one overload per N
// (32, 64, 128: 16, 32, 64 accumulator floats a thread).  The accumulator
// fragment of warp w of the warpgroup is mma.sync's m16n8 layout over rows
// 16 w .. 16 w + 15, one n8 tile after another: d[4 t + e] holds row gr +
// 8 (e / 2), column 8 t + 2 tc + e % 2.  wgmma_ss reads A and B from shared
// memory (K-major both, or MN-major both); wgmma_rs takes A from registers
// in mma.sync's A layout and B MN-major.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(
    float (&d)[8], uint64_t da, uint64_t db, int scale_d, int_<1>, int_<1>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d, int_<1>, int_<1>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d, int_<0>, int_<0>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d, int_<1>, int_<1>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d, int_<0>, int_<0>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Makes this thread's ordinary writes to shared memory visible to the
// asynchronous proxy (wgmma reads its operands through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K4: forward
// ---------------------------------------------------------------------------

// The shared-memory geometry of K4 at head width DM.  A 128-row tile of
// (rows, DM) bf16 is stored as DM / CW swizzle-atom columns of (128, CW),
// each row of an atom column CW * 2 bytes (64 or 128), swizzled by TMA as
// the descriptors expect.
template <int DM>
struct FwdTiles {
  static constexpr int CW = DM < 64 ? DM : 64;   // columns of an atom row
  static constexpr int NC = DM / CW;             // atom columns of a tile
  static constexpr int ROWB = CW * 2;            // bytes of an atom row
  static constexpr int SWIZZLE = CW == 64 ? 1 : 2;
  static constexpr int ATOMS = F_BQ * ROWB;      // bytes of one atom column
  static constexpr int TILE = F_BQ * DM * 2;     // bytes of a tile (F_BK == F_BQ)
  // Q, K and V in F_STAGES stages each, the barriers; 1 KB to align the base.
  static constexpr size_t SMEM = 1024 + (size_t)(1 + 2 * F_STAGES) * TILE + 64;
};

template <int DM, bool PARTIAL>
__global__ void __launch_bounds__(F_NT, 1)
fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, Geo g) {
  using T = FwdTiles<DM>;
  constexpr int SR = F_BK / 2;  // score floats a thread: 64 rows x F_BK over 128
  constexpr int OR = DM / 2;    // output floats a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KB aligned, as the 128 B swizzle's pattern repeats every 1 KB.
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + T::TILE;
  const uint32_t sV = sK + F_STAGES * T::TILE;
  const uint32_t bars = sV + F_STAGES * T::TILE;
  // Barriers: Q full; K full, V full and stage empty for each stage.
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + F_STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * F_STAGES + st); };

  const int n_tiles = (g.lq + F_BQ - 1) / F_BQ;
  const int i = n_tiles - 1 - (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  int j_lo, j_hi;
  live_range<F_BQ, F_BK, false>(g, i, (g.lk + F_BK - 1) / F_BK, j_lo, j_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < F_STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    producer_registers();
    // The producer: one thread issues every copy, Q once, then each
    // live key tile's K and V into the next stage once the consumers have
    // released it.
    if (threadIdx.x == CONSUMERS && j_lo < j_hi) {
      mbar_expect_tx(q_full, T::TILE);
      for (int c = 0; c < T::NC; ++c)
        tma_load(sQ + c * T::ATOMS, &tq, q_full, c * T::CW, i * F_BQ, n);
      for (int j = j_lo; j < j_hi; ++j) {
        const int it = j - j_lo, st = it % F_STAGES;
        if (it >= F_STAGES) mbar_wait(empty(st), (it / F_STAGES - 1) & 1);
        mbar_expect_tx(k_full(st), T::TILE);
        for (int c = 0; c < T::NC; ++c)
          tma_load(sK + st * T::TILE + c * T::ATOMS, &tk, k_full(st), c * T::CW, j * F_BK, n);
        mbar_expect_tx(v_full(st), T::TILE);
        for (int c = 0; c < T::NC; ++c)
          tma_load(sV + st * T::TILE + c * T::ATOMS, &tv, v_full(st), c * T::CW, j * F_BK, n);
      }
    }
  } else {
    consumer_registers();
    // Two consumer warpgroups, 64 q rows each.
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tc = lane & 3;
    const int row_lo = i * F_BQ + wg * 64 + warp * 16 + gr;  // and row_lo + 8
    const uint32_t q_rows = sQ + wg * 64 * T::ROWB;           // this warpgroup's Q rows

    float oacc[OR];
#pragma unroll
    for (int x = 0; x < OR; ++x) oacc[x] = 0.f;
    float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};
    if (j_lo < j_hi) mbar_wait(q_full, 0);

    for (int j = j_lo; j < j_hi; ++j) {
      const int it = j - j_lo, st = it % F_STAGES;
      const uint32_t parity = (it / F_STAGES) & 1;
      const uint32_t kt = sK + st * T::TILE, vt = sV + st * T::TILE;
      // S = Q.K^T: A (Q) and B (K) K-major in shared memory, 16 columns of
      // the head width a step.
      float s[SR];
#pragma unroll
      for (int x = 0; x < SR; ++x) s[x] = 0.f;
      mbar_wait(k_full(st), parity);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < DM / 16; ++kc) {
        const uint32_t at = (kc * 16 / T::CW) * T::ATOMS + (kc * 16 % T::CW) * 2;
        wgmma_ss(s, gmma_desc(q_rows + at, 16, 8 * T::ROWB, T::SWIZZLE),
                 gmma_desc(kt + at, 16, 8 * T::ROWB, T::SWIZZLE), 1, int_<0>{}, int_<0>{});
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);

      // The online softmax, on the accumulator in registers.  A masked score
      // is -inf; m starts at the finite sentinel, so exp(s - m) is 0 there
      // and never NaN.
      const int kind = triage<F_BQ, F_BK>(g, i, j);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < F_BK / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = __fmul_rn(s[4 * t + e], g.scale);  // rounded alone, as the twin does
          if (kind == 1 && !valid(g, row_lo + 8 * h, j * F_BK + t * 8 + 2 * tc + (e & 1)))
            x = -INFINITY;
          s[4 * t + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < SR; ++x) {
        const float p = expf(s[x] - m[(x >> 1) & 1]);
        s[x] = p;
        rs[(x >> 1) & 1] += p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = alpha[h] * l[h] + rs[h];
      }
#pragma unroll
      for (int x = 0; x < OR; ++x) oacc[x] *= alpha[(x >> 1) & 1];
      // P rounded to bf16 in registers: the accumulator layout of two n8
      // tiles is the A layout of one k16 step, so P never touches shared
      // memory.
      uint32_t pa[F_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < F_BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P.V: V, whose rows are this product's K, is B in MN-major form.
      mbar_wait(v_full(st), parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < F_BK / 16; ++kk)
        wgmma_rs(oacc, pa[kk],
                 gmma_desc(vt + kk * 16 * T::ROWB, T::ATOMS, 8 * T::ROWB, T::SWIZZLE), 1);
      wg_commit();
      wg_wait_all();
      reg_fence(oacc);
      reg_fence(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
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
        for (int t = 0; t < DM / 8; ++t) {
          const int col = t * 8 + 2 * tc;
          if (col < g.d)
            *reinterpret_cast<float2*>(acc_out + ro + col) =
                make_float2(oacc[4 * t + 2 * h], oacc[4 * t + 2 * h + 1]);
        }
        if (tc == 0) {
          m_out[so] = m_pub;
          l_out[so] = l[h];
        }
      } else {
        const float den = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
        for (int t = 0; t < DM / 8; ++t) {
          const int col = t * 8 + 2 * tc;
          if (col < g.d)
            *reinterpret_cast<__nv_bfloat162*>(o + ro + col) = __floats2bfloat162_rn(
                oacc[4 * t + 2 * h] / den, oacc[4 * t + 2 * h + 1] / den);
        }
        if (lse != nullptr && tc == 0) lse[so] = m_pub + logf(den);
      }
    }
  }

}

// ---------------------------------------------------------------------------
// K5: fused backward, key tiles outer
// ---------------------------------------------------------------------------

// The shared-memory geometry of K5 and K6's dK/dV kernel at head width DM:
// the block's K and V (B_BK rows, resident), Q and dO (B_BQ rows) and their
// lse and delta rows in B_STAGES stages, and for K5 dS^T (B_BK keys by B_BQ
// q, one 128 B atom row a key) twice, all 1 KB aligned.
template <int DM>
struct BwdTiles {
  static constexpr int CW = DM < 64 ? DM : 64;   // columns of an atom row
  static constexpr int NC = DM / CW;             // atom columns of a tile
  static constexpr int ROWB = CW * 2;            // bytes of an atom row
  static constexpr int SWIZZLE = CW == 64 ? 1 : 2;
  static constexpr int ATOMS_K = B_BK * ROWB;    // bytes of an atom column of K, V
  static constexpr int ATOMS_Q = B_BQ * ROWB;    // ... of Q, dO
  static constexpr int TILE_K = B_BK * DM * 2;
  static constexpr int TILE_Q = B_BQ * DM * 2;
  static constexpr int STAGE = 2 * TILE_Q + 1024;  // Q, dO, then lse and delta
  static constexpr int DS = B_BK * B_BQ * 2;
  static constexpr size_t smem(bool with_dq) {
    return 1024 + (size_t)2 * TILE_K + (size_t)B_STAGES * STAGE + (with_dq ? 2 * DS : 0) + 64;
  }
};

// The sweep of one key tile over its live q tiles, dK and dV in registers;
// WITH_DQ (K5) also writes each live pair's dQ partial into dqp.
template <int DM, bool WITH_DQ>
__device__ __forceinline__ void bwd_kv_tc_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv, const CUtensorMap& tdo,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                                               float* __restrict__ dqp, const Geo& g) {
  using T = BwdTiles<DM>;
  constexpr int KR = DM / 2;     // dK (and dV) floats a thread: 64 keys x DM
  constexpr int QN = DM / 2;     // dQ columns a warpgroup computes
  constexpr int QR = QN / 2;     // dQ floats a thread: B_BQ rows x QN
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T::TILE_K;
  const uint32_t stages = sV + T::TILE_K;  // each: Q, dO, lse, delta
  const uint32_t sDS = stages + B_STAGES * T::STAGE;  // two buffers (K5)
  const uint32_t bars = sDS + (WITH_DQ ? 2 * T::DS : 0);
  auto q_of = [&](int st) { return stages + st * T::STAGE; };
  auto do_of = [&](int st) { return stages + st * T::STAGE + T::TILE_Q; };
  auto lse_of = [&](int st) { return stages + st * T::STAGE + 2 * T::TILE_Q; };
  auto delta_of = [&](int st) { return stages + st * T::STAGE + 2 * T::TILE_Q + 512; };
  // Barriers: K and V full, and each stage full (its copies' bytes and
  // the 32 lanes of warp 0, which store its lse and delta rows).
  const uint32_t kv_full = bars;
  auto qd_full = [&](int st) { return bars + 8 * (1 + st); };

  const int j = (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  int i_lo, i_hi;
  live_range<B_BQ, B_BK, true>(g, j, (g.lq + B_BQ - 1) / B_BQ, i_lo, i_hi);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < B_STAGES; ++st) mbar_init(qd_full(st), 1 + 32);
    mbar_init_fence();
  }
  __syncthreads();

  // Two warpgroups, 64 keys each.
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int key_lo = wg * 64 + warp * 16 + gr;  // this thread's local keys: key_lo, key_lo + 8
  float* dqp_j = WITH_DQ ? dqp + ((size_t)j * g.n + n) * g.lq * g.d : nullptr;
  const int q_col0 = wg * QN;  // this warpgroup's dQ columns: q_col0 .. (K5)

  // Warp 0 also feeds the pipeline: its lane 0 issues the copies by TMA,
  // and its lanes store each q tile's lse and delta rows, two a lane, 0
  // past Lq where the Q and dO rows arrive as zeros (lse rows start at no
  // 16-byte boundary in general, which TMA needs).  A stage is refilled
  // after the block's barrier on the tile that used it; the rows are
  // loaded into registers a tile ahead, so their latency hides.
  const bool feeder = threadIdx.x < 32;
  const float* lse_n = lse + (size_t)n * g.lq;
  const float* delta_n = delta + (size_t)n * g.lq;
  float next_lse[B_BQ / 32], next_delta[B_BQ / 32];
  auto load_rows = [&](int i) {
#pragma unroll
    for (int r = 0; r < B_BQ / 32; ++r) {
      const int row = i * B_BQ + lane + 32 * r;
      next_lse[r] = row < g.lq ? lse_n[row] : 0.f;
      next_delta[r] = row < g.lq ? delta_n[row] : 0.f;
    }
  };
  auto feed = [&](int i, int st) {
    if (lane == 0) {
      mbar_expect_tx(qd_full(st), 2 * T::TILE_Q);
      for (int c = 0; c < T::NC; ++c) {
        tma_load(q_of(st) + c * T::ATOMS_Q, &tq, qd_full(st), c * T::CW, i * B_BQ, n);
        tma_load(do_of(st) + c * T::ATOMS_Q, &tdo, qd_full(st), c * T::CW, i * B_BQ, n);
      }
    }
#pragma unroll
    for (int r = 0; r < B_BQ / 32; ++r) {
      st_shared_f32(lse_of(st) + 4 * (lane + 32 * r), next_lse[r]);
      st_shared_f32(delta_of(st) + 4 * (lane + 32 * r), next_delta[r]);
    }
    mbar_arrive(qd_full(st));  // this lane's rows are stored
  };
  if (feeder && i_lo < i_hi) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * T::TILE_K);
      for (int c = 0; c < T::NC; ++c) {
        tma_load(sK + c * T::ATOMS_K, &tk, kv_full, c * T::CW, j * B_BK, n);
        tma_load(sV + c * T::ATOMS_K, &tv, kv_full, c * T::CW, j * B_BK, n);
      }
    }
    for (int f = 0; f < B_STAGES && i_lo + f < i_hi; ++f) {
      load_rows(i_lo + f);
      feed(i_lo + f, f);
    }
  }

  float dka[KR], dva[KR];
#pragma unroll
  for (int x = 0; x < KR; ++x) dka[x] = dva[x] = 0.f;
  if (i_lo < i_hi) mbar_wait(kv_full, 0);

  for (int i = i_lo; i < i_hi; ++i) {
    const int it = i - i_lo, st = it % B_STAGES;
    const bool refill = feeder && i + B_STAGES < i_hi;
    if (refill) load_rows(i + B_STAGES);
    const uint32_t qt = q_of(st), dot = do_of(st);
    const uint32_t ds = sDS + (it & 1) * T::DS;
    // This warpgroup's K and V rows, and the columns of K its dQ takes.
    const uint32_t k_rows = sK + wg * 64 * T::ROWB, v_rows = sV + wg * 64 * T::ROWB;
    const uint32_t k_cols = sK + (q_col0 / T::CW) * T::ATOMS_K + (q_col0 % T::CW) * 2;
    // S^T = K.Q^T, then dP^T = V.dO^T, this warpgroup's 64 keys by B_BQ q
    // rows, A (K, V) and B (Q, dO) K-major in shared memory, in two groups,
    // so that P is taken while dP^T is still in the tensor cores.
    const int kind = triage<B_BQ, B_BK>(g, i, j);
    mbar_wait(qd_full(st), (it / B_STAGES) & 1);
    float sT[B_BQ / 2], dpT[B_BQ / 2];
#pragma unroll
    for (int x = 0; x < B_BQ / 2; ++x) sT[x] = dpT[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < DM / 16; ++kc) {
      const uint32_t at = (kc * 16 / T::CW) * T::ATOMS_K + (kc * 16 % T::CW) * 2;
      const uint32_t aq = (kc * 16 / T::CW) * T::ATOMS_Q + (kc * 16 % T::CW) * 2;
      wgmma_ss(sT, gmma_desc(k_rows + at, 16, 8 * T::ROWB, T::SWIZZLE),
               gmma_desc(qt + aq, 16, 8 * T::ROWB, T::SWIZZLE), 1, int_<0>{},
               int_<0>{});
    }
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < DM / 16; ++kc) {
      const uint32_t at = (kc * 16 / T::CW) * T::ATOMS_K + (kc * 16 % T::CW) * 2;
      const uint32_t aq = (kc * 16 / T::CW) * T::ATOMS_Q + (kc * 16 % T::CW) * 2;
      wgmma_ss(dpT, gmma_desc(v_rows + at, 16, 8 * T::ROWB, T::SWIZZLE),
               gmma_desc(dot + aq, 16, 8 * T::ROWB, T::SWIZZLE), 1, int_<0>{},
               int_<0>{});
    }
    wg_commit();

    // P^T = exp(scale s - lse), then dS^T = P^T (dP^T - delta), each
    // operation rounded on its own (no contraction), as the twin rounds
    // them.  A dead q row has lse = -inf and no valid key, so its exp
    // is never taken; a full tile has no dead row.  Rows past Lq have
    // lse = delta = 0 and meet zero Q and dO rows.
    wg_wait_all_but_one();
    reg_fence(sT);
#pragma unroll
    for (int t = 0; t < B_BQ / 8; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = t * 8 + 2 * tc + c, row = i * B_BQ + qc;
        const float lse_r = ld_shared_f32(lse_of(st) + 4 * qc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * t + 2 * h + c;
          const bool ok = kind == 2 || valid(g, row, j * B_BK + key_lo + 8 * h);
          sT[x] = ok ? expf(__fsub_rn(__fmul_rn(sT[x], g.scale), lse_r)) : 0.f;
        }
      }
    wg_wait_all();
    reg_fence(dpT);
    // P^T and dS^T rounded to bf16 in registers, as A operands, pair by
    // pair as dS^T is formed; for K5 dS^T also to shared memory, swizzled
    // as a 128 B atom (a key's 64 q values are one row), for this pair's
    // dQ.
    uint32_t pa[B_BQ / 16][4], da[B_BQ / 16][4];
#pragma unroll
    for (int kp = 0; kp < B_BQ / 16; ++kp)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kp + 2 * r;  // the pair (x, x + 1): one key, two q
        const int key = key_lo + 8 * (r & 1);
        const int qc = 16 * kp + 8 * (r >> 1) + 2 * tc;
        const float d0 = ld_shared_f32(delta_of(st) + 4 * qc);
        const float d1 = ld_shared_f32(delta_of(st) + 4 * qc + 4);
        pa[kp][r] = pack_bf16(sT[x], sT[x + 1]);
        da[kp][r] = pack_bf16(sT[x] * (dpT[x] - d0), sT[x + 1] * (dpT[x + 1] - d1));
        if (WITH_DQ)
          st_shared_u32(ds + key * 128 + (((qc >> 3) ^ (key & 7)) << 4) + (qc & 7) * 2,
                        da[kp][r]);
      }
    // dV += P^T.dO and dK += dS^T.Q: B (dO, Q) MN-major, 16 q rows a
    // step.
    wg_fence();
#pragma unroll
    for (int kp = 0; kp < B_BQ / 16; ++kp)
      wgmma_rs(dva, pa[kp],
               gmma_desc(dot + kp * 16 * T::ROWB, T::ATOMS_Q, 8 * T::ROWB,
                         T::SWIZZLE),
               1);
#pragma unroll
    for (int kp = 0; kp < B_BQ / 16; ++kp)
      wgmma_rs(dka, da[kp],
               gmma_desc(qt + kp * 16 * T::ROWB, T::ATOMS_Q, 8 * T::ROWB,
                         T::SWIZZLE),
               1);
    wg_commit();
    wg_wait_all();
    reg_fence(dva);
    reg_fence(dka);
    reg_fence(pa);
    reg_fence(da);
    // Every key's dS^T is in shared memory, visible to wgmma, and every
    // warp is done with this tile's stage, which warp 0 refills.  (The two
    // dS^T buffers alternate: a warpgroup writes one only after both have
    // passed this barrier on the tile before, whose products read the
    // other.)
    if (WITH_DQ) fence_proxy_async();
    __syncthreads();
    if (refill) feed(i + B_STAGES, st);
    if (!WITH_DQ) continue;
    // This pair's dQ = dS.K (unscaled), B_BQ rows by this warpgroup's QN
    // columns over all B_BK keys: A (dS, from dS^T) and B (K) MN-major.
    float dqa[QR];
#pragma unroll
    for (int x = 0; x < QR; ++x) dqa[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < B_BK / 16; ++kk)
      wgmma_ss(dqa, gmma_desc(ds + kk * 16 * 128, 16, 1024, 1),
               gmma_desc(k_cols + kk * 16 * T::ROWB, T::ATOMS_K, 8 * T::ROWB,
                         T::SWIZZLE),
               1, int_<1>{}, int_<1>{});
    wg_commit();
    wg_wait_all();
    reg_fence(dqa);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i * B_BQ + warp * 16 + gr + 8 * h;
      if (row >= g.lq) continue;
#pragma unroll
      for (int t = 0; t < QN / 8; ++t) {
        const int col = q_col0 + t * 8 + 2 * tc;
        if (col < g.d)
          *reinterpret_cast<float2*>(dqp_j + (size_t)row * g.d + col) =
              make_float2(dqa[4 * t + 2 * h], dqa[4 * t + 2 * h + 1]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = j * B_BK + key_lo + 8 * h;
    if (row >= g.lk) continue;
#pragma unroll
    for (int t = 0; t < DM / 8; ++t) {
      const int col = t * 8 + 2 * tc;
      if (col >= g.d) continue;
      const size_t at = ((size_t)n * g.lk + row) * g.d + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          g.scale * dka[4 * t + 2 * h], g.scale * dka[4 * t + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[4 * t + 2 * h], dva[4 * t + 2 * h + 1]);
    }
  }
}

template <int DM>
__global__ void __launch_bounds__(B_NT, 1)
fa_bwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dqp, Geo g) {
  bwd_kv_tc_body<DM, true>(tq, tk, tv, tdo, lse, delta, dk, dv, dqp, g);
}

// ---------------------------------------------------------------------------
// K6: two kernels, dK and dV with key tiles outer, dQ with q tiles outer
// ---------------------------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(B_NT, 1)
fa_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Geo g) {
  bwd_kv_tc_body<DM, false>(tq, tk, tv, tdo, lse, delta, dk, dv, nullptr, g);
}

// The shared-memory geometry of K6's dQ kernel at head width DM: the
// block's Q and dO (D_BQ rows, resident), then K and V tiles of BK keys in
// D_STAGES stages, all 1 KB aligned.  64-key tiles at D 128, so that a
// consumer thread holds S and dP (32 floats each) beside dQ (64); 128-key
// tiles below.
template <int DM>
struct DqTiles {
  static constexpr int BK = DM == 128 ? 64 : 128;  // keys a tile
  static constexpr int CW = DM < 64 ? DM : 64;     // columns of an atom row
  static constexpr int NC = DM / CW;               // atom columns of a tile
  static constexpr int ROWB = CW * 2;              // bytes of an atom row
  static constexpr int SWIZZLE = CW == 64 ? 1 : 2;
  static constexpr int ATOMS_Q = D_BQ * ROWB;      // bytes of an atom column of Q, dO
  static constexpr int ATOMS_K = BK * ROWB;        // ... of K, V
  static constexpr int TILE_Q = D_BQ * DM * 2;
  static constexpr int TILE_K = BK * DM * 2;
  static constexpr size_t SMEM =
      1024 + (size_t)2 * TILE_Q + (size_t)2 * D_STAGES * TILE_K + 64;
};

template <int DM>
__global__ void __launch_bounds__(B_NT, 1)
fa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, Geo g) {
  using T = DqTiles<DM>;
  constexpr int BK = T::BK;
  constexpr int SR = BK / 2;  // S (and dP) floats a thread: 64 rows x BK over 128
  constexpr int QR = DM / 2;  // dQ floats a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + T::TILE_Q;
  const uint32_t sK = sDO + T::TILE_Q;  // D_STAGES tiles each
  const uint32_t sV = sK + D_STAGES * T::TILE_K;
  const uint32_t bars = sV + D_STAGES * T::TILE_K;
  // Barriers: Q and dO full; K and V full for each stage.
  const uint32_t qdo_full = bars;
  auto kv_full = [&](int st) { return bars + 8 * (1 + st); };

  const int n_tiles = (g.lq + D_BQ - 1) / D_BQ;
  const int i = n_tiles - 1 - (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  int j_lo, j_hi;
  live_range<D_BQ, BK, false>(g, i, (g.lk + BK - 1) / BK, j_lo, j_hi);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int st = 0; st < D_STAGES; ++st) mbar_init(kv_full(st), 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Two warpgroups, 64 q rows each.
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int row_lo = i * D_BQ + wg * 64 + warp * 16 + gr;  // and row_lo + 8
  const uint32_t q_rows = sQ + wg * 64 * T::ROWB, do_rows = sDO + wg * 64 * T::ROWB;

  // Thread 0 issues every copy: Q and dO once, then each live key tile's K
  // and V into the next stage, refilled after the block's barrier on the
  // tile that used it.
  const bool feeder = threadIdx.x == 0;
  auto feed = [&](int j, int st) {
    mbar_expect_tx(kv_full(st), 2 * T::TILE_K);
    for (int c = 0; c < T::NC; ++c) {
      tma_load(sK + st * T::TILE_K + c * T::ATOMS_K, &tk, kv_full(st), c * T::CW, j * BK, n);
      tma_load(sV + st * T::TILE_K + c * T::ATOMS_K, &tv, kv_full(st), c * T::CW, j * BK, n);
    }
  };
  if (feeder && j_lo < j_hi) {
    mbar_expect_tx(qdo_full, 2 * T::TILE_Q);
    for (int c = 0; c < T::NC; ++c) {
      tma_load(sQ + c * T::ATOMS_Q, &tq, qdo_full, c * T::CW, i * D_BQ, n);
      tma_load(sDO + c * T::ATOMS_Q, &tdo, qdo_full, c * T::CW, i * D_BQ, n);
    }
    for (int f = 0; f < D_STAGES && j_lo + f < j_hi; ++f) feed(j_lo + f, f);
  }

  // The lse and delta of this thread's two rows; 0 past Lq, where the Q and
  // dO rows arrive as zeros.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    lse_r[h] = row < g.lq ? lse[(size_t)n * g.lq + row] : 0.f;
    delta_r[h] = row < g.lq ? delta[(size_t)n * g.lq + row] : 0.f;
  }

  float dqa[QR];
#pragma unroll
  for (int x = 0; x < QR; ++x) dqa[x] = 0.f;
  if (j_lo < j_hi) mbar_wait(qdo_full, 0);

  for (int j = j_lo; j < j_hi; ++j) {
    const int it = j - j_lo, st = it % D_STAGES;
    const uint32_t kt = sK + st * T::TILE_K, vt = sV + st * T::TILE_K;
    const int kind = triage<D_BQ, BK>(g, i, j);
    mbar_wait(kv_full(st), (it / D_STAGES) & 1);
    // S = Q.K^T, then dP = dO.V^T, this warpgroup's 64 q rows by BK keys,
    // A (Q, dO) and B (K, V) K-major in shared memory, in two groups, so
    // that P is taken while dP is still in the tensor cores.
    float s[SR], dp[SR];
#pragma unroll
    for (int x = 0; x < SR; ++x) s[x] = dp[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < DM / 16; ++kc) {
      const uint32_t aq = (kc * 16 / T::CW) * T::ATOMS_Q + (kc * 16 % T::CW) * 2;
      const uint32_t ak = (kc * 16 / T::CW) * T::ATOMS_K + (kc * 16 % T::CW) * 2;
      wgmma_ss(s, gmma_desc(q_rows + aq, 16, 8 * T::ROWB, T::SWIZZLE),
               gmma_desc(kt + ak, 16, 8 * T::ROWB, T::SWIZZLE), 1, int_<0>{}, int_<0>{});
    }
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < DM / 16; ++kc) {
      const uint32_t aq = (kc * 16 / T::CW) * T::ATOMS_Q + (kc * 16 % T::CW) * 2;
      const uint32_t ak = (kc * 16 / T::CW) * T::ATOMS_K + (kc * 16 % T::CW) * 2;
      wgmma_ss(dp, gmma_desc(do_rows + aq, 16, 8 * T::ROWB, T::SWIZZLE),
               gmma_desc(vt + ak, 16, 8 * T::ROWB, T::SWIZZLE), 1, int_<0>{}, int_<0>{});
    }
    wg_commit();

    // P = exp(scale s - lse), each operation rounded on its own, as the
    // twin rounds them.  A dead q row has lse = -inf and no valid key, so
    // its exp is never taken; a full tile has no dead row.
    wg_wait_all_but_one();
    reg_fence(s);
#pragma unroll
    for (int t = 0; t < BK / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, x = 4 * t + e;
        const bool ok =
            kind == 2 || valid(g, row_lo + 8 * h, j * BK + t * 8 + 2 * tc + (e & 1));
        s[x] = ok ? expf(__fsub_rn(__fmul_rn(s[x], g.scale), lse_r[h])) : 0.f;
      }
    wg_wait_all();
    reg_fence(dp);
    // dS = P (dP - delta), rounded to bf16 in registers as the A operand
    // of dQ += dS.K: the accumulator layout of two n8 tiles is the A
    // layout of one k16 step.
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kk + 2 * r;  // the pair (x, x + 1): one row, two keys
        const float dl = delta_r[r & 1];
        da[kk][r] = pack_bf16(s[x] * (dp[x] - dl), s[x + 1] * (dp[x + 1] - dl));
      }
    // dQ += dS.K: K, whose rows are this product's K, is B in MN-major
    // form.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(dqa, da[kk],
               gmma_desc(kt + kk * 16 * T::ROWB, T::ATOMS_K, 8 * T::ROWB, T::SWIZZLE), 1);
    wg_commit();
    wg_wait_all();
    reg_fence(dqa);
    reg_fence(da);
    // Every warp is done with this tile's stage, which thread 0 refills.
    __syncthreads();
    if (feeder && j + D_STAGES < j_hi) feed(j + D_STAGES, st);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= g.lq) continue;
    const size_t ro = ((size_t)n * g.lq + row) * g.d;
#pragma unroll
    for (int t = 0; t < DM / 8; ++t) {
      const int col = t * 8 + 2 * tc;
      if (col < g.d)
        *reinterpret_cast<__nv_bfloat162*>(dq + ro + col) = __floats2bfloat162_rn(
            g.scale * dqa[4 * t + 2 * h], g.scale * dqa[4 * t + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename K>
int launch(K kernel, size_t smem, long long blocks, int threads, cudaStream_t stream,
           void** args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel((const void*)kernel, dim3((unsigned)blocks), dim3(threads), args,
                         smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous (n, rows, d) bf16 array as TMA reads it: boxes of `box_rows`
// rows by cw columns of one head (a box never reaches another head), with
// the swizzle of cw * 2 bytes that the wgmma descriptors expect; rows past
// `rows` and columns past d arrive as zeros.  The base must lie on 16
// bytes, as the rows do (d is a multiple of 8).
int tensor_map(CUtensorMap* map, const bf16* base, int n, int rows, int d, int cw,
               int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Calls f(integral_constant<DM>) for the padded head width of the call.
template <typename F>
int by_width(int d, F&& f) {
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

}  // namespace

// Each entry point takes bfloat16 q, k, v (do, o, dq, dk, dv) whose
// addresses are multiples of 16 bytes, launches on `stream` and returns
// cudaGetLastError() after its launches (0 on success); it allocates
// nothing.

// K4.  partial = 0: o and, when lse is not null, lse.  partial = 1: acc
// (float32, like q), m and l.
extern "C" int mpit_fa_fwd_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                              float* lse, float* acc, float* m, float* l, int n, int lq,
                              int lk, int d, int q_offset, int kv_offset, float scale,
                              int causal, int partial, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lq + F_BQ - 1) / F_BQ) * n;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    using T = FwdTiles<DM>;
    CUtensorMap tq, tk, tv;
    int err = tensor_map(&tq, q, n, lq, d, T::CW, F_BQ);
    if (err == 0) err = tensor_map(&tk, k, n, lk, d, T::CW, F_BK);
    if (err == 0) err = tensor_map(&tv, v, n, lk, d, T::CW, F_BK);
    if (err != 0) return err;
    void* args[] = {&tq, &tk, &tv, &o, &lse, &acc, &m, &l, &g};
    return partial ? launch(fa_fwd_tc_kernel<DM, true>, T::SMEM, blocks, F_NT, s, args)
                   : launch(fa_fwd_tc_kernel<DM, false>, T::SMEM, blocks, F_NT, s, args);
  });
}

// The key tile of K5 here: dqp holds ceil(lk / 128) slots.
extern "C" int mpit_fa_bwd_tc_block_k() { return B_BK; }

// K5: dk, dv and dq.  dqp is the scratch of the dQ partials (float32,
// (ceil(lk / 128), n, lq, d)): the sweep writes the live pairs' slots, a
// second launch sums them into dq.
extern "C" int mpit_fa_bwd_fused_tc(const bf16* q, const bf16* k, const bf16* v,
                                    const bf16* dout, const float* lse, const float* delta,
                                    bf16* dq, bf16* dk, bf16* dv, float* dqp, int n, int lq,
                                    int lk, int d, int q_offset, int kv_offset, float scale,
                                    int causal, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lk + B_BK - 1) / B_BK) * n;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    using T = BwdTiles<DM>;
    CUtensorMap tq, tk, tv, tdo;
    int err = tensor_map(&tq, q, n, lq, d, T::CW, B_BQ);
    if (err == 0) err = tensor_map(&tk, k, n, lk, d, T::CW, B_BK);
    if (err == 0) err = tensor_map(&tv, v, n, lk, d, T::CW, B_BK);
    if (err == 0) err = tensor_map(&tdo, dout, n, lq, d, T::CW, B_BQ);
    if (err != 0) return err;
    void* args[] = {&tq, &tk, &tv, &tdo, &lse, &delta, &dk, &dv, &dqp, &g};
    err = launch(fa_bwd_tc_kernel<DM>, T::smem(true), blocks, B_NT, s, args);
    if (err != 0) return err;
    return launch_dq_reduce<bf16, B_BQ, B_BK>(dqp, dq, g, s);
  });
}

// K6, first kernel: dq, q tiles outer.
extern "C" int mpit_fa_bwd_dq_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 const float* lse, const float* delta, bf16* dq, int n, int lq,
                                 int lk, int d, int q_offset, int kv_offset, float scale,
                                 int causal, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lq + D_BQ - 1) / D_BQ) * n;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    using T = DqTiles<DM>;
    CUtensorMap tq, tk, tv, tdo;
    int err = tensor_map(&tq, q, n, lq, d, T::CW, D_BQ);
    if (err == 0) err = tensor_map(&tk, k, n, lk, d, T::CW, T::BK);
    if (err == 0) err = tensor_map(&tv, v, n, lk, d, T::CW, T::BK);
    if (err == 0) err = tensor_map(&tdo, dout, n, lq, d, T::CW, D_BQ);
    if (err != 0) return err;
    void* args[] = {&tq, &tk, &tv, &tdo, &lse, &delta, &dq, &g};
    return launch(fa_bwd_dq_tc_kernel<DM>, T::SMEM, blocks, B_NT, s, args);
  });
}

// K6, second kernel: dk and dv, key tiles outer.
extern "C" int mpit_fa_bwd_dkdv_tc(const bf16* q, const bf16* k, const bf16* v,
                                   const bf16* dout, const float* lse, const float* delta,
                                   bf16* dk, bf16* dv, int n, int lq, int lk, int d,
                                   int q_offset, int kv_offset, float scale, int causal,
                                   void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((lk + B_BK - 1) / B_BK) * n;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    using T = BwdTiles<DM>;
    CUtensorMap tq, tk, tv, tdo;
    int err = tensor_map(&tq, q, n, lq, d, T::CW, B_BQ);
    if (err == 0) err = tensor_map(&tk, k, n, lk, d, T::CW, B_BK);
    if (err == 0) err = tensor_map(&tv, v, n, lk, d, T::CW, B_BK);
    if (err == 0) err = tensor_map(&tdo, dout, n, lq, d, T::CW, B_BQ);
    if (err != 0) return err;
    void* args[] = {&tq, &tk, &tv, &tdo, &lse, &delta, &dk, &dv, &g};
    return launch(fa_bwd_dkdv_tc_kernel<DM>, T::smem(false), blocks, B_NT, s, args);
  });
}
