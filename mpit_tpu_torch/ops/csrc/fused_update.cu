// K1: fused Nesterov commit (msgd phase 2), row-batched, in place.
//
// Replaces the Pallas kernel `_nesterov_kernel` of
// mpit_tpu/ops/fused_update.py (function `fused_nesterov_commit`).  For
// every element of `n_rows` rows of `n` floats:
//
//     g'  = g + l2wd * w                  (only when l2wd != 0)
//     s   = clr[row] * g'
//     w  <- w - s   (- sug, when the EASGD retract rides along)
//     vt <- vt - s
//
// `clr` is a device array of one learning rate per row, so the decayed lr
// never crosses to the host.  `sug` may be null.
//
// Bound on Hopper: bytes.  Each element reads w, vt, g (and sug) and
// writes w and vt: 20 bytes (24 with sug) for 3-4 flops, far below the
// card's ~20 flops/byte f32 balance.  At the CNN's 544,522 parameters and
// one row that is 10.9 MB, 3.3 us at 3.35 TB/s, so at this size the launch
// itself (a few us) is as large as the work.
//
// Design: one grid-stride kernel over the rows laid end to end.  When every
// pointer is 16-byte aligned and a row holds at least 4 floats, threads
// move float4s (16-byte loads and stores, neighbouring threads on
// neighbouring addresses); a float4 then touches at most two rows, so each
// lane picks one of two clr values.  The last total % 4 elements, and
// everything when a pointer is not aligned, take the scalar loop of the
// same launch.  Every operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn; the build also passes -fmad=false), so the result
// is bit-equal to the plain PyTorch twin, which rounds each op.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool L2, bool RETRACT>
__device__ __forceinline__ void commit_one(float& w, float& vt, float g,
                                           float clr, float l2wd, float sug) {
  if (L2) g = __fadd_rn(g, __fmul_rn(l2wd, w));
  const float step = __fmul_rn(clr, g);
  float w_new = __fsub_rn(w, step);
  if (RETRACT) w_new = __fsub_rn(w_new, sug);
  w = w_new;
  vt = __fsub_rn(vt, step);
}

template <bool L2, bool RETRACT>
__global__ void nesterov_commit_kernel(float* __restrict__ w,
                                       float* __restrict__ vt,
                                       const float* __restrict__ g,
                                       const float* __restrict__ clr,
                                       const float* __restrict__ sug,
                                       int64_t n_vec, int64_t total, int64_t n,
                                       float l2wd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  float4* w4 = reinterpret_cast<float4*>(w);
  float4* vt4 = reinterpret_cast<float4*>(vt);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* s4 = reinterpret_cast<const float4*>(sug);
  for (int64_t v = tid; v < n_vec; v += stride) {
    const int64_t base = v * 4;
    const int64_t row = base / n;
    const int64_t next = (row + 1) * n;  // first element of the next row
    const float c0 = clr[row];
    const float c1 = (base + 3 >= next) ? clr[row + 1] : c0;
    float4 wv = w4[v];
    float4 vv = vt4[v];
    const float4 gv = g4[v];
    const float4 sv = RETRACT ? s4[v] : make_float4(0.f, 0.f, 0.f, 0.f);
    commit_one<L2, RETRACT>(wv.x, vv.x, gv.x, c0, l2wd, sv.x);
    commit_one<L2, RETRACT>(wv.y, vv.y, gv.y, base + 1 >= next ? c1 : c0, l2wd, sv.y);
    commit_one<L2, RETRACT>(wv.z, vv.z, gv.z, base + 2 >= next ? c1 : c0, l2wd, sv.z);
    commit_one<L2, RETRACT>(wv.w, vv.w, gv.w, base + 3 >= next ? c1 : c0, l2wd, sv.w);
    w4[v] = wv;
    vt4[v] = vv;
  }
  for (int64_t i = n_vec * 4 + tid; i < total; i += stride) {
    float wi = w[i];
    float vi = vt[i];
    commit_one<L2, RETRACT>(wi, vi, g[i], clr[i / n], l2wd,
                            RETRACT ? sug[i] : 0.f);
    w[i] = wi;
    vt[i] = vi;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpit_nesterov_commit(float* w, float* vt, const float* g,
                                    const float* clr, const float* sug,
                                    long long n_rows, long long n, float l2wd,
                                    void* stream) {
  const int64_t total = (int64_t)n_rows * n;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t bits = (uintptr_t)w | (uintptr_t)vt | (uintptr_t)g |
                         (uintptr_t)sug;
  const int64_t n_vec = ((bits & 15) == 0 && n >= 4) ? total / 4 : 0;
  const int64_t work = n_vec > 0 ? n_vec : total;
  const int threads = 256;
  // Enough blocks for one float4 per thread up to 16 blocks per SM of an
  // H100 (132 SMs); beyond that the grid-stride loop takes over.
  const int64_t max_blocks = 132 * 16;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool l2 = l2wd != 0.0f;
  const bool retract = sug != nullptr;
#define MPIT_LAUNCH(L2, RT)                                                   \
  nesterov_commit_kernel<L2, RT><<<(unsigned)blocks, threads, 0, s>>>(        \
      w, vt, g, clr, sug, n_vec, total, (int64_t)n, l2wd)
  if (l2 && retract) MPIT_LAUNCH(true, true);
  else if (l2) MPIT_LAUNCH(true, false);
  else if (retract) MPIT_LAUNCH(false, true);
  else MPIT_LAUNCH(false, false);
#undef MPIT_LAUNCH
  return (int)cudaGetLastError();
}
