// The fused parameter updates of mpit_tpu/ops/fused_update.py, on flat f32
// vectors, in place: K1 (Nesterov commit), K2 (elastic force + retract)
// and K3 (Adam).  Each is bound by bytes on Hopper: a few operations for
// every 4-byte element read or written, far below the card's ~20 flops a
// byte in f32.  Every operation is rounded on its own (__fmul_rn,
// __fadd_rn, ...; the build also passes -fmad=false), in the reference's
// order, so each kernel is bit-equal to its plain PyTorch twin.
//
// All three: one sweep (`sweep_kernel`), shaped by what bounds them at the
// main path's sizes (0.27-2.2 M elements, 2.6-15 us at the HBM rate): the
// fixed cost of a launch and of the first round trip to memory is as large
// as the stream.  So every byte is requested at once and each warp goes on
// as soon as its own bytes land:
//
// - One 16-byte chunk of each operand a thread, neighbouring threads on
//   neighbouring chunks, loads issued before any arithmetic (only of the
//   operands the rule reads: K2's `sug` is written, never loaded); up to 16
//   blocks of 256 threads an SM (the SM count read once from the device and
//   cached), a grid-stride loop beyond that.
// - Loads and stores carry the evict-first hint (ld/st.global.cs): a call
//   touches each line once, and the L2 it leaves full of its own dirty
//   lines is what the next call has to evict.
// - Programmatic dependent launch: the sweep is launched with
//   programmatic stream serialization allowed, waits for the grid before
//   it (griddepcontrol.wait: that grid has completed and its writes are
//   visible) before it reads anything, and at once lets the grid after it
//   launch (griddepcontrol.launch_dependents).  A launch's fixed cost then
//   overlaps the tail of the kernel before it, a PyTorch kernel that never
//   signals included: queued behind an elementwise PyTorch kernel, as in
//   a training step, each sweep takes 1.1-1.4 us less than launched
//   plainly (PERF.md).  A kernel that follows without the attribute waits
//   for this one to complete, as always.
// - The same per-element functions (commit_one, elastic_one, adam_one)
//   serve the chunks and the scalar path, so no path can round otherwise.
//   K1 reads clr[0] once when there is one row; with several it finds a
//   chunk's row, and the next boundary, once a chunk.  K3 reads lr_t once
//   a thread.
// - Edges: when every operand sits at the same offset within 16 bytes, the
//   elements before the first 16-byte boundary (a view one float into its
//   buffer) and the last ones past the final whole chunk go through a
//   scalar path of the same launch; when the offsets differ, or the
//   vectors hold less than a chunk, every element does.
//
// A design that brought each block's slice into shared memory with
// Hopper's 1-D bulk async copies (cp.async.bulk onto mbarriers, one block
// an SM, every stage issued at once) was measured slower at every
// main-path shape, the more so the more copies an SM issued (PERF.md,
// Findings): at these sizes a warp that computes as soon as its own loads
// land beats a block that waits for a stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// The per-element rules
// ---------------------------------------------------------------------------

// K1, the msgd commit (replaces `_nesterov_kernel`, function
// `fused_nesterov_commit`).  For every element of `n_rows` rows of `n`:
//
//     g'  = g + l2wd * w                  (only when l2wd != 0)
//     s   = clr[row] * g'
//     w  <- w - s   (- sug, when the EASGD retract rides along)
//     vt <- vt - s
//
// `clr` is a device array of one learning rate per row, so the decayed lr
// never crosses to the host.  20 bytes an element (24 with sug) for 3-4
// flops: at the CNN's 544,522 parameters and one row, 10.9 MB, 3.25 us at
// 3.35 TB/s.
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

// K2, the elastic force and retract of the EASGD exchange, worker side
// (replaces `_elastic_kernel`, function `fused_elastic`).  For every
// element of a flat vector:
//
//     sug <- mva * (w - c)
//     w   <- w - sug
//
// `w` is updated in place, `sug` written to a buffer of its own, `c` (the
// center) only read.  The center's `+= sum(sug)` is a reduction across
// workers and stays outside.  16 bytes an element (w and c read, w and sug
// written) for 3 flops: at the CNN's 544,522 parameters 8.71 MB, 2.60 us at
// 3.35 TB/s.  Loading `sug` too would make it 20 bytes and 3.25 us.
__device__ __forceinline__ void elastic_one(float& w, float c, float mva, float& sug) {
  sug = __fmul_rn(mva, __fsub_rn(w, c));
  w = __fsub_rn(w, sug);
}

// K3, Adam (replaces `_adam_kernel`, function `fused_adam`).  For every
// element:
//
//     m <- beta1 * m + (1 - beta1) * g
//     v <- beta2 * v + ((1 - beta2) * g) * g
//     p <- p - (lr_t * m) / (sqrt(v) + eps)
//
// `lr_t` (bias-corrected) is a device scalar, computed on the card from
// the device step counter, so no apply waits on the host.  `1 - beta1` and
// `1 - beta2` arrive from the wrapper rounded once from doubles, as the
// reference's weak-typed scalars are: computing them here in f32 gives
// other numbers (1f - 0.999f is 0.0009999871, not the 0.001f the reference
// uses).  28 bytes an element for 11 operations, a square root and a
// division among them: at 272,261 elements (one shard of the CNN at np=4)
// 7.62 MB, 2.28 us; at 544,522, 15.25 MB, 4.55 us.
struct AdamConsts {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         float lrt, const AdamConsts& k) {
  m = __fadd_rn(__fmul_rn(k.beta1, m), __fmul_rn(k.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(k.beta2, v),
                __fmul_rn(__fmul_rn(k.one_minus_beta2, g), g));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lrt, m),
                             __fadd_rn(__fsqrt_rn(v), k.eps)));
}

// ---------------------------------------------------------------------------
// The sweep
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

// Where the chunks lie; the same for every block of a launch.
struct Sweep {
  int64_t total;     // elements
  int64_t head;      // elements before the first chunk (the scalar path's)
  int64_t n_chunks;  // 16-byte chunks from element `head`
};

// A rule names its operands (`ptr`, `kOps` of them), which of them the
// sweep loads (`kInMask`) and which it stores (`kOutMask`), and computes a
// chunk of four elements in registers (`chunk`) or one element in memory
// (`element`).

// K1's operands: w, vt, g, sug (w and vt written) and a learning rate a
// row.
template <bool L2, bool RETRACT>
struct CommitRule {
  static constexpr int kOps = RETRACT ? 4 : 3;
  static constexpr unsigned kInMask = RETRACT ? 0b1111 : 0b0111;
  static constexpr unsigned kOutMask = 0b0011;
  float* ptr[4];
  const float* clr;
  int64_t n, n_rows;
  float l2wd;
  float clr0;  // clr[0], the only one when there is one row

  __device__ __forceinline__ void prepare() { clr0 = clr[0]; }

  // The four elements of the chunk at element e, in registers.
  __device__ __forceinline__ void chunk(float4 (&x)[kOps], int64_t e) const {
    float c[4] = {clr0, clr0, clr0, clr0};
    if (n_rows != 1) {
      const int64_t row = e / n;
      const int64_t next = (row + 1) * n;  // first element of the next row
      const float c0 = clr[row];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        c[k] = e + k < next ? c0 : e + k < next + n ? clr[row + 1] : clr[(e + k) / n];
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (RETRACT) s = x[3];
    commit_one<L2, RETRACT>(x[0].x, x[1].x, x[2].x, c[0], l2wd, s.x);
    commit_one<L2, RETRACT>(x[0].y, x[1].y, x[2].y, c[1], l2wd, s.y);
    commit_one<L2, RETRACT>(x[0].z, x[1].z, x[2].z, c[2], l2wd, s.z);
    commit_one<L2, RETRACT>(x[0].w, x[1].w, x[2].w, c[3], l2wd, s.w);
  }

  __device__ __forceinline__ void element(int64_t e) const {
    float wi = ptr[0][e];
    float vi = ptr[1][e];
    commit_one<L2, RETRACT>(wi, vi, ptr[2][e], n_rows == 1 ? clr0 : clr[e / n], l2wd,
                            RETRACT ? ptr[3][e] : 0.f);
    ptr[0][e] = wi;
    ptr[1][e] = vi;
  }
};

// K2's operands: w, c, sug; w is read and written, c only read, sug only
// written.
struct ElasticRule {
  static constexpr int kOps = 3;
  static constexpr unsigned kInMask = 0b011;
  static constexpr unsigned kOutMask = 0b101;
  float* ptr[3];
  float mva;

  __device__ __forceinline__ void prepare() {}

  __device__ __forceinline__ void chunk(float4 (&x)[kOps], int64_t) const {
    elastic_one(x[0].x, x[1].x, mva, x[2].x);
    elastic_one(x[0].y, x[1].y, mva, x[2].y);
    elastic_one(x[0].z, x[1].z, mva, x[2].z);
    elastic_one(x[0].w, x[1].w, mva, x[2].w);
  }

  __device__ __forceinline__ void element(int64_t e) const {
    float wi = ptr[0][e];
    float si;
    elastic_one(wi, ptr[1][e], mva, si);
    ptr[0][e] = wi;
    ptr[2][e] = si;
  }
};

// K3's operands: p, g, m, v; p, m and v are written.
struct AdamRule {
  static constexpr int kOps = 4;
  static constexpr unsigned kInMask = 0b1111;
  static constexpr unsigned kOutMask = 0b1101;
  float* ptr[4];
  const float* lr_t;
  AdamConsts k;
  float lrt;

  __device__ __forceinline__ void prepare() { lrt = *lr_t; }

  __device__ __forceinline__ void chunk(float4 (&x)[kOps], int64_t) const {
    adam_one(x[0].x, x[1].x, x[2].x, x[3].x, lrt, k);
    adam_one(x[0].y, x[1].y, x[2].y, x[3].y, lrt, k);
    adam_one(x[0].z, x[1].z, x[2].z, x[3].z, lrt, k);
    adam_one(x[0].w, x[1].w, x[2].w, x[3].w, lrt, k);
  }

  __device__ __forceinline__ void element(int64_t e) const {
    float pi = ptr[0][e];
    float mi = ptr[2][e];
    float vi = ptr[3][e];
    adam_one(pi, ptr[1][e], mi, vi, lrt, k);
    ptr[0][e] = pi;
    ptr[2][e] = mi;
    ptr[3][e] = vi;
  }
};

template <class Rule>
__global__ void __launch_bounds__(kThreads) sweep_kernel(Rule rule, const Sweep sw) {
  constexpr int K = Rule::kOps;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  rule.prepare();
  for (int64_t c = first; c < sw.n_chunks; c += stride) {
    float4 x[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (Rule::kInMask >> k & 1)
        x[k] = __ldcs(reinterpret_cast<const float4*>(rule.ptr[k] + sw.head) + c);
    rule.chunk(x, sw.head + 4 * c);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (Rule::kOutMask >> k & 1)
        __stcs(reinterpret_cast<float4*>(rule.ptr[k] + sw.head) + c, x[k]);
  }
  // The scalar path: the head, then the tail.
  const int64_t tail = sw.head + 4 * sw.n_chunks;
  const int64_t n_scalar = sw.head + (sw.total - tail);
  for (int64_t i = first; i < n_scalar; i += stride)
    rule.element(i < sw.head ? i : tail + (i - sw.head));
}

// The SM count of device `dev` into `*sms`, read from the device once
// (for the first 64 devices; past them on every call).
cudaError_t sm_count(int dev, int* sms) {
  static std::atomic<int> cached[64];
  const bool cacheable = dev >= 0 && dev < 64;
  *sms = cacheable ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (*sms > 0) return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*sms <= 0) return cudaErrorInvalidDevice;
  if (cacheable) cached[dev].store(*sms, std::memory_order_relaxed);
  return cudaSuccess;
}

// Launches `sweep_kernel<Rule>` over `total` elements: in 16-byte chunks
// where every operand sits at the same offset within 16 bytes.  Returns
// cudaGetLastError() (0 on success).
template <class Rule>
int launch_sweep(const Rule& rule, int64_t total, void* stream) {
  const uintptr_t a = (uintptr_t)rule.ptr[0] & 15;
  bool same = a % 4 == 0;
  for (int k = 1; k < Rule::kOps; ++k) same = same && ((uintptr_t)rule.ptr[k] & 15) == a;
  Sweep sw{total, same ? (int64_t)((16 - a) & 15) / 4 : total, 0};
  if (sw.head > total) sw.head = total;
  sw.n_chunks = (total - sw.head) / 4;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t work = sw.n_chunks > 0 ? sw.n_chunks : total;
  const int64_t cap = (int64_t)kBlocksPerSm * sms;
  const int64_t want = (work + kThreads - 1) / kThreads;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(want < cap ? want : cap));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sweep_kernel<Rule>, rule, sw);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool L2, bool RETRACT>
int launch_commit(float* w, float* vt, const float* g, const float* clr, const float* sug,
                  int64_t n_rows, int64_t n, float l2wd, void* stream) {
  CommitRule<L2, RETRACT> rule{};
  rule.ptr[0] = w;
  rule.ptr[1] = vt;
  rule.ptr[2] = const_cast<float*>(g);
  rule.ptr[3] = const_cast<float*>(sug);
  rule.clr = clr;
  rule.n = n;
  rule.n_rows = n_rows;
  rule.l2wd = l2wd;
  return launch_sweep(rule, n_rows * n, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpit_nesterov_commit(float* w, float* vt, const float* g,
                                    const float* clr, const float* sug,
                                    long long n_rows, long long n, float l2wd,
                                    void* stream) {
  if (n_rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const bool l2 = l2wd != 0.0f;
  if (sug != nullptr)
    return l2 ? launch_commit<true, true>(w, vt, g, clr, sug, n_rows, n, l2wd, stream)
              : launch_commit<false, true>(w, vt, g, clr, sug, n_rows, n, l2wd, stream);
  return l2 ? launch_commit<true, false>(w, vt, g, clr, sug, n_rows, n, l2wd, stream)
            : launch_commit<false, false>(w, vt, g, clr, sug, n_rows, n, l2wd, stream);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpit_adam(float* p, const float* g, float* m, float* v,
                         const float* lr_t, long long n, float beta1,
                         float one_minus_beta1, float beta2,
                         float one_minus_beta2, float eps, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  AdamRule rule{};
  rule.ptr[0] = p;
  rule.ptr[1] = const_cast<float*>(g);
  rule.ptr[2] = m;
  rule.ptr[3] = v;
  rule.lr_t = lr_t;
  rule.k = AdamConsts{beta1, one_minus_beta1, beta2, one_minus_beta2, eps};
  return launch_sweep(rule, n, stream);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpit_elastic(float* w, const float* c, float* sug, long long n,
                            float mva, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  ElasticRule rule{};
  rule.ptr[0] = w;
  rule.ptr[1] = const_cast<float*>(c);
  rule.ptr[2] = sug;
  rule.mva = mva;
  return launch_sweep(rule, n, stream);
}
