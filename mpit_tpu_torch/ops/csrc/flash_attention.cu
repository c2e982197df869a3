// K6 for float32: flash attention's two-kernel backward, for Hopper
// (sm_90a), on scalar float32 FMAs.
//
// Replaces, for float32 inputs, the Pallas kernels of
// mpit_tpu/ops/flash_attention.py:
//   K6  `_fa_bwd_dq_kernel` and `_fa_bwd_dkdv_kernel`     -> fa_bwd_dq_kernel,
//       (`_fa_2d_bwd(fused=False)`)                           fa_bwd_dkdv_kernel
// float32 K4 and K5 run on the tensor cores at float32 accuracy (3xTF32,
// flash_attention_tf32.cu); bfloat16 K4, K5 and K6 on the tensor cores of
// flash_attention_tc.cu.
//
// Every operand is a contiguous float32 (N, L, D) array, N the flattened
// leading axes; row statistics (lse, delta) are (N, L).  With s = scale *
// q.k over the valid (q row, key) pairs, from the forward's lse and delta =
// rowsum(dO * O):
//
//   P = exp(s - lse), dS = P * (dO.V^T - delta),
//   dV = P^T.dO, dK = scale * dS^T.Q, dQ = scale * dS.K.
//
// What is carried over exactly:
//   - the validity rule: keys at or past Lk masked, and under `causal`
//     q_offset + i >= kv_offset + j in global coordinates (`valid`);
//   - the dead / edge / full triage of a (q tile, key tile) pair
//     (`_block_bounds`): `triage` in flash_common.cuh is the one copy of
//     the boundary rule, shared by every kernel of the three files;
//   - every product accumulates in float32.
//
// Bound on this card: operations.  A valid pair costs 14*D flops over the
// two kernels (each recomputes S and dP), on CUDA cores here (67 TFLOP/s
// float32 peak).
//
// Design, simple first: no tensor cores.  One block of 256 threads owns a
// 64-row q tile (the dq kernel) or a 64-row key tile (the dkdv kernel) of
// one of the N heads, and loops over the other side's 64-row tiles inside
// the block (the TPU grid's sequential axis).  Tiles sit in shared memory,
// rows padded to D_MAX + 1 floats so the 16 threads that read 16
// different rows of one column hit 16 different banks.  The threads form a
// 16 x 16 grid: thread (ty, tx) holds rows ty + 16a and columns tx + 16b
// (a, b < 4) of each 64 x 64 score tile, and the same rows of the (64,
// D_MAX) accumulators.  D is a multiple of 8 up to 128; D_MAX is 32, 64 or
// 128 and the padded columns hold zeros.  The dq kernel's blocks are
// ordered heaviest first under the causal mask (the last q tiles).
#include "flash_common.cuh"

#include <type_traits>

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int NT = 256;        // threads per block, a 16 x 16 grid
constexpr int LDS = BK + 16;   // row stride of a score tile in shared memory:
                               // the two rows a warp reads lie 16 banks apart

// Rows row0 .. row0+63 of a (rows, d) matrix into a (64, DM + 1) float
// tile; rows past `rows` and columns past d read as 0.
template <int DM>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int rows, int d) {
  for (int idx = threadIdx.x; idx < 64 * DM; idx += NT) {
    const int r = idx / DM, c = idx % DM;
    const int row = row0 + r;
    dst[r * (DM + 1) + c] =
        (row < rows && c < d) ? src[(size_t)row * d + c] : 0.f;
  }
}

__device__ __forceinline__ void load_stats(float* dst, const float* __restrict__ src,
                                           int row0, int rows) {
  for (int r = threadIdx.x; r < BQ; r += NT)
    dst[r] = row0 + r < rows ? src[row0 + r] : 0.f;
}

// ---------------------------------------------------------------------------
// Backward: the shared (P, dS) tile
// ---------------------------------------------------------------------------

// P and dS of q tile i against key tile j, for the thread's 4 x 4
// elements (q rows ty + 16a, keys tx + 16b).  sLse and sDelta hold the q
// tile's rows.  A dead row has lse = -inf and no valid key, so exp(s -
// lse) is never taken there; a full tile has no dead row.
template <int DM>
__device__ __forceinline__ void p_ds(float (&p)[4][4], float (&ds)[4][4],
                                     const float* sQ, const float* sdO,
                                     const float* sK, const float* sV,
                                     const float* sLse, const float* sDelta,
                                     const Geo& g, int i, int j, int kind,
                                     int ty, int tx) {
  constexpr int LD = DM + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < g.d; ++c) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sQ[(ty + 16 * a) * LD + c];
      da[a] = sdO[(ty + 16 * a) * LD + c];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = sK[(tx + 16 * b) * LD + c];
      vb[b] = sV[(tx + 16 * b) * LD + c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(da[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool ok = kind == 2 || valid(g, i * BQ + r, j * BK + tx + 16 * b);
      p[a][b] = ok ? expf(s[a][b] * g.scale - lse) : 0.f;
      ds[a][b] = p[a][b] * (dp[a][b] - delta);
    }
  }
}

// ---------------------------------------------------------------------------
// K6, first kernel: dQ, q tiles outer
// ---------------------------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, Geo g) {
  constexpr int LD = DM + 1, NC = DM / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;  // (BQ, LDS)
  float* sLse = sDS + BQ * LDS;
  float* sDelta = sLse + BQ;
  const int n_tiles = (g.lq + BQ - 1) / BQ;
  const int i = n_tiles - 1 - (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qbase = (size_t)n * g.lq * g.d, kbase = (size_t)n * g.lk * g.d;
  const size_t sbase = (size_t)n * g.lq;

  load_tile<DM>(sQ, q + qbase, i * BQ, g.lq, g.d);
  load_tile<DM>(sdO, dout + qbase, i * BQ, g.lq, g.d);
  load_stats(sLse, lse + sbase, i * BQ, g.lq);
  load_stats(sDelta, delta + sbase, i * BQ, g.lq);
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  const int nj = (g.lk + BK - 1) / BK;
  for (int j = 0; j < nj; ++j) {
    const int kind = triage<BQ, BK>(g, i, j);
    if (kind == 0) continue;
    __syncthreads();
    load_tile<DM>(sK, k + kbase, j * BK, g.lk, g.d);
    load_tile<DM>(sV, v + kbase, j * BK, g.lk, g.d);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds<DM>(p, ds, sQ, sdO, sK, sV, sLse, sDelta, g, i, j, kind, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sDS[(ty + 16 * a) * LDS + tx + 16 * b] = ds[a][b];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float da[4], kb[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sDS[(ty + 16 * a) * LDS + c];
#pragma unroll
      for (int b = 0; b < NC; ++b) kb[b] = sK[c * LD + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < NC; ++b) acc[a][b] = fmaf(da[a], kb[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i * BQ + ty + 16 * a;
    if (row >= g.lq) continue;
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int col = tx + 16 * b;
      if (col < g.d) dq[qbase + (size_t)row * g.d + col] = g.scale * acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// K6, second kernel: key tiles outer, dK and dV in registers
// ---------------------------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                   Geo g) {
  constexpr int LD = DM + 1, NC = DM / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;   // (BQ, LDS)
  float* sDS = sP + BQ * LDS;  // (BQ, LDS)
  float* sLse = sDS + BQ * LDS;
  float* sDelta = sLse + BQ;
  const int j = (int)(blockIdx.x / g.n);
  const int n = (int)(blockIdx.x % g.n);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qbase = (size_t)n * g.lq * g.d, kbase = (size_t)n * g.lk * g.d;
  const size_t sbase = (size_t)n * g.lq;

  load_tile<DM>(sK, k + kbase, j * BK, g.lk, g.d);
  load_tile<DM>(sV, v + kbase, j * BK, g.lk, g.d);
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[a][c] = dva[a][c] = 0.f;

  const int ni = (g.lq + BQ - 1) / BQ;
  for (int i = 0; i < ni; ++i) {
    const int kind = triage<BQ, BK>(g, i, j);
    if (kind == 0) continue;
    __syncthreads();
    load_tile<DM>(sQ, q + qbase, i * BQ, g.lq, g.d);
    load_tile<DM>(sdO, dout + qbase, i * BQ, g.lq, g.d);
    load_stats(sLse, lse + sbase, i * BQ, g.lq);
    load_stats(sDelta, delta + sbase, i * BQ, g.lq);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds<DM>(p, ds, sQ, sdO, sK, sV, sLse, sDelta, g, i, j, kind, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sP[(ty + 16 * a) * LDS + tx + 16 * b] = p[a][b];
        sDS[(ty + 16 * a) * LDS + tx + 16 * b] = ds[a][b];
      }
    __syncthreads();
    // dV += P^T.dO and dK += dS^T.Q: this thread's key rows ty + 16a.
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pa[4], da[4], ob[NC], qb[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = sP[r * LDS + ty + 16 * a];
        da[a] = sDS[r * LDS + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        ob[b] = sdO[r * LD + tx + 16 * b];
        qb[b] = sQ[r * LD + tx + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < NC; ++b) {
          dva[a][b] = fmaf(pa[a], ob[b], dva[a][b]);
          dka[a][b] = fmaf(da[a], qb[b], dka[a][b]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = j * BK + ty + 16 * a;
    if (row >= g.lk) continue;
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int col = tx + 16 * b;
      if (col >= g.d) continue;
      const size_t at = kbase + (size_t)row * g.d + col;
      dk[at] = g.scale * dka[a][b];
      dv[at] = dva[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DM>
constexpr size_t tile_bytes() { return (size_t)64 * (DM + 1) * sizeof(float); }
constexpr size_t score_bytes() { return (size_t)BQ * LDS * sizeof(float); }
constexpr size_t stats_bytes() { return (size_t)2 * BQ * sizeof(float); }

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename K>
int launch(K kernel, size_t smem, int tiles, const Geo& g, cudaStream_t stream,
           void** args) {
  const long long blocks = (long long)tiles * g.n;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel((const void*)kernel, dim3((unsigned)blocks), dim3(NT), args,
                         smem, stream);
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

}  // namespace

// Each entry point takes float32 operands (bfloat16 goes to
// flash_attention_tc.cu), launches on `stream` and returns
// cudaGetLastError() after its launch (0 on success); it allocates
// nothing.

// K6, first kernel: dq.
extern "C" int mpit_fa_bwd_dq(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse, const float* delta,
                              float* dq, int n, int lq, int lk, int d, int q_offset,
                              int kv_offset, float scale, int causal, void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (lq + BQ - 1) / BQ;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    const size_t smem = 4 * tile_bytes<DM>() + score_bytes() + stats_bytes();
    void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dq, &g};
    return launch(fa_bwd_dq_kernel<DM>, smem, tiles, g, s, args);
  });
}

// K6, second kernel: dk and dv.
extern "C" int mpit_fa_bwd_dkdv(const float* q, const float* k, const float* v,
                                const float* dout, const float* lse, const float* delta,
                                float* dk, float* dv, int n, int lq, int lk, int d,
                                int q_offset, int kv_offset, float scale, int causal,
                                void* stream) {
  Geo g = make_geo(n, lq, lk, d, q_offset, kv_offset, scale, causal);
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (lk + BK - 1) / BK;
  return by_width(d, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    const size_t smem = 4 * tile_bytes<DM>() + 2 * score_bytes() + stats_bytes();
    void* args[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &g};
    return launch(fa_bwd_dkdv_kernel<DM>, smem, tiles, g, s, args);
  });
}
