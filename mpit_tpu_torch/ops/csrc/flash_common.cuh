// What the flash-attention kernels of flash_attention_tc.cu (bfloat16 K4,
// K5 and K6 on the tensor cores) and flash_attention_tf32.cu (float32 K4,
// K5 and K6 on the tensor cores, 3xTF32) share: the call's geometry, the
// one copy of the masking rule, the live range it gives, and K5's
// deterministic dQ reduction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG_NEG = -1e30f;

struct Geo {
  int n, lq, lk, d;
  int q_offset, kv_offset;
  float scale;
  int causal;
};

// `_block_bounds`: 0 dead (skip), 1 edge (mask each element), 2 full (no
// element masked) for q tile i (rows of BQ) and key tile j (rows of BK).
template <int BQ, int BK>
__device__ __forceinline__ int triage(const Geo& g, int i, int j) {
  const int q_lo = g.q_offset + i * BQ;
  const int k_hi = (j + 1) * BK;  // exclusive, local
  bool live = j * BK < g.lk;
  bool full = k_hi <= g.lk;
  if (g.causal) {
    live = live && (q_lo + BQ - 1 >= g.kv_offset + j * BK);
    full = full && (q_lo >= g.kv_offset + k_hi - 1);
  }
  return live ? (full ? 2 : 1) : 0;
}

// The range [lo, hi) of tiles t of one side that are live against tile
// `fixed` of the other (a contiguous range under the causal mask and the
// key length); lo = hi when none is.
template <int BQ, int BK, bool Q_SIDE>
__device__ __forceinline__ void live_range(const Geo& g, int fixed, int count, int& lo,
                                           int& hi) {
  lo = count;
  hi = 0;
  for (int t = 0; t < count; ++t) {
    const int kind = Q_SIDE ? triage<BQ, BK>(g, t, fixed) : triage<BQ, BK>(g, fixed, t);
    if (kind != 0) {
      lo = min(lo, t);
      hi = t + 1;
    }
  }
}

// Local q row qi against local key kj, inside an edge tile.
__device__ __forceinline__ bool valid(const Geo& g, int qi, int kj) {
  return kj < g.lk && (!g.causal || g.q_offset + qi >= g.kv_offset + kj);
}

// K5's dQ: dq = scale * sum of the partials dqp[j] (float32, (tiles of BK
// keys, n, lq, d)) over the key tiles j that are live for the row's q tile
// of BQ rows, in ascending j.  Dead pairs wrote nothing and are not read;
// the order is fixed, so the bits are the same every run.  One thread per
// four columns of one row (d is a multiple of 8).
template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(256)
dq_reduce_kernel(const float* __restrict__ dqp, T* __restrict__ dq, Geo g) {
  const long long quads = (long long)g.n * g.lq * (g.d / 4);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= quads) return;
  const long long elem = idx * 4;  // (n, row, col) flattened
  const int row = (int)((elem / g.d) % g.lq);
  const size_t slot = (size_t)g.n * g.lq * g.d;
  const int i = row / BQ;
  const int nj = (g.lk + BK - 1) / BK;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < nj; ++j) {
    if (triage<BQ, BK>(g, i, j) == 0) continue;
    const float4 p = *reinterpret_cast<const float4*>(dqp + j * slot + elem);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const float out[4] = {g.scale * s.x, g.scale * s.y, g.scale * s.z, g.scale * s.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (sizeof(T) == 2) {
      dq[elem + c] = __float2bfloat16_rn(out[c]);
    } else {
      dq[elem + c] = out[c];
    }
  }
}

template <typename T, int BQ, int BK>
int launch_dq_reduce(const float* dqp, T* dq, const Geo& g, cudaStream_t stream) {
  const long long quads = (long long)g.n * g.lq * (g.d / 4);
  const long long blocks = (quads + 255) / 256;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dq_reduce_kernel<T, BQ, BK><<<(unsigned)blocks, 256, 0, stream>>>(dqp, dq, g);
  return (int)cudaGetLastError();
}

bool bad_geometry(const Geo& g) {
  return g.n <= 0 || g.lq <= 0 || g.lk <= 0 || g.d <= 0 || g.d > 128 || g.d % 8 != 0;
}

Geo make_geo(int n, int lq, int lk, int d, int q_offset, int kv_offset, float scale,
             int causal) {
  Geo g;
  g.n = n;
  g.lq = lq;
  g.lk = lk;
  g.d = d;
  g.q_offset = q_offset;
  g.kv_offset = kv_offset;
  g.scale = scale;
  g.causal = causal;
  return g;
}

}  // namespace
