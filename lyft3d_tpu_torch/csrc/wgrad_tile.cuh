// Weight-gradient tile shared by the sparse-conv backward kernels
// (stencil_conv.cu, subm_conv.cu) for Hopper (sm_90a).
//
// Both weight gradients are sums of outer products over (source row, query)
// pairs: dW[k, n] += Σ_hits a[row(hit)][k] · g[query(hit)][n]. A block owns a
// kWgK x kWgN tile of one offset's weight matrix and a tile of queries whose
// hits it has compacted into shared memory; it stages kWgQ hits at a time
// (the gathered `a` rows and the `g` rows, converted to float32), every
// thread accumulates a 4 x 4 register tile with fused multiply-adds, and the
// tile ends in float32 atomicAdds into the zeroed output. The order of the
// atomics, and of the hits in the compacted list, varies from run to run, so
// the sums agree to float32 rounding and not bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgrad {

constexpr int kThreads = 256;
constexpr int kWgK = 64;       // rows of the weight tile (lanes of `a`)
constexpr int kWgN = 64;       // columns of the weight tile (lanes of `g`)
constexpr int kWgQ = 16;       // hits staged at a time
constexpr int kQueries = 1024; // queries a block compacts

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Appends (row, query) to the block's compacted hit list.
__device__ __forceinline__ void push_hit(int* hit_row, int* hit_q, int* count, int row, int q) {
  const int slot = atomicAdd(count, 1);
  hit_row[slot] = row;
  hit_q[slot] = q;
}

// out[(k0 + i) · out_stride + n0 + m] += Σ_h a[hit_row[h] · a_stride + k0 + i] ·
// g[hit_q[h] · g_stride + n0 + m] for i < kw, m < nw. All threads of the
// block call it; `hit_row`/`hit_q` lie in shared memory.
template <typename TA, typename TG>
__device__ __forceinline__ void accumulate_tile(
    const TA* __restrict__ a, long long a_stride, const TG* __restrict__ g, long long g_stride,
    const int* hit_row, const int* hit_q, int nhits, int k0, int kw, int n0, int nw,
    float* __restrict__ out, int out_stride) {
  __shared__ __align__(16) float a_s[kWgQ][kWgK];
  __shared__ __align__(16) float g_s[kWgQ][kWgN];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;

  for (int h0 = 0; h0 < nhits; h0 += kWgQ) {
    for (int item = tid; item < kWgQ * kWgK; item += kThreads) {
      const int h = item / kWgK;
      const int lane = item - h * kWgK;
      float v = 0.0f;
      if (h0 + h < nhits && lane < kw) {
        v = load_float(a + static_cast<long long>(hit_row[h0 + h]) * a_stride + k0 + lane);
      }
      a_s[h][lane] = v;
    }
    for (int item = tid; item < kWgQ * kWgN; item += kThreads) {
      const int h = item / kWgN;
      const int lane = item - h * kWgN;
      float v = 0.0f;
      if (h0 + h < nhits && lane < nw) {
        v = load_float(g + static_cast<long long>(hit_q[h0 + h]) * g_stride + n0 + lane);
      }
      g_s[h][lane] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int h = 0; h < kWgQ; ++h) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[h][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&g_s[h][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[i][m] = fmaf(av[i], gv[m], acc[i][m]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = ty * 4 + i;
    if (k >= kw) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = tx * 4 + m;
      if (n < nw && acc[i][m] != 0.0f) {
        atomicAdd(out + static_cast<long long>(k0 + k) * out_stride + n0 + n, acc[i][m]);
      }
    }
  }
}

}  // namespace wgrad
