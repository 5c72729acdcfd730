// Three nearest neighbours for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_knn_kernel` with `_extract_min_k`
// (lyft3d_tpu/ops/select_kernel.py:115 and :53, launched by `_run` :164 for
// `knn_fused`). What it computes: for every query point the 3 nearest valid
// known points by squared distance, the lowest index on equal distances, and
// their distances. A query with fewer than 3 valid known points gets the
// miss values in the open slots: index M - 1 and distance 1e5.
//
// The TPU kernel held a (rows, M) distance tile in VMEM and pulled three
// minima out of it with masked full-tile passes. Here the work of a block is
// a grid of queries by known points:
//
// * Known points as float4 tiles. The kernel streams the (B, M, 3) cloud
//   through 1,024-point shared-memory tiles, double-buffered through
//   registers: each thread loads its four points of the next tile while the
//   block works on this one, and applies the (B, M) mask as it stores them.
//   A valid point is stored as (x, y, z, 0), an invalid one as (+inf, +inf,
//   +inf, 0). From a finite query an invalid point's d2 is +inf (from an
//   infinite one NaN), never below a kept distance under the strict `<`
//   below, so the inner loop has no mask byte and no branch for it. A valid
//   point whose d2 overflows to +inf is never kept either, which is the
//   plain version's miss for it. One launch a call, no scratch.
// * Each thread owns Q queries, so that one LDS.128 of a point feeds Q
//   independent distance chains, and P consecutive lanes of a warp (a group)
//   share those Q queries and split every tile among them: lane `part` of the
//   group takes points part, part + P, part + 2P, ... Each thread keeps its
//   top 3 (d2, index) for each query in registers; its points arrive in
//   ascending index and a candidate enters only when strictly nearer, so its
//   list is ordered by (d2, index).
// * The group then merges its P lists with butterfly shuffles, by (d2,
//   index): the smaller distance first, the lower index on a tie. That is the
//   order of the plain version's stable sort, so the indices are the same for
//   every P. Q and P come from `_knn_launch_shape` in ops/pointnet2.py.
//
// d2 is ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest intrinsics, the
// order of the plain PyTorch version: the indices must be equal, not close.
// The distance is sqrt(max(d2, 0)) of that same d2.
//
// Bound: bytes are small (12 B a query, 13 B a known point, 24 B out a
// query); the work is one distance and a compare for every (query, valid
// known point) pair: bound by float32 operations.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kPerThread = kTile / kThreads;  // points a thread stages a tile
constexpr float kMissDistance = 1e5f;

// (da, ia) before (db, ib) in the plain version's order.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Merges the ordered top 3 (d, id) with the ordered top 3 (od, oi) into d, id.
__device__ __forceinline__ void merge3(float (&d)[3], int (&id)[3], float (&od)[3], int (&oi)[3]) {
  float rd[3];
  int ri[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const bool mine = before(d[0], id[0], od[0], oi[0]);
    rd[e] = mine ? d[0] : od[0];
    ri[e] = mine ? id[0] : oi[0];
    // Pop the taken head.
    if (mine) {
      d[0] = d[1]; id[0] = id[1];
      d[1] = d[2]; id[1] = id[2];
      d[2] = CUDART_INF_F; id[2] = INT_MAX;
    } else {
      od[0] = od[1]; oi[0] = oi[1];
      od[1] = od[2]; oi[1] = oi[2];
      od[2] = CUDART_INF_F; oi[2] = INT_MAX;
    }
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    d[e] = rd[e];
    id[e] = ri[e];
  }
}

template <int Q, int P>
__global__ void __launch_bounds__(kThreads)
knn3_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
            const uint8_t* __restrict__ valid, int* __restrict__ out_idx,
            float* __restrict__ out_dist, int s, int m, int blocks_per_cloud) {
  static_assert(32 % P == 0, "a group of P lanes lies in one warp");
  constexpr int kGroups = kThreads / P;
  __shared__ __align__(16) float4 tile[2][kTile];
  const int b = blockIdx.x / blocks_per_cloud;
  const int base = (blockIdx.x % blocks_per_cloud) * kGroups * Q;
  const int group = threadIdx.x / P;
  const int part = threadIdx.x % P;
  const float* src = known + static_cast<long long>(b) * m * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * m;

  float qx[Q], qy[Q], qz[Q];
  float d[Q][3];
  int id[Q][3];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int row = base + k * kGroups + group;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (row < s) {
      const float* q = unknown + (static_cast<long long>(b) * s + row) * 3;
      qx[k] = q[0];
      qy[k] = q[1];
      qz[k] = q[2];
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      d[k][e] = CUDART_INF_F;
      id[k][e] = INT_MAX;
    }
  }

  const int tiles = (m + kTile - 1) / kTile;
  float4 next[kPerThread];
  auto fetch = [&](int t) {  // this thread's points of tile t, masked, into registers
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int i = t * kTile + r * kThreads + threadIdx.x;
      if (i < m) {
        next[r] = ok[i] ? make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 0.0f)
                        : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.0f);
      }
    }
  };
  auto store = [&](int t) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (t * kTile + r * kThreads + threadIdx.x < m) tile[t & 1][r * kThreads + threadIdx.x] = next[r];
    }
  };
  fetch(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) fetch(t + 1);  // in flight while this tile is worked
    const float4* pts = tile[t & 1];
    const int t0 = t * kTile;
    const int len = min(kTile, m - t0);
    for (int j = part; j < len; j += P) {
      const float4 p = pts[j];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float dx = __fadd_rn(qx[k], -p.x);
        const float dy = __fadd_rn(qy[k], -p.y);
        const float dz = __fadd_rn(qz[k], -p.z);
        const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (dd < d[k][2]) {
          const int i = t0 + j;
          if (dd < d[k][0]) {
            d[k][2] = d[k][1]; id[k][2] = id[k][1];
            d[k][1] = d[k][0]; id[k][1] = id[k][0];
            d[k][0] = dd; id[k][0] = i;
          } else if (dd < d[k][1]) {
            d[k][2] = d[k][1]; id[k][2] = id[k][1];
            d[k][1] = dd; id[k][1] = i;
          } else {
            d[k][2] = dd; id[k][2] = i;
          }
        }
      }
    }
    // The other buffer was last read before the previous barrier.
    if (t + 1 < tiles) store(t + 1);
    __syncthreads();
  }

#pragma unroll
  for (int off = P / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      float od[3];
      int oi[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        od[e] = __shfl_xor_sync(0xffffffffu, d[k][e], off);
        oi[e] = __shfl_xor_sync(0xffffffffu, id[k][e], off);
      }
      merge3(d[k], id[k], od, oi);
    }
  }

  if (part != 0) return;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int row = base + k * kGroups + group;
    if (row >= s) continue;
    int* oi = out_idx + (static_cast<long long>(b) * s + row) * 3;
    float* od = out_dist + (static_cast<long long>(b) * s + row) * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const bool miss = id[k][e] == INT_MAX;
      oi[e] = miss ? m - 1 : id[k][e];
      od[e] = miss ? kMissDistance : sqrtf(fmaxf(d[k][e], 0.0f));
    }
  }
}

template <int Q, int P>
cudaError_t launch(const float* unknown, const float* known, const uint8_t* valid, int* out_idx,
                   float* out_dist, int batch, int s, int m, cudaStream_t stream) {
  const int rows = kThreads / P * Q;
  const int blocks_per_cloud = (s + rows - 1) / rows;
  const long long blocks = static_cast<long long>(batch) * blocks_per_cloud;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  knn3_kernel<Q, P><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      unknown, known, valid, out_idx, out_dist, s, m, blocks_per_cloud);
  return cudaGetLastError();
}

}  // namespace

// For `batch` clouds: the 3 nearest of `m` known points ((B, M, 3) float32,
// (B, M) uint8 valid) for each of `s` queries ((B, S, 3) float32), into
// `out_idx` ((B, S, 3) int32) and `out_dist` ((B, S, 3) float32), with `q`
// queries a thread and `p` threads a query group: q in {1, 2}, p in {4, 8,
// 16}, the shapes `_knn_launch_shape` picks. Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int knn3_launch(const void* unknown, const void* known, const void* valid,
                           void* out_idx, void* out_dist, int batch, int s, int m, int q, int p,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(unknown);
  const float* kn = static_cast<const float*>(known);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  int* oi = static_cast<int*>(out_idx);
  float* od = static_cast<float*>(out_dist);
#define KNN3_CASE(Q, P) \
  if (q == Q && p == P) return static_cast<int>(launch<Q, P>(u, kn, ok, oi, od, batch, s, m, st));
  KNN3_CASE(1, 4) KNN3_CASE(1, 8) KNN3_CASE(1, 16)
  KNN3_CASE(2, 4) KNN3_CASE(2, 8) KNN3_CASE(2, 16)
#undef KNN3_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
