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
// minima out of it with masked full-tile passes. Here one thread owns one
// query and keeps its three best (d2, index) pairs in registers; the block
// streams the known points through shared-memory tiles, every thread reading
// the same point at the same time (a broadcast, no bank conflict). Points
// arrive in index order and a candidate replaces an entry only when strictly
// nearer, so equal distances keep the lower index.
//
// d2 is ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest intrinsics, the
// order of the plain PyTorch version: the indices must be equal, not close.
// The distance is sqrt(max(d2, 0)) of that same d2.
//
// Bound: bytes are small (12 B a query, 13 B a known point, 24 B out a
// query); the work is one distance and up to three compares for every
// (query, valid known point) pair: bound by float32 operations.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kMissDistance = 1e5f;

__global__ void __launch_bounds__(kThreads)
knn3_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
            const uint8_t* __restrict__ valid, int* __restrict__ out_idx,
            float* __restrict__ out_dist, int s, int m, int blocks_per_cloud) {
  __shared__ float tile[3 * kTile];
  __shared__ uint8_t tile_ok[kTile];
  const int b = blockIdx.x / blocks_per_cloud;
  const int row = (blockIdx.x % blocks_per_cloud) * kThreads + threadIdx.x;
  const bool has_row = row < s;
  const float* pts = known + static_cast<long long>(b) * m * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * m;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (has_row) {
    const float* q = unknown + (static_cast<long long>(b) * s + row) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = -1, i1 = -1, i2 = -1;

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    for (int i = threadIdx.x; i < 3 * len; i += kThreads) tile[i] = pts[3 * t0 + i];
    for (int i = threadIdx.x; i < len; i += kThreads) tile_ok[i] = ok[t0 + i];
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      if (tile_ok[j] == 0) continue;
      const float dx = __fadd_rn(qx, -tile[3 * j]);
      const float dy = __fadd_rn(qy, -tile[3 * j + 1]);
      const float dz = __fadd_rn(qz, -tile[3 * j + 2]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d < d2) {
        const int i = t0 + j;
        if (d < d0) {
          d2 = d1; i2 = i1;
          d1 = d0; i1 = i0;
          d0 = d; i0 = i;
        } else if (d < d1) {
          d2 = d1; i2 = i1;
          d1 = d; i1 = i;
        } else {
          d2 = d; i2 = i;
        }
      }
    }
    __syncthreads();
  }

  if (!has_row) return;
  int* oi = out_idx + (static_cast<long long>(b) * s + row) * 3;
  float* od = out_dist + (static_cast<long long>(b) * s + row) * 3;
  oi[0] = i0 >= 0 ? i0 : m - 1;
  oi[1] = i1 >= 0 ? i1 : m - 1;
  oi[2] = i2 >= 0 ? i2 : m - 1;
  od[0] = i0 >= 0 ? sqrtf(fmaxf(d0, 0.0f)) : kMissDistance;
  od[1] = i1 >= 0 ? sqrtf(fmaxf(d1, 0.0f)) : kMissDistance;
  od[2] = i2 >= 0 ? sqrtf(fmaxf(d2, 0.0f)) : kMissDistance;
}

}  // namespace

// For `batch` clouds: the 3 nearest of `m` known points ((B, M, 3) float32,
// (B, M) uint8 valid) for each of `s` queries ((B, S, 3) float32), into
// `out_idx` ((B, S, 3) int32) and `out_dist` ((B, S, 3) float32). Returns the
// CUDA error of the launch (0 on success).
extern "C" int knn3_launch(const void* unknown, const void* known, const void* valid,
                           void* out_idx, void* out_dist, int batch, int s, int m,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks_per_cloud = (s + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(batch) * blocks_per_cloud;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  knn3_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(unknown), static_cast<const float*>(known),
      static_cast<const uint8_t*>(valid), static_cast<int*>(out_idx),
      static_cast<float*>(out_dist), s, m, blocks_per_cloud);
  return static_cast<int>(cudaGetLastError());
}
