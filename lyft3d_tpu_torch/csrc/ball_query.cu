// Multi-radius ball query for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ball_kernel` with `_extract_min_k`
// (lyft3d_tpu/ops/select_kernel.py:94 and :53, launched by `_run` :164 for
// `multi_radius_ball_query_fused` / `ball_query_fused`) together with its
// `_postprocess_first_k` (:196). What it computes: for every centre and every
// radius, the first k valid point indices with d2 < r^2 in index order and
// their count; slots past the count repeat the first hit, a row without a
// hit is all 0, the count is clipped to k. One squared distance per
// (centre, point) pair serves all radii.
//
// The TPU kernel held a (rows, N) key tile in VMEM and pulled k minima out of
// it with k masked full-tile passes. A GPU scans instead: one warp owns one
// centre and walks the cloud in index order, 32 points at a time. Each lane
// tests one point against every radius; __ballot_sync and __popc hand the
// hits their output slots in index order, and the warp stops as soon as every
// radius has its k. The block's warps share the points through shared-memory
// tiles; the block leaves the loop when all its warps are done.
//
// d2 is ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest intrinsics, the
// order of the plain PyTorch version, and r^2 arrives as the float32 the host
// rounded once: the indices must be equal, not close.
//
// Bound: bytes are small (13 B a point, 12 B a centre, 4 B an output slot);
// the work is one distance and n_radii compares per scanned pair, so the
// kernel is bound by float32 operations on the pairs the data makes it scan
// (all N where a radius never fills, as with sparse uniform clouds).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRadii = 4;
constexpr int kWarps = 8;
constexpr int kTile = 1024;

struct Radii {
  int count;
  float r2[kMaxRadii];
  int k[kMaxRadii];
  int offset[kMaxRadii];
};

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ centers, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, int* __restrict__ out_idx,
                  int* __restrict__ out_cnt, int s, int n, int ktot,
                  int blocks_per_cloud, Radii radii) {
  __shared__ float tile[3 * kTile];
  __shared__ uint8_t tile_ok[kTile];
  const int b = blockIdx.x / blocks_per_cloud;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (blockIdx.x % blocks_per_cloud) * kWarps + warp;
  const bool has_row = row < s;
  const float* pts = points + static_cast<long long>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * n;

  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (has_row) {
    const float* c = centers + (static_cast<long long>(b) * s + row) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  int* idx_row = out_idx + (static_cast<long long>(b) * s + row) * ktot;
  int found[kMaxRadii];
  int first[kMaxRadii];
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    found[r] = 0;
    first[r] = 0;
  }
  bool done = !has_row;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    for (int i = threadIdx.x; i < 3 * len; i += blockDim.x) tile[i] = pts[3 * t0 + i];
    for (int i = threadIdx.x; i < len; i += blockDim.x) tile_ok[i] = ok[t0 + i];
    __syncthreads();
    for (int c0 = 0; c0 < len && !done; c0 += 32) {
      const int j = c0 + lane;
      bool live = false;
      float d2 = 0.0f;
      if (j < len) {
        live = tile_ok[j] != 0;
        const float dx = __fadd_rn(cx, -tile[3 * j]);
        const float dy = __fadd_rn(cy, -tile[3 * j + 1]);
        const float dz = __fadd_rn(cz, -tile[3 * j + 2]);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
      done = true;
#pragma unroll
      for (int r = 0; r < kMaxRadii; ++r) {
        if (r >= radii.count) break;
        const int k = radii.k[r];
        if (found[r] < k) {
          const bool hit = live && d2 < radii.r2[r];
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (mask != 0u) {
            if (found[r] == 0) first[r] = t0 + c0 + __ffs(mask) - 1;
            const int slot = found[r] + __popc(mask & ((1u << lane) - 1u));
            if (hit && slot < k) idx_row[radii.offset[r] + slot] = t0 + j;
            found[r] += __popc(mask);
          }
        }
        done = done && found[r] >= k;
      }
    }
    // Also the barrier that lets the next tile overwrite this one.
    if (__syncthreads_and(done)) break;
  }

  if (!has_row) return;
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r >= radii.count) break;
    const int k = radii.k[r];
    const int got = min(found[r], k);
    for (int slot = got + lane; slot < k; slot += 32) idx_row[radii.offset[r] + slot] = first[r];
    if (lane == 0) {
      out_cnt[(static_cast<long long>(b) * s + row) * radii.count + r] = got;
    }
  }
}

}  // namespace

// For `batch` clouds: `s` centres ((B, S, 3) float32) against `n` points
// ((B, N, 3) float32, (B, N) uint8 valid) at `n_radii` <= 4 radii. `r2[i]` is
// the squared radius as float32, `k[i]` the number of samples; the indices of
// radius i go to columns [sum(k[:i]), sum(k[:i+1])) of `out_idx`
// ((B, S, sum(k)) int32) and its count to column i of `out_cnt`
// ((B, S, n_radii) int32). Returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int ball_query_launch(const void* centers, const void* points, const void* valid,
                                 void* out_idx, void* out_cnt, int batch, int s, int n,
                                 int n_radii, const float* r2, const int* k, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_radii < 1 || n_radii > kMaxRadii || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Radii radii;
  radii.count = n_radii;
  int ktot = 0;
  for (int i = 0; i < kMaxRadii; ++i) {
    radii.r2[i] = i < n_radii ? r2[i] : 0.0f;
    radii.k[i] = i < n_radii ? k[i] : 0;
    radii.offset[i] = ktot;
    ktot += radii.k[i];
  }
  if (batch <= 0 || s <= 0 || ktot <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks_per_cloud = (s + kWarps - 1) / kWarps;
  const long long blocks = static_cast<long long>(batch) * blocks_per_cloud;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<const uint8_t*>(valid), static_cast<int*>(out_idx),
      static_cast<int*>(out_cnt), s, n, ktot, blocks_per_cloud, radii);
  return static_cast<int>(cudaGetLastError());
}
