// Points-in-rotated-box selection for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_roi_kernel` with `_extract_min_k`
// (lyft3d_tpu/ops/select_kernel.py:127 and :53, launched by `_run` :164 for
// `roi_inside_select_fused`) together with its `_postprocess_first_k` (:196).
// What it computes: for every box, the first k valid point indices inside the
// enlarged rotated box, in index order, and their count; slots past the count
// repeat the first hit, a box without a point is all 0, the count is clipped
// to k. A point is inside when |lx| <= hl, |ly| <= hw and |dz| <= hh with
// lx = c*dx + s*dy, ly = -s*dx + c*dy in the box frame.
//
// The TPU kernel held a (rows, N) key tile in VMEM and pulled k minima out of
// it with k masked full-tile passes (k = 512 here). A GPU scans instead: one
// warp owns one box and walks the cloud in index order, 32 points at a time;
// __ballot_sync and __popc hand the hits their output slots in index order,
// and the warp stops once it has k. The block's warps share the points
// through shared-memory tiles.
//
// Each box arrives as eight float32 numbers (cx, cy, cz, hl, hw, hh, cos,
// sin) that the wrapper computed in PyTorch, so that the kernel and the plain
// version test the same numbers; products and sums are spelled with the
// round-to-nearest intrinsics in the plain version's order, so that no fused
// multiply-add moves a point across a face: the indices must be equal.
//
// Bound: bytes are small (13 B a point, 32 B a box, 4 B an output slot); the
// work is about 13 float32 operations for every scanned (box, point) pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kWarps * 32)
roi_select_kernel(const float* __restrict__ boxes, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, int* __restrict__ out_idx,
                  int* __restrict__ out_cnt, int r, int n, int k, int blocks_per_cloud) {
  __shared__ float tile[3 * kTile];
  __shared__ uint8_t tile_ok[kTile];
  const int b = blockIdx.x / blocks_per_cloud;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (blockIdx.x % blocks_per_cloud) * kWarps + warp;
  const bool has_row = row < r;
  const float* pts = points + static_cast<long long>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * n;

  float cx = 0.0f, cy = 0.0f, cz = 0.0f, hl = 0.0f, hw = 0.0f, hh = 0.0f, c = 0.0f, s = 0.0f;
  if (has_row) {
    const float* box = boxes + (static_cast<long long>(b) * r + row) * 8;
    cx = box[0];
    cy = box[1];
    cz = box[2];
    hl = box[3];
    hw = box[4];
    hh = box[5];
    c = box[6];
    s = box[7];
  }
  int* idx_row = out_idx + (static_cast<long long>(b) * r + row) * k;
  int found = 0;
  int first = 0;
  bool done = !has_row || k <= 0;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    for (int i = threadIdx.x; i < 3 * len; i += blockDim.x) tile[i] = pts[3 * t0 + i];
    for (int i = threadIdx.x; i < len; i += blockDim.x) tile_ok[i] = ok[t0 + i];
    __syncthreads();
    for (int c0 = 0; c0 < len && !done; c0 += 32) {
      const int j = c0 + lane;
      bool hit = false;
      if (j < len && tile_ok[j] != 0) {
        const float dx = __fadd_rn(tile[3 * j], -cx);
        const float dy = __fadd_rn(tile[3 * j + 1], -cy);
        const float dz = __fadd_rn(tile[3 * j + 2], -cz);
        const float lx = __fadd_rn(__fmul_rn(c, dx), __fmul_rn(s, dy));
        const float ly = __fadd_rn(__fmul_rn(-s, dx), __fmul_rn(c, dy));
        hit = fabsf(lx) <= hl && fabsf(ly) <= hw && fabsf(dz) <= hh;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask != 0u) {
        if (found == 0) first = t0 + c0 + __ffs(mask) - 1;
        const int slot = found + __popc(mask & ((1u << lane) - 1u));
        if (hit && slot < k) idx_row[slot] = t0 + j;
        found += __popc(mask);
        done = found >= k;
      }
    }
    // Also the barrier that lets the next tile overwrite this one.
    if (__syncthreads_and(done)) break;
  }

  if (!has_row) return;
  const int got = min(found, k);
  for (int slot = got + lane; slot < k; slot += 32) idx_row[slot] = first;
  if (lane == 0) out_cnt[static_cast<long long>(b) * r + row] = got;
}

}  // namespace

// For `batch` clouds: the first `k` of `n` points ((B, N, 3) float32, (B, N)
// uint8 valid) inside each of `r` boxes ((B, R, 8) float32: centre, half
// sizes along the box's x, y and z, cos and sin of its yaw), into `out_idx`
// ((B, R, k) int32) and `out_cnt` ((B, R) int32). Returns the CUDA error of
// the launch (0 on success).
extern "C" int roi_select_launch(const void* boxes, const void* points, const void* valid,
                                 void* out_idx, void* out_cnt, int batch, int r, int n, int k,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || r <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks_per_cloud = (r + kWarps - 1) / kWarps;
  const long long blocks = static_cast<long long>(batch) * blocks_per_cloud;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  roi_select_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(points),
      static_cast<const uint8_t*>(valid), static_cast<int*>(out_idx),
      static_cast<int*>(out_cnt), r, n, k, blocks_per_cloud);
  return static_cast<int>(cudaGetLastError());
}
