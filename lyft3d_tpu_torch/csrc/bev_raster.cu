// BEV voxel-count raster for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_raster_kernel`
// (lyft3d_tpu/ops/bev_raster.py:146, launched by `bev_rasterize_pallas`),
// which built one-hot row and column matrices per point chunk in VMEM and
// accumulated their product on the MXU into a resident (H, W*C) tile. A GPU
// has no need for that detour: the raster is a scatter of ones.
//
// Design: one thread per point of a (B, N, stride >= 3) float32 buffer with a
// (B, N) uint8 valid mask. Each thread computes its voxel index with the same
// float32 operations, in the same order, as `voxel_indices`
// (lyft3d_tpu/ops/bev_raster.py:66-68), spelled with the round-to-nearest
// intrinsics so that no compiler contraction or reciprocal can move a point
// that lies on a bin edge (build without --use_fast_math), then adds 1.0f to
// a zeroed (B, H, W, C) float32 grid in device memory with atomicAdd. Counts
// are integers below 2^24, so the float sums are exact in any order and the
// result is deterministic.
//
// Bound: a Lyft sweep is N = 65,536 points (12 B each plus 1 B of mask) into
// a 336 x 336 x 3 grid of 1.35 MB per sample, 43 MB at batch 32. The work is
// N atomics per sample, latency bound on the L2 rather than on HBM bandwidth.
// Privatising the grid per block in shared memory does not fit (227 KB per
// block against 1.35 MB per sample), so this kernel uses global atomics,
// whose target lines stay resident in the 50 MB L2. Binning points by row
// tile so that a block owns a slab of the grid in shared memory is left to a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void bev_raster_kernel(const float* __restrict__ points,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ grid,
                                  long long total, long long n, int stride,
                                  int h, int w, int c,
                                  float vx, float vy, float vz,
                                  float half_w, float half_h, float z_offset) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total || !valid[i]) return;
  const float* p = points + i * stride;
  // floor(x / vx + w / 2), floor(y / vy + h / 2), floor((z - z_offset) / vz)
  const float fc = floorf(__fadd_rn(__fdiv_rn(p[0], vx), half_w));
  const float fr = floorf(__fadd_rn(__fdiv_rn(p[1], vy), half_h));
  const float fz = floorf(__fdiv_rn(__fadd_rn(p[2], -z_offset), vz));
  // Bounds in the float domain: NaN and out-of-range values never reach an
  // integer conversion.
  if (!(fc >= 0.0f && fc < static_cast<float>(w) &&
        fr >= 0.0f && fr < static_cast<float>(h) &&
        fz >= 0.0f && fz < static_cast<float>(c))) {
    return;
  }
  const long long b = i / n;
  const long long cell =
      ((b * h + static_cast<int>(fr)) * w + static_cast<int>(fc)) * c + static_cast<int>(fz);
  atomicAdd(grid + cell, 1.0f);
}

}  // namespace

// Adds the counts of `batch` x `n` points into `grid` (zeroed by the caller)
// on `stream`. Returns the CUDA error of the launch (0 on success).
extern "C" int bev_raster_launch(const void* points, const void* valid, void* grid,
                                 long long batch, long long n, int stride,
                                 int h, int w, int c,
                                 float vx, float vy, float vz, float z_offset,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = batch * n;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    bev_raster_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
        static_cast<float*>(grid), total, n, stride, h, w, c, vx, vy, vz,
        0.5f * static_cast<float>(w), 0.5f * static_cast<float>(h), z_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
