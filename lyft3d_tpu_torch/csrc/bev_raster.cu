// BEV voxel-count raster for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_raster_kernel`
// (lyft3d_tpu/ops/bev_raster.py:146, launched by `bev_rasterize_pallas`),
// which built one-hot row and column matrices per point chunk in VMEM and
// accumulated their product on the MXU into a resident (H, W*C) tile. A GPU
// has no need for that detour: the raster is a scatter of ones.
//
// Every point's cell comes from the same float32 operations, in the same
// order, as `voxel_indices` (lyft3d_tpu/ops/bev_raster.py:66-68), spelled
// with the round-to-nearest intrinsics so that no compiler contraction or
// reciprocal can move a point that lies on a bin edge (build without
// --use_fast_math), and bounded in the float domain, so that NaN and
// out-of-range values never reach an integer conversion. Counts are integers
// below 2^24 (the wrapper refuses N >= 2^24), so they are exact in float32
// and the result does not depend on the order of the additions.
//
// Bound: a Lyft sweep is N = 65,536 points (12 B each plus 1 B of mask) into
// a 336 x 336 x 3 grid of 1.35 MB per sample, 43 MB at batch 32; the least
// traffic is the points read once and the grid written once (0.021 ms at
// 3.35 TB/s).
//
// Design: one thread a point, `atomicAdd(1.0f)` into the grid. The launch
// takes the batch in chunks of `chunk` samples and zeroes each chunk's grid
// (`cudaMemsetAsync`) just before the chunk's kernel, so that the atomics
// find the lines the memset just wrote. The wrapper's rule (`_raster_chunk`
// in ops/bev_raster.py) picks the chunk from the shapes alone: at 32 x
// 336 x 336 x 3 two chunks of 16 (21.7 MB of grid each) take a quarter less
// time than one launch on a uniform sweep and 4% less on a LiDAR-like one,
// on an H100 (PERF.md §6).
//
// Not kept: a thread-block cluster of 16 CTAs a sample that counted in the
// CTAs' shared memory and stored the grid once. It tied the chunked
// launch on the uniform sweep and took 15% longer on the LiDAR-like one,
// where its remote shared-memory adds into the pixels near the sensor bound
// it, and it lost to one launch of this kernel at every batch from 1 to 32
// on that sweep.

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

// Counts of `batch` x `n` points ((B, N, stride >= 3) float32, (B, N) uint8
// valid) into the (B, h, w, c) float32 `grid`, which need not be zeroed, on
// `stream`: per chunk of `chunk` samples a memset of its grid, then the
// kernel. Returns the CUDA error of the first failed call (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int bev_raster_launch(const void* points, const void* valid, void* grid,
                                 long long batch, long long n, int stride,
                                 int h, int w, int c,
                                 float vx, float vy, float vz, float z_offset,
                                 long long chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 0 || n < 0 || n >= (1LL << 24) || chunk < 1 || stride < 3 || h < 1 || w < 1 ||
      c < 1 || chunk * n > (1LL << 40)) {  // a chunk's blocks fit the launch grid
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cells = static_cast<long long>(h) * w * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long first = 0; first < batch; first += chunk) {
    const long long samples = batch - first < chunk ? batch - first : chunk;
    float* g = static_cast<float*>(grid) + first * cells;
    err = cudaMemsetAsync(g, 0, static_cast<size_t>(samples * cells) * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = samples * n;
    if (total == 0) continue;
    const long long blocks = (total + kThreads - 1) / kThreads;
    bev_raster_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(points) + first * n * stride,
        static_cast<const uint8_t*>(valid) + first * n, g, total, n, stride, h, w, c, vx, vy, vz,
        0.5f * static_cast<float>(w), 0.5f * static_cast<float>(h), z_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
