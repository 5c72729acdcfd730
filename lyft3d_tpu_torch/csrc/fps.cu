// Furthest-point sampling for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fps_kernel`
// (lyft3d_tpu/ops/pointnet2.py:112, launched by `fps_pallas`), which packed
// the cloud into (8, C) vector-register planes and kept the running
// min-distance buffer in VMEM across the selection loop. What it computes:
// start at the first valid point; npoint - 1 times, lower every point's
// running distance to min(dist, valid ? |p - last|^2 : -1) and pick the
// argmax, lowest index on equal values. Initial distances are 1e10 for valid
// points and -1 for invalid ones, so a cloud with fewer valid points than
// npoint repeats an argmax.
//
// Design: the loop is sequential, so one block owns one cloud (grid = B) and
// everything the loop touches stays on the SM. Each thread keeps its points'
// x, y, z and running distance in registers (point i of the cloud belongs to
// thread i % threads, slot i / threads: 16 slots a thread at 16,384 points
// and 1,024 threads; the 256 KB of coordinates and distances would not fit
// the 227 KB of shared memory). A step reads the last pick's coordinates
// (one address for the whole block, served by the cache), updates the
// distances, reduces (value, index) with warp shuffles, then across warps
// through a double-buffered shared array: one __syncthreads a step.
//
// The squared distance is ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest
// intrinsics, the order of the plain PyTorch version, so that no fused
// multiply-add can flip a near-tie: the indices must be equal, not close.
//
// Bound: bytes are negligible (13 B a point read once, 4 B a pick written).
// The floor is latency: npoint - 1 dependent steps, each a broadcast load,
// a few slots of arithmetic and a block-wide reduction. With a batch of 4
// only 4 of the 132 SMs work; splitting one cloud over a thread block
// cluster is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  // Larger value wins; on equal values the lower index.
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
  }
  return a;
}

// 1,024 threads leave 64 registers a thread: at 16 slots the compiler spills
// a few of the 64 coordinate and distance values to local memory (L1).
template <int SLOTS>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
           int* __restrict__ out, int n, int npoint) {
  __shared__ float s_v[2][32];
  __shared__ int s_i[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = threads >> 5;
  const float* pts = points + static_cast<long long>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * n;
  int* sel = out + static_cast<long long>(b) * npoint;

  float x[SLOTS], y[SLOTS], z[SLOTS], dist[SLOTS];
  // First valid point (0 when none is valid): a min-reduction of indices,
  // spelled as a max of (-index) so that it shares the reduction below.
  Best first;
  first.v = -static_cast<float>(n);
  first.i = 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = tid + j * threads;
    x[j] = y[j] = z[j] = 0.0f;
    // A slot past the end of the cloud holds -2 and never wins; an invalid
    // point holds -1, and min(-1, d2) keeps it there since d2 >= 0.
    dist[j] = -2.0f;
    if (i < n) {
      x[j] = pts[3 * i];
      y[j] = pts[3 * i + 1];
      z[j] = pts[3 * i + 2];
      const bool live = ok[i] != 0;
      dist[j] = live ? 1e10f : -1.0f;
      if (live && -static_cast<float>(i) > first.v) {
        first.v = -static_cast<float>(i);
        first.i = i;
      }
    }
  }

  int buf = 0;
  auto block_best = [&](Best mine) -> Best {
    mine = warp_best(mine);
    if (nwarps == 1) return mine;
    if (lane == 0) {
      s_v[buf][warp] = mine.v;
      s_i[buf][warp] = mine.i;
    }
    __syncthreads();
    Best r;
    r.v = lane < nwarps ? s_v[buf][lane] : -3.0e38f;
    r.i = lane < nwarps ? s_i[buf][lane] : 0x7fffffff;
    buf ^= 1;
    return warp_best(r);
  };

  int last = block_best(first).i;
  if (tid == 0) sel[0] = last;
  for (int s = 1; s < npoint; ++s) {
    const float px = __ldg(pts + 3 * last);
    const float py = __ldg(pts + 3 * last + 1);
    const float pz = __ldg(pts + 3 * last + 2);
    Best mine;
    mine.v = -2.0f;
    mine.i = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int i = tid + j * threads;
      const float dx = __fadd_rn(x[j], -px);
      const float dy = __fadd_rn(y[j], -py);
      const float dz = __fadd_rn(z[j], -pz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d2);
      // Slots ascend in index, so a strict > keeps the lowest index.
      if (dist[j] > mine.v) {
        mine.v = dist[j];
        mine.i = i;
      }
    }
    last = block_best(mine).i;
    if (tid == 0) sel[s] = last;
  }
}

template <int SLOTS>
void launch(const float* points, const uint8_t* valid, int* out, int batch,
            int n, int npoint, int threads, cudaStream_t stream) {
  fps_kernel<SLOTS><<<batch, threads, 0, stream>>>(points, valid, out, n, npoint);
}

}  // namespace

// Samples `npoint` indices from each of `batch` clouds of `n` points
// ((B, N, 3) float32, (B, N) uint8 valid) into `out` ((B, npoint) int32) on
// `stream`. `threads` is a multiple of 32 up to 1024 and `slots` a power of
// two up to 64 with threads * slots >= n. Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int fps_launch(const void* points, const void* valid, void* out,
                          int batch, int n, int npoint, int threads, int slots,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || npoint <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      static_cast<long long>(threads) * slots < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(points);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1: launch<1>(p, v, o, batch, n, npoint, threads, s); break;
    case 2: launch<2>(p, v, o, batch, n, npoint, threads, s); break;
    case 4: launch<4>(p, v, o, batch, n, npoint, threads, s); break;
    case 8: launch<8>(p, v, o, batch, n, npoint, threads, s); break;
    case 16: launch<16>(p, v, o, batch, n, npoint, threads, s); break;
    case 32: launch<32>(p, v, o, batch, n, npoint, threads, s); break;
    case 64: launch<64>(p, v, o, batch, n, npoint, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
