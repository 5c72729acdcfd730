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
// Bound: bytes are negligible (13 B a point read once, 4 B a pick written),
// and so is the arithmetic (10 operations a point and step). The floor is
// latency: npoint - 1 dependent steps, each an update of every running
// distance and an argmax over the whole cloud. Two kernels, one rule
// (`_fps_launch_shape` in ops/pointnet2.py) picks between them by the batch
// and the cloud size:
//
// `fps_kernel`, one block a cloud, for many clouds (the RCNN's 400 RoI
// clouds, where 400 blocks fill the card) and for clouds of 4,096 points or
// fewer. Each thread keeps its points' x, y, z and running distance in
// registers (point i of the cloud belongs to thread i % threads, slot i /
// threads). A step reads the last pick's coordinates (one address for the
// whole block, served by the cache), updates the distances, reduces (value,
// index) in each warp with two `redux.sync`, then across warps through a
// double-buffered shared array: one __syncthreads a step.
//
// `fps_cluster_kernel`, a thread-block cluster of `ctas` CTAs a cloud on
// neighbouring SMs, for few large clouds (the SA levels' 4 x 16,384, where
// one block a cloud ran 4 of the 132 SMs). CTA r owns the points [r·chunk,
// (r+1)·chunk), chunk = 256 threads x SLOTS, in registers as above. A step:
// every thread updates its slots and keeps its best (value, index, x, y,
// z); each warp reduces (value, index) with `redux.sync` and takes the
// winner's coordinates from the lane that owns it (lane = index % 32, since
// chunks and the block are whole warps); one __syncthreads, and warp 0
// reduces the eight warps' candidates; its lanes 0..ctas-1 then write the CTA's
// candidate, coordinates included, into the shared memory of every CTA of
// the cluster with `st.async`, which counts its bytes on that CTA's
// mbarrier (`complete_tx`). So no global load sits on the dependent chain,
// and no step waits for every thread of the cluster: each CTA waits on its
// own barrier for the ctas candidates, and every warp reduces them in the
// same order to the same pick. The candidate arrays and their barriers are
// double-buffered: a CTA re-arms barrier s % 2 for step s + 2 once it has
// read step s, and no CTA can send step s + 2 before every CTA has sent step
// s + 1, which each does only after all of its warps read step s (the
// __syncthreads of step s + 1). The first valid point is found by the same
// exchange.
//
// Ties: every reduction, in both kernels, keeps the larger value and on
// equal values the lower index (`warp_best`), a total order, so the pick is
// the cloud-wide lowest index whatever the order of the reductions. The
// squared distance is ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest
// intrinsics, the order of the plain PyTorch version, so that no fused
// multiply-add can flip a near-tie: the indices must be equal, not close.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Best {
  float v;
  int i;
};

// A float's bits as an unsigned key of the same order (no -0.0 and no NaN
// reach a reduction: distances are sums of squares or the -1/-2 sentinels,
// and the first pick's values are -index).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The warp's best in every lane: the largest value, then the lowest index
// among the lanes that hold it (two `redux.sync`).
__device__ __forceinline__ Best warp_best(Best a) {
  const uint32_t key = order_key(a.v);
  const uint32_t top = __reduce_max_sync(0xffffffffu, key);
  Best r;
  r.i = static_cast<int>(__reduce_min_sync(0xffffffffu, key == top ? static_cast<uint32_t>(a.i) : 0xffffffffu));
  r.v = key_value(top);
  return r;
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
cudaError_t launch(const float* points, const uint8_t* valid, int* out, int batch, int n,
                   int npoint, int threads, cudaStream_t stream) {
  fps_kernel<SLOTS><<<batch, threads, 0, stream>>>(points, valid, out, n, npoint);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Cluster kernel.
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kCandBytes = 20;  // value, index, x, y, z

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (a shared::cta address) in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival (this thread's) and `bytes` more expected on the barrier's
// current phase.
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Writes the candidate (v, i, x, y, z) into shared memory of another CTA of
// the cluster and counts its 20 bytes on that CTA's barrier.
__device__ __forceinline__ void send(uint32_t vixy, uint32_t zaddr, uint32_t bar, float v, int i, float x,
                                     float y, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(vixy), "r"(__float_as_uint(v)), "r"(static_cast<uint32_t>(i)), "r"(__float_as_uint(x)),
         "r"(__float_as_uint(y)), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(zaddr), "r"(__float_as_uint(z)), "r"(bar) : "memory");
}

// One cloud a cluster of `cluster.num_blocks()` CTAs of kClusterThreads;
// grid.x = batch x ctas.
template <int SLOTS>
__global__ void __launch_bounds__(kClusterThreads)
fps_cluster_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                   int* __restrict__ out, int n, int npoint) {
  // Each warp's best, and each CTA's best as the cluster sent them: slot r of
  // buffer s % 2 is CTA r's candidate of step s.
  __shared__ float4 s_warp[kClusterWarps];
  __shared__ float s_warpz[kClusterWarps];
  __shared__ float4 s_cand[2][kMaxCluster];
  __shared__ float s_candz[2][kMaxCluster];
  __shared__ uint64_t s_bar[2];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / ctas;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kChunk = kClusterThreads * SLOTS;
  const int base = rank * kChunk;
  const float* pts = points + static_cast<long long>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * n;
  int* sel = out + static_cast<long long>(b) * npoint;

  float x[SLOTS], y[SLOTS], z[SLOTS], dist[SLOTS];
  // First valid point (0 when none is valid), as in fps_kernel. The
  // placeholder's coordinates are the thread's first point: lane 0 of warp 0
  // of CTA 0 holds point 0, which is what a cloud without a valid point picks.
  Best first;
  first.v = -static_cast<float>(n);
  first.i = 0;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = base + j * kClusterThreads + tid;
    x[j] = y[j] = z[j] = 0.0f;
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
        fx = x[j];
        fy = y[j];
        fz = z[j];
      }
    }
    if (j == 0 && first.v == -static_cast<float>(n)) {
      fx = x[0];
      fy = y[0];
      fz = z[0];
    }
  }

  // Barrier s % 2 completes when the ctas candidates of step s have landed;
  // armed for step s + 2 as soon as step s is read. Every CTA's barriers are
  // initialised and armed before anyone sends.
  const uint32_t cand_bytes = static_cast<uint32_t>(ctas * kCandBytes);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&s_bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(&s_bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm(&s_bar[0], cand_bytes);
    arm(&s_bar[1], cand_bytes);
  }
  uint32_t to_vixy[2], to_z[2], to_bar[2];
  if (lane < ctas) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      to_vixy[k] = map_rank(smem_u32(&s_cand[k][rank]), lane);
      to_z[k] = map_rank(smem_u32(&s_candz[k][rank]), lane);
      to_bar[k] = map_rank(smem_u32(&s_bar[k]), lane);
    }
  }
  cluster_sync();

  float px, py, pz;
  // The cluster-wide best of every thread's (mine, mx, my, mz) at step s:
  // its index, and its coordinates in px, py, pz, identical in every thread.
  auto cluster_best = [&](int s, Best mine, float mx, float my, float mz) -> int {
    const int k = s & 1;
    // Warp, then CTA: the winner's coordinates come from the lane (index %
    // 32) and then the warp that owns it.
    mine = warp_best(mine);
    const int owner = mine.i & 31;
    const float wx = __shfl_sync(0xffffffffu, mx, owner);
    const float wy = __shfl_sync(0xffffffffu, my, owner);
    const float wz = __shfl_sync(0xffffffffu, mz, owner);
    if (lane == 0) {
      s_warp[warp] = make_float4(mine.v, __int_as_float(mine.i), wx, wy);
      s_warpz[warp] = wz;
    }
    __syncthreads();
    if (warp == 0) {
      const float4 c =
          lane < kClusterWarps ? s_warp[lane] : make_float4(-3.0e38f, __int_as_float(0x7fffffff), 0.f, 0.f);
      Best r;
      r.v = c.x;
      r.i = __float_as_int(c.y);
      r = warp_best(r);
      const int from = (r.i >= base && r.i < base + kChunk) ? ((r.i - base) % kClusterThreads) >> 5 : 0;
      const float cx = __shfl_sync(0xffffffffu, c.z, from);
      const float cy = __shfl_sync(0xffffffffu, c.w, from);
      const float cz = __shfl_sync(0xffffffffu, lane < kClusterWarps ? s_warpz[lane] : 0.f, from);
      if (lane < ctas) {
        send(k ? to_vixy[1] : to_vixy[0], k ? to_z[1] : to_z[0], k ? to_bar[1] : to_bar[0], r.v, r.i, cx, cy,
             cz);
      }
    }
    wait_phase(&s_bar[k], static_cast<uint32_t>((s >> 1) & 1));
    const float4 c = lane < ctas ? s_cand[k][lane] : make_float4(-3.0e38f, __int_as_float(0x7fffffff), 0.f, 0.f);
    const float cz = lane < ctas ? s_candz[k][lane] : 0.f;
    Best r;
    r.v = c.x;
    r.i = __float_as_int(c.y);
    r = warp_best(r);
    // The winner is a real point (n >= 1), sent by the CTA that owns it.
    const int from = r.i / kChunk;
    px = __shfl_sync(0xffffffffu, c.z, from);
    py = __shfl_sync(0xffffffffu, c.w, from);
    pz = __shfl_sync(0xffffffffu, cz, from);
    if (tid == 0) arm(&s_bar[k], cand_bytes);
    return r.i;
  };

  int last = cluster_best(0, first, fx, fy, fz);
  if (rank == 0 && tid == 0) sel[0] = last;
  for (int s = 1; s < npoint; ++s) {
    Best mine;
    mine.v = -2.0f;
    mine.i = 0x7fffffff;
    float mx = 0.0f, my = 0.0f, mz = 0.0f;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const float dx = __fadd_rn(x[j], -px);
      const float dy = __fadd_rn(y[j], -py);
      const float dz = __fadd_rn(z[j], -pz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d2);
      // Slots ascend in index, so a strict > keeps the lowest index.
      if (dist[j] > mine.v) {
        mine.v = dist[j];
        mine.i = base + j * kClusterThreads + tid;
        mx = x[j];
        my = y[j];
        mz = z[j];
      }
    }
    last = cluster_best(s, mine, mx, my, mz);
    if (rank == 0 && tid == 0) sel[s] = last;
  }
  // No CTA leaves while another may still write into its shared memory.
  cluster_sync();
}

template <int SLOTS>
cudaError_t launch_cluster(const float* points, const uint8_t* valid, int* out, int batch,
                           int n, int npoint, int ctas, cudaStream_t stream) {
  auto kernel = fps_cluster_kernel<SLOTS>;
  if (ctas > 8) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(batch) * ctas);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, points, valid, out, n, npoint);
}

template <int SLOTS>
cudaError_t max_active_clusters(int ctas, int* count) {
  auto kernel = fps_cluster_kernel<SLOTS>;
  if (ctas > 8) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kClusterThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, kernel, &config);
}

#define FPS_SLOTS(X) X(1) X(2) X(4) X(8) X(16) X(32)

}  // namespace

// Samples `npoint` indices from each of `batch` clouds of `n` points
// ((B, N, 3) float32, (B, N) uint8 valid) into `out` ((B, npoint) int32) on
// `stream`. `ctas` 1: one block of `threads` (a multiple of 32 up to 1024)
// a cloud, `slots` a power of two up to 64. `ctas` 2 to 16: a cluster of
// `ctas` CTAs a cloud, `threads` must be 256 and `slots` a power of two up
// to 32. In both, ctas * threads * slots >= n. Returns the CUDA error of the
// launch (0 on success; a cluster the card refuses is an error, there is no
// other route), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int fps_launch(const void* points, const void* valid, void* out,
                          int batch, int n, int npoint, int ctas, int threads, int slots,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || npoint <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || ctas < 1 || ctas > kMaxCluster || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || static_cast<long long>(ctas) * threads * slots < n ||
      (ctas > 1 && threads != kClusterThreads) ||
      static_cast<long long>(batch) * ctas > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(points);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas > 1) {
    switch (slots) {
#define CASE(S) case S: return static_cast<int>(launch_cluster<S>(p, v, o, batch, n, npoint, ctas, s));
      FPS_SLOTS(CASE)
#undef CASE
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (slots) {
#define CASE(S) case S: return static_cast<int>(launch<S>(p, v, o, batch, n, npoint, threads, s));
    FPS_SLOTS(CASE)
    CASE(64)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of `ctas` CTAs of the cluster kernel with `slots` slots
// the card keeps resident at once, into `count`. Returns the CUDA error.
extern "C" int fps_max_active_clusters(int ctas, int slots, int device, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ctas < 2 || ctas > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  switch (slots) {
#define CASE(S) case S: return static_cast<int>(max_active_clusters<S>(ctas, count));
    FPS_SLOTS(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
