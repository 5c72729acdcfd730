// Dense-canvas fill from ascending row ids for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fill_kernel`
// (lyft3d_tpu/ops/dense_fill.py:78, launched by `fill_rows_by_id_pallas`
// :94): (V, C) feature rows with ascending row ids (invalid ids forced to
// `num_rows`) → a (num_rows, C) canvas whose uncovered rows are zero and
// whose duplicate ids sum. The TPU kernel gave each grid step a 1024-row
// canvas tile, took the tile's voxel window from a searchsorted, and
// contracted a tile-local one-hot with the window on the MXU in float32. A
// GPU has no reason to build one-hots.
//
// Design (canvas-owner tiles): one block owns kTile consecutive canvas rows
// of one sample and writes every one of them exactly once, so the canvas
// needs no memset and no atomics, and the result is deterministic.
//   1. Two threads binary-search the ids of the sample (V int32, 100 KB at
//      V = 25,000, L2-resident) for the window [lo, hi) of the tile's rows.
//   2. The block walks the window and records, in shared memory, the first
//      window position of each row's run of ids (-1 for an uncovered row).
//   3. Threads own 16-byte chunks of rows, neighbours on neighbouring
//      chunks of one row, so a warp stores whole rows with 16-byte vector
//      stores; each sums its row's run in float32 and casts once (duplicate
//      ids sum as the Pallas kernel's float32 accumulation does; a unique id
//      is an exact copy) or stores zeros.
//
// Bound: the store of the canvas. At the Lyft pillar shape (batch 8, 496²
// = 246,016 rows of 64 bf16 channels) that is 252 MB written against 26 MB
// of feature rows read: ~0.08 ms of HBM bandwidth on an H100 (0.15 ms in
// float32). A first version searched per thread (a 15-step dependent
// search for each of 15.7 M threads) and was latency-bound at 0.33 ms.
//
// Backward (the JAX package's `_fill_pallas_bwd`, dense_fill.py:153, is an XLA
// gather): dense_fill_bwd_kernel below, gf[i] = g[ids[i]], up to a warp a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // canvas rows per block

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements loaded and stored as one access (16 bytes on the vector path).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// First position in ids[0, n) whose id is >= key (ids ascending).
__device__ __forceinline__ long long lower_bound(const int32_t* ids, long long n, long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(__ldg(ids + mid)) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dense_fill_kernel(const T* __restrict__ feats, const int32_t* __restrict__ ids,
                  T* __restrict__ out, long long v, long long num_rows,
                  long long tiles_per_sample, int c) {
  __shared__ long long window[2];
  __shared__ int first[kTile];  // window offset of each row's run, or -1

  const long long b = blockIdx.x / tiles_per_sample;
  const long long row0 = (blockIdx.x - b * tiles_per_sample) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), num_rows - row0));
  const int32_t* sid = ids + b * v;

  if (threadIdx.x < 2) {
    window[threadIdx.x] = lower_bound(sid, v, row0 + (threadIdx.x == 0 ? 0 : rows));
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) first[r] = -1;
  __syncthreads();
  const long long lo = window[0], hi = window[1];
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads) {
    const int32_t id = __ldg(sid + k);
    const long long r = id - row0;  // in [0, rows) when the ids ascend
    if (r >= 0 && r < rows && (k == lo || __ldg(sid + k - 1) != id)) {
      first[r] = static_cast<int>(k - lo);
    }
  }
  __syncthreads();

  const int chunks = c / VEC;
  const T* src = feats + (b * v) * c;
  T* dst = out + (b * num_rows + row0) * c;
  for (int item = threadIdx.x; item < rows * chunks; item += kThreads) {
    const int r = item / chunks;
    const int col = (item - r * chunks) * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    const int f = first[r];
    if (f >= 0) {
      const int32_t id = static_cast<int32_t>(row0 + r);
      for (long long k = lo + f; k < hi && __ldg(sid + k) == id; ++k) {
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(src + k * c + col);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += to_float<T>(p.v[i]);
      }
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_float<T>(acc[i]);
    *reinterpret_cast<Pack<T, VEC>*>(dst + static_cast<long long>(r) * c + col) = o;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feats, const void* ids, void* out, long long batch,
                   long long v, long long num_rows, int c, cudaStream_t stream) {
  const long long tiles = (num_rows + kTile - 1) / kTile;
  const long long blocks = batch * tiles;
  if (blocks == 0 || c == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL || v > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dense_fill_kernel<T, VEC><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(ids), static_cast<T*>(out),
      v, num_rows, tiles, c);
  return cudaGetLastError();
}

// Backward side: gf[b, i, :] = g[b, ids[b, i], :] where the id is a canvas
// row, zeros otherwise (the sentinel `num_rows` of a masked entry). `lanes`
// threads of a warp (a power of two, at most 32, at least the row's chunks of
// VEC elements when those are fewer than 32) copy one row, so the loads and
// stores of a row are contiguous and a narrow row does not idle most of a
// warp; duplicate ids each receive the row. An exact copy.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dense_fill_bwd_kernel(const T* __restrict__ g, const int32_t* __restrict__ ids,
                      T* __restrict__ gf, long long total, long long v, long long num_rows,
                      int c, int lanes) {
  const int lane = threadIdx.x % lanes;
  const int rows_per_block = kThreads / lanes;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  const int chunks = c / VEC;
  for (long long row = static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / lanes;
       row < total; row += stride) {
    const long long b = row / v;
    const long long id = __ldg(ids + row);
    const bool hit = id >= 0 && id < num_rows;
    const T* src = g + (b * num_rows + (hit ? id : 0)) * c;
    T* dst = gf + row * c;
    for (int ch = lane; ch < chunks; ch += lanes) {
      Pack<T, VEC> p;
      if (hit) {
        p = *reinterpret_cast<const Pack<T, VEC>*>(src + ch * VEC);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) p.v[i] = from_float<T>(0.0f);
      }
      *reinterpret_cast<Pack<T, VEC>*>(dst + ch * VEC) = p;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* g, const void* ids, void* gf, long long batch, long long v,
                       long long num_rows, int c, cudaStream_t stream) {
  const long long total = batch * v;
  if (total == 0 || c == 0) return cudaSuccess;
  int lanes = 1;
  while (lanes < 32 && lanes < c / VEC) lanes *= 2;
  const long long per_block = kThreads / lanes;
  long long blocks = (total + per_block - 1) / per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the kernel strides over the rest
  dense_fill_bwd_kernel<T, VEC><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(ids), static_cast<T*>(gf), total, v,
      num_rows, c, lanes);
  return cudaGetLastError();
}

}  // namespace

// Writes the (batch, num_rows, c) canvas `out` from (batch, v, c) `feats`
// whose (batch, v) int32 `ids` ascend within each sample (ids outside
// [0, num_rows) never match a row) on `stream`. `dtype` is 0 for float32 and
// 1 for bfloat16; `vectorized` asks for 16-byte accesses, which need c·size
// to be a multiple of 16 and 16-byte aligned pointers (the wrapper checks).
// Returns the CUDA error of the launch (0 on success).
extern "C" int dense_fill_launch(const void* feats, const void* ids, void* out,
                                 long long batch, long long v, long long num_rows, int c,
                                 int dtype, int vectorized, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = vectorized ? launch<float, 4>(feats, ids, out, batch, v, num_rows, c, s)
                     : launch<float, 1>(feats, ids, out, batch, v, num_rows, c, s);
  } else if (dtype == 1) {
    err = vectorized ? launch<__nv_bfloat16, 8>(feats, ids, out, batch, v, num_rows, c, s)
                     : launch<__nv_bfloat16, 1>(feats, ids, out, batch, v, num_rows, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Backward of the fill: writes gf (batch, v, c) from the canvas cotangent `g`
// (batch, num_rows, c) and the (batch, v) int32 `ids` the forward used; an id
// outside [0, num_rows) gives a zero row. Same `dtype` and `vectorized` rules
// as dense_fill_launch. Returns the CUDA error of the launch (0 on success).
extern "C" int dense_fill_bwd_launch(const void* g, const void* ids, void* gf,
                                     long long batch, long long v, long long num_rows, int c,
                                     int dtype, int vectorized, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = vectorized ? launch_bwd<float, 4>(g, ids, gf, batch, v, num_rows, c, s)
                     : launch_bwd<float, 1>(g, ids, gf, batch, v, num_rows, c, s);
  } else if (dtype == 1) {
    err = vectorized ? launch_bwd<__nv_bfloat16, 8>(g, ids, gf, batch, v, num_rows, c, s)
                     : launch_bwd<__nv_bfloat16, 1>(g, ids, gf, batch, v, num_rows, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
