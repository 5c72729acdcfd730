// Dense-canvas fill from ascending row ids, and its backward, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Forward. Replaces the Pallas TPU kernel `_fill_kernel`
// (lyft3d_tpu/ops/dense_fill.py:78, launched by `fill_rows_by_id_pallas`
// :94): (V, C) feature rows with ascending row ids (invalid ids forced to
// `num_rows`) → a (num_rows, C) canvas whose uncovered rows are zero and
// whose duplicate ids sum. The TPU kernel gave each grid step a 1024-row
// canvas tile, took the tile's voxel window from a searchsorted, and
// contracted a tile-local one-hot with the window on the MXU in float32. A
// GPU has no reason to build one-hots.
//
// Design (canvas-owner tiles): one block owns `tile_rows` consecutive canvas
// rows of one sample (the wrapper sizes the tile to ~32 KB of canvas) and
// writes every one of them exactly once, so the canvas needs no memset and
// no atomics, and the result is deterministic.
//   1. The block finds the window [lo, hi) of the tile's ids in the sample's
//      ascending ids by rounds of 256 parallel probes (`__syncthreads_count`
//      of the probes below the key), both ends in the same rounds: two
//      rounds up to V = 65,792, where a binary search takes 16 dependent
//      loads for each end.
//   2. The block walks the window and records, in shared memory, where each
//      row's run of ids starts and ends (start -1 for an uncovered row), so
//      that no feature load waits on an id load.
//   3. Threads own chunks of rows as wide as the row's bytes allow (16, 8, 4
//      or 2 bytes), neighbours on neighbouring chunks, so a warp stores whole
//      rows. With accesses under 16 bytes a thread loads the first row of the
//      runs of four chunks before it stores any (one load latency for four).
//      It copies a unique id's row exactly, sums a run of duplicate ids in
//      float32 and casts once (as the Pallas kernel's float32 accumulation
//      does), or stores zeros.
// A tile's feature rows are not brought in by a bulk copy: they are under a
// tenth of the bytes the fill moves at every path shape, and bulk copies
// lost to register loads on the backward's gather.
//
// Bound: the store of the canvas, b·(num_rows·c·size + 4·V) + n·c·size
// bytes, n the ids below num_rows (a masked row is read by no tile). At the Lyft pillar shape (batch 8, 496² = 246,016 rows of 64 bf16
// channels) that is 252 MB written against 26 MB of feature rows read:
// ~0.08 ms of HBM bandwidth on an H100. Tiles of 128 rows and a binary
// search left small canvases latency-bound: 8-byte rows (the sparse path's
// units, 4 × 600,000 rows) took 4.4 times `index_add_` into zeros.
//
// Backward. Replaces `_fill_pallas_bwd` (dense_fill.py:153, an XLA gather
// behind the Pallas kernel): gf[b, i, :] = g[b, ids[b, i], :], zero where the
// id is the sentinel `num_rows`; duplicate ids each receive the row. An exact
// copy. Bound: bytes, b·V·(c·size + 4) + n·c·size, n the ids below
// num_rows: every hit row read once from a cotangent of up to 252 MB, at
// random, every row written once. The first kernel
// copied a row with `lanes` threads that each waited on the row's id before
// its one 16-byte load: ~2 MB in flight on the card where ~4-5 MB are
// needed, 1 TB/s at the pillar shape. So:
//   fill_bwd_warp_kernel, for rows of a multiple of 16 bytes: a warp reads
//   32 rows' ids with one coalesced load and shares them by shuffles, and
//   each lane issues all of its 16-byte loads before any store: no load
//   waits on an id, 128 bytes a lane and 256 KB an SM are in flight. A
//   kernel that moved the rows through shared memory by `cp.async.bulk`
//   (a producer warp, an mbarrier a stage of 128 rows, one bulk store a
//   stage) was measured beside it at every path shape and lost (inferred:
//   the copy engine's rate for 128-byte copies); it is deleted.
//   dense_fill_bwd_kernel, for the other rows (8 and 20 bytes in the FHD
//   cases, unaligned tensors): `lanes` threads copy a row element by
//   element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// VEC elements loaded and stored as one access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The first positions in ids[0, n) whose ids are >= key0 and >= key1 (ids
// ascending), found by the whole block: each round probes the last id of each
// of kThreads equal parts of a key's open range and keeps the part where the
// key falls. The two keys' probes are loaded before one barrier, so their
// rounds overlap. Every thread of the block must call it; all get the same
// answer.
__device__ __forceinline__ void block_lower_bounds(const int32_t* ids, long long n, long long key0,
                                                   long long key1, long long* at0, long long* at1) {
  // ids[lo - 1] < key (or lo == 0); ids[hi] >= key (or hi == n)
  long long lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;
  while (lo0 < hi0 || lo1 < hi1) {
    const bool open0 = lo0 < hi0, open1 = lo1 < hi1;  // the same in every thread
    const long long step0 = (hi0 - lo0 + kThreads - 1) / kThreads;
    const long long step1 = (hi1 - lo1 + kThreads - 1) / kThreads;
    const long long pos0 = lo0 + (threadIdx.x + 1) * step0 - 1;
    const long long pos1 = lo1 + (threadIdx.x + 1) * step1 - 1;
    const int below0 = open0 && pos0 < hi0 && static_cast<long long>(__ldg(ids + pos0)) < key0;
    const int below1 = open1 && pos1 < hi1 && static_cast<long long>(__ldg(ids + pos1)) < key1;
    const long long parts0 = __syncthreads_count(below0);  // parts wholly below the key
    const long long parts1 = __syncthreads_count(below1);
    if (open0) {
      lo0 += parts0 * step0;
      hi0 = min(hi0, lo0 + step0 - 1);
    }
    if (open1) {
      lo1 += parts1 * step1;
      hi1 = min(hi1, lo1 + step1 - 1);
    }
  }
  *at0 = lo0;
  *at1 = lo1;
}

// grid (tiles of one sample, batch); dynamic shared memory: 2 × tile_rows ints.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dense_fill_kernel(const T* __restrict__ feats, const int32_t* __restrict__ ids,
                  T* __restrict__ out, long long v, long long num_rows, int tile_rows, int c) {
  extern __shared__ int first[];  // window offset of each row's run, or -1
  int* stop = first + tile_rows;  // window offset just past each row's run

  const long long b = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), num_rows - row0));
  const int32_t* sid = ids + b * v;

  long long lo, hi;
  block_lower_bounds(sid, v, row0, row0 + rows, &lo, &hi);
  for (int r = threadIdx.x; r < rows; r += kThreads) first[r] = -1;
  __syncthreads();
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads) {
    const int32_t id = __ldg(sid + k);
    const long long r = id - row0;  // in [0, rows) when the ids ascend
    if (r >= 0 && r < rows) {
      if (k == lo || __ldg(sid + k - 1) != id) first[r] = static_cast<int>(k - lo);
      if (k == hi - 1 || __ldg(sid + k + 1) != id) stop[r] = static_cast<int>(k + 1 - lo);
    }
  }
  __syncthreads();

  const int chunks = c / VEC;
  const int items = rows * chunks;
  const T* src = feats + (b * v) * c;
  T* dst = out + (b * num_rows + row0) * c;
  // kLoads items a thread at a time: the first row of each item's run is
  // loaded for all of them before any is summed and stored, so a warp waits
  // on one load latency for kLoads items. Four for accesses narrower than 16
  // bytes (many items a thread, stores that do not fill the memory pipe);
  // one for 16-byte accesses, whose stores do.
  constexpr int kLoads = sizeof(T) * VEC < 16 ? 4 : 1;
  for (int base = threadIdx.x; base < items; base += kThreads * kLoads) {
    Pack<T, VEC> head[kLoads];
    int row[kLoads], col[kLoads], from[kLoads], to[kLoads];  // run: [from, to)
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int item = base + u * kThreads;
      row[u] = item / chunks;
      col[u] = (item - row[u] * chunks) * VEC;
      from[u] = item < items ? first[row[u]] : -1;
#pragma unroll
      for (int i = 0; i < VEC; ++i) head[u].v[i] = from_float<T>(0.0f);
      if (from[u] >= 0) {
        to[u] = stop[row[u]];
        head[u] = *reinterpret_cast<const Pack<T, VEC>*>(src + (lo + from[u]) * c + col[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u * kThreads >= items) break;
      Pack<T, VEC> o = head[u];
      if (from[u] >= 0 && to[u] - from[u] > 1) {  // duplicate ids: sum the run in float32
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = to_float<T>(head[u].v[i]);
        for (long long k = lo + from[u] + 1; k < lo + to[u]; ++k) {
          const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(src + k * c + col[u]);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += to_float<T>(p.v[i]);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) o.v[i] = from_float<T>(acc[i]);
      }
      *reinterpret_cast<Pack<T, VEC>*>(dst + static_cast<long long>(row[u]) * c + col[u]) = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feats, const void* ids, void* out, long long batch,
                   long long v, long long num_rows, int c, int tile_rows, cudaStream_t stream) {
  if (tile_rows < 1) return cudaErrorInvalidValue;
  const long long tiles = (num_rows + tile_rows - 1) / tile_rows;
  if (tiles == 0 || batch == 0 || c == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL || batch > 65535 || v > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * static_cast<size_t>(tile_rows) * sizeof(int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dense_fill_kernel<T, VEC><<<dim3(static_cast<unsigned int>(tiles), static_cast<unsigned int>(batch)),
                              kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(ids), static_cast<T*>(out),
      v, num_rows, tile_rows, c);
  return cudaGetLastError();
}

// Backward by threads: `lanes` threads of a warp (a power of two, at most 32,
// at least the row's elements when those are fewer than 32) copy one row
// element by element, so the loads and stores of a row are contiguous and a
// narrow row does not idle most of a warp.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_fill_bwd_kernel(const T* __restrict__ g, const int32_t* __restrict__ ids,
                      T* __restrict__ gf, long long total, long long v, long long num_rows,
                      int c, int lanes) {
  const int lane = threadIdx.x % lanes;
  const int rows_per_block = kThreads / lanes;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  for (long long row = static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / lanes;
       row < total; row += stride) {
    const long long b = row / v;
    const long long id = __ldg(ids + row);
    const bool hit = id >= 0 && id < num_rows;
    const T* src = g + (b * num_rows + (hit ? id : 0)) * c;
    T* dst = gf + row * c;
    for (int i = lane; i < c; i += lanes) dst[i] = hit ? src[i] : from_float<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* ids, void* gf, long long batch, long long v,
                       long long num_rows, int c, cudaStream_t stream) {
  const long long total = batch * v;
  if (total == 0 || c == 0) return cudaSuccess;
  int lanes = 1;
  while (lanes < 32 && lanes < c) lanes *= 2;
  const long long per_block = kThreads / lanes;
  long long blocks = (total + per_block - 1) / per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the kernel strides over the rest
  dense_fill_bwd_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(ids), static_cast<T*>(gf), total, v,
      num_rows, c, lanes);
  return cudaGetLastError();
}

// Backward for rows of a multiple of 16 bytes: a warp takes 32 consecutive
// output rows of one sample, reads their ids with one load and shares them by
// shuffles; each lane then issues all of its kWarpLoads 16-byte loads (lane,
// lane + 32, ... of the rows' chunks) before its stores, so no load waits on
// an id and 128 bytes a lane are in flight.
constexpr int kWarpLoads = 8;

__global__ void __launch_bounds__(kThreads)
fill_bwd_warp_kernel(const uint4* __restrict__ g, const int32_t* __restrict__ ids,
                     uint4* __restrict__ gf, long long v, long long num_rows, int chunks) {
  const int lane = threadIdx.x % 32;
  const long long b = blockIdx.y;
  const long long row0 = (static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32) * 32;
  if (row0 >= v) return;
  const int32_t my_id = row0 + lane < v ? __ldg(ids + b * v + row0 + lane) : static_cast<int32_t>(num_rows);
  const int items = 32 * chunks;
  const uint4* src = g + b * num_rows * chunks;
  uint4* dst = gf + (b * v + row0) * chunks;
  for (int base = 0; base < items; base += 32 * kWarpLoads) {
    uint4 buf[kWarpLoads];
#pragma unroll
    for (int u = 0; u < kWarpLoads; ++u) {
      const int item = base + u * 32 + lane;
      const int r = min(item / chunks, 31);
      const int32_t id = __shfl_sync(0xffffffffu, my_id, r);
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (item < items && id >= 0 && id < num_rows) {
        buf[u] = __ldg(src + static_cast<long long>(id) * chunks + (item - r * chunks));
      }
    }
#pragma unroll
    for (int u = 0; u < kWarpLoads; ++u) {
      const int item = base + u * 32 + lane;
      if (item < items && row0 + item / chunks < v) dst[item] = buf[u];
    }
  }
}

cudaError_t launch_bwd_warp(const void* g, const void* ids, void* gf, long long batch, long long v,
                            long long num_rows, int row_bytes, cudaStream_t stream) {
  if (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gf) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = (v + kThreads - 1) / kThreads;
  if (blocks == 0 || batch == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL || batch > 65535) return cudaErrorInvalidConfiguration;
  fill_bwd_warp_kernel<<<dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(batch)),
                         kThreads, 0, stream>>>(
      static_cast<const uint4*>(g), static_cast<const int32_t*>(ids), static_cast<uint4*>(gf), v,
      num_rows, row_bytes / 16);
  return cudaGetLastError();
}

}  // namespace

// Writes the (batch, num_rows, c) canvas `out` from (batch, v, c) `feats`
// whose (batch, v) int32 `ids` ascend within each sample (ids outside
// [0, num_rows) never match a row) on `stream`, in tiles of `tile_rows`
// canvas rows. `dtype` is 0 for float32 and 1 for bfloat16; `vec` is the
// elements of one access (1, 2, 4 or, in bfloat16, 8), which must divide c
// and whose bytes must align the pointers (the wrapper picks it). Returns the
// CUDA error of the launch (0 on success).
extern "C" int dense_fill_launch(const void* feats, const void* ids, void* out,
                                 long long batch, long long v, long long num_rows, int c,
                                 int dtype, int vec, int tile_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (vec) {
      case 1: err = launch<float, 1>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      case 2: err = launch<float, 2>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      case 4: err = launch<float, 4>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      default: err = cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: err = launch<__nv_bfloat16, 1>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      case 2: err = launch<__nv_bfloat16, 2>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      case 4: err = launch<__nv_bfloat16, 4>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      case 8: err = launch<__nv_bfloat16, 8>(feats, ids, out, batch, v, num_rows, c, tile_rows, s); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Backward of the fill: writes gf (batch, v, c) from the canvas cotangent `g`
// (batch, num_rows, c) and the (batch, v) int32 `ids` the forward used; an id
// outside [0, num_rows) gives a zero row. `route`: 0 the lane kernel, 1 the
// warp kernel (which needs c·size a multiple of 16 and 16-byte aligned
// pointers). `dtype` as in dense_fill_launch. Returns the CUDA error of the
// launch (0 on success).
extern "C" int dense_fill_bwd_launch(const void* g, const void* ids, void* gf,
                                     long long batch, long long v, long long num_rows, int c,
                                     int dtype, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = dtype == 0 ? 4 : 2;
  if (dtype != 0 && dtype != 1) {
    err = cudaErrorInvalidValue;
  } else if (route == 1) {
    err = launch_bwd_warp(g, ids, gf, batch, v, num_rows, c * size, s);
  } else if (route == 0) {
    err = dtype == 0 ? launch_bwd<float>(g, ids, gf, batch, v, num_rows, c, s)
                     : launch_bwd<__nv_bfloat16>(g, ids, gf, batch, v, num_rows, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
