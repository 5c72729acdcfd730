// Id-matched 9-offset stencil conv over column / z-slab unit rows for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_stencil_kernel`
// (lyft3d_tpu/ops/column_sparse.py:507, launched by `_stencil_pallas_flat`
// :598 behind `stencil_conv_batched` :711):
//   out[b, q, c·N:(c+1)·N] = Σ_{j<9} src[b, pos(qids[b, j, q])][c·kzp:(c+1)·kzp] @ wc[j]
// where pos(id) is the position of `id` in the sample's ascending `src_ids`
// and an absent id (−1, or no equal entry) contributes zeros. Inputs in
// float32 or bfloat16, output float32, float32 accumulation. The TPU kernel
// streamed three dy-band windows of the source into VMEM and selected rows
// with one-hot matmuls because a TPU gathers rows slowly; a GPU reads a row
// by its address, so the windows, their alignment rules and the coverage
// fallback have no counterpart here.
//
// Design: one block owns a tile of kRows queries, one chunk c and up to
// 4·NCG output columns. For each offset j every query of the tile finds its
// source row with a binary search over the sample's ids (L2-resident: 300 KB
// at 75,000 units); rows are gathered by address into shared memory kChunk
// lanes at a time (converted to float32) beside the matching slice of wc[j],
// and every thread accumulates an RM x 4 register tile with fused
// multiply-adds. Threads whose RM queries all miss at this offset skip the
// arithmetic; a block with no hit skips the offset (most off-centre
// neighbours of a sparse cloud are absent). The (9, Vq, kzp) gather never
// exists in device memory.
//
// Bound: operations. The band weights are about two thirds zeros and the
// kernel multiplies them; the real work is 27 taps, 2·27·z_out·Cin·Cout
// operations a query with all neighbours present, against src rows read once
// and the output written once.
//
// Backward (the JAX package's `_stencil_bwd`, column_sparse.py:742):
//   d_src  the same stencil launched a second time, as the JAX backward does
//          (column_sparse.py:773): the cotangent rows are the source, the
//          reverse queries pick them, the band weights are transposed and the
//          output width is kzp, taken in several column tiles where kzp > 128.
//          It is this file's stencil_conv_kernel; the wrapper prepares the
//          arguments.
//   d_wc[j] = Σ_{b,q,c} src[b, pos(qids[b, j, q])][chunk c]ᵀ g[b, q][chunk c]
//          stencil_wgrad_kernel: each block finds the source rows of its
//          queries with find_id, compacts the hits and runs the shared
//          outer-product tile of wgrad_tile.cuh, ending in float32 atomicAdds
//          into a zeroed (9, kzp, N) buffer; the sum order varies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgrad_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // source lanes staged at a time
constexpr int kOffsets = 9;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Position of `id` in ids[0, n) (ascending), or −1.
__device__ __forceinline__ int find_id(const int32_t* ids, int n, int32_t id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < id) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < n && __ldg(ids + lo) == id) ? lo : -1;
}

// NCG column groups of 4 columns; 256 / NCG row groups of RM queries.
template <typename T, int NCG, int RM>
__global__ void __launch_bounds__(kThreads)
stencil_conv_kernel(const T* __restrict__ src, const int32_t* __restrict__ qids,
                    const int32_t* __restrict__ src_ids, const T* __restrict__ wc,
                    float* __restrict__ out, int vs, int vq, int nc, int kzp, int n,
                    int col_tiles) {
  constexpr int kRowGroups = kThreads / NCG;
  constexpr int kRows = kRowGroups * RM;
  constexpr int kCols = NCG * 4;
  __shared__ float rows_s[kRows][kChunk + 1];
  __shared__ __align__(16) float w_s[kChunk][kCols];
  __shared__ int pos_s[kRows];
  __shared__ int group_any[kRowGroups];
  __shared__ int block_any;

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int chunk = blockIdx.y / col_tiles;
  const int col0 = (blockIdx.y - chunk * col_tiles) * kCols;
  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int rg = tid / NCG;
  const bool computes = rg < kRowGroups;

  const long long width = static_cast<long long>(nc) * kzp;
  const T* s = src + static_cast<long long>(b) * vs * width + static_cast<long long>(chunk) * kzp;
  const int32_t* ids = src_ids + static_cast<long long>(b) * vs;
  const int32_t* qb = qids + static_cast<long long>(b) * kOffsets * vq;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;

  for (int j = 0; j < kOffsets; ++j) {
    __syncthreads();  // the previous offset's reads of pos_s and the flags are done
    if (tid == 0) block_any = 0;
    for (int g = tid; g < kRowGroups; g += kThreads) group_any[g] = 0;
    __syncthreads();
    for (int r = tid; r < kRows; r += kThreads) {
      const int q = row0 + r;
      int pos = -1;
      if (q < vq) {
        const int32_t id = qb[static_cast<long long>(j) * vq + q];
        if (id >= 0) pos = find_id(ids, vs, id);
      }
      pos_s[r] = pos;
      if (pos >= 0) {
        group_any[r / RM] = 1;
        block_any = 1;
      }
    }
    __syncthreads();
    if (!block_any) continue;
    const bool mine = computes && group_any[rg] != 0;
    const T* wj = wc + static_cast<long long>(j) * kzp * n;

    for (int k0 = 0; k0 < kzp; k0 += kChunk) {
      const int kw = min(kChunk, kzp - k0);
      for (int item = tid; item < kRows * kChunk; item += kThreads) {
        const int r = item / kChunk;
        const int lane = item - r * kChunk;
        const int pos = pos_s[r];
        float v = 0.0f;
        if (pos >= 0 && lane < kw) v = to_float<T>(s[static_cast<long long>(pos) * width + k0 + lane]);
        rows_s[r][lane] = v;
      }
      for (int item = tid; item < kChunk * kCols; item += kThreads) {
        const int lane = item / kCols;
        const int col = item - lane * kCols;
        float v = 0.0f;
        if (lane < kw && col0 + col < n) {
          v = to_float<T>(wj[static_cast<long long>(k0 + lane) * n + col0 + col]);
        }
        w_s[lane][col] = v;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 4
        for (int lane = 0; lane < kChunk; ++lane) {
          const float4 w4 = *reinterpret_cast<const float4*>(&w_s[lane][cg * 4]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float a = rows_s[rg * RM + i][lane];
            acc[i][0] = fmaf(a, w4.x, acc[i][0]);
            acc[i][1] = fmaf(a, w4.y, acc[i][1]);
            acc[i][2] = fmaf(a, w4.z, acc[i][2]);
            acc[i][3] = fmaf(a, w4.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }

  if (!computes) return;
  const long long out_width = static_cast<long long>(nc) * n;
  float* o = out + static_cast<long long>(b) * vq * out_width + static_cast<long long>(chunk) * n;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int q = row0 + rg * RM + i;
    if (q >= vq) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = col0 + cg * 4 + m;
      if (col < n) o[static_cast<long long>(q) * out_width + col] = acc[i][m];
    }
  }
}

template <typename T, int NCG, int RM>
cudaError_t launch_tile(const void* src, const void* qids, const void* src_ids, const void* wc,
                        void* out, int batch, int vs, int vq, int nc, int kzp, int n,
                        cudaStream_t stream) {
  constexpr int kRows = (kThreads / NCG) * RM;
  constexpr int kCols = NCG * 4;
  const int col_tiles = (n + kCols - 1) / kCols;
  if (static_cast<long long>(col_tiles) * nc > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((vq + kRows - 1) / kRows, col_tiles * nc, batch);
  stencil_conv_kernel<T, NCG, RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const int32_t*>(qids),
      static_cast<const int32_t*>(src_ids), static_cast<const T*>(wc),
      static_cast<float*>(out), vs, vq, nc, kzp, n, col_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* src, const void* qids, const void* src_ids, const void* wc,
                   void* out, int batch, int vs, int vq, int nc, int kzp, int n,
                   cudaStream_t stream) {
  if (batch == 0 || vq == 0 || n == 0 || nc == 0) return cudaSuccess;
  if (batch > 65535) return cudaErrorInvalidConfiguration;
  // The smallest column tile that takes all n columns in one pass, so that a
  // query's rows are gathered once: 16, 32, 64, 68 (the strided layers' 64 +
  // mask channel widths) or 128 columns; wider outputs take several tiles.
  if (n <= 16) return launch_tile<T, 4, 4>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  if (n <= 32) return launch_tile<T, 8, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  if (n <= 64) return launch_tile<T, 16, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  if (n <= 68) return launch_tile<T, 17, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  return launch_tile<T, 32, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
}

// One block: one tile of wgrad::kQueries queries, one offset j, one
// (kWgK x kWgN) tile of d_wc[j], one sample; it loops over the nc chunks.
template <typename T>
__global__ void __launch_bounds__(wgrad::kThreads)
stencil_wgrad_kernel(const T* __restrict__ src, const int32_t* __restrict__ qids,
                     const int32_t* __restrict__ src_ids, const float* __restrict__ g,
                     float* __restrict__ dwc, int vs, int vq, int nc, int kzp, int n,
                     int k_tiles, int n_tiles) {
  __shared__ int hit_row[wgrad::kQueries];
  __shared__ int hit_q[wgrad::kQueries];
  __shared__ int count;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * wgrad::kQueries;
  int y = blockIdx.y;
  const int nt = y % n_tiles;
  y /= n_tiles;
  const int kt = y % k_tiles;
  const int j = y / k_tiles;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int32_t* ids = src_ids + static_cast<long long>(b) * vs;
  const int32_t* qj = qids + (static_cast<long long>(b) * kOffsets + j) * vq;
  for (int r = threadIdx.x; r < wgrad::kQueries; r += wgrad::kThreads) {
    const int q = q0 + r;
    if (q >= vq) continue;
    const int32_t id = qj[q];
    if (id < 0) continue;
    const int pos = find_id(ids, vs, id);
    if (pos >= 0) wgrad::push_hit(hit_row, hit_q, &count, pos, q);
  }
  __syncthreads();
  const int nhits = count;
  if (nhits == 0) return;
  const int k0 = kt * wgrad::kWgK;
  const int n0 = nt * wgrad::kWgN;
  const long long a_stride = static_cast<long long>(nc) * kzp;
  const long long g_stride = static_cast<long long>(nc) * n;
  const T* a = src + static_cast<long long>(b) * vs * a_stride;
  const float* gb = g + static_cast<long long>(b) * vq * g_stride;
  for (int chunk = 0; chunk < nc; ++chunk) {
    wgrad::accumulate_tile<T, float>(
        a + static_cast<long long>(chunk) * kzp, a_stride, gb + static_cast<long long>(chunk) * n,
        g_stride, hit_row, hit_q, nhits, k0, min(wgrad::kWgK, kzp - k0), n0,
        min(wgrad::kWgN, n - n0), dwc + static_cast<long long>(j) * kzp * n, n);
  }
}

template <typename T>
cudaError_t launch_wgrad(const void* src, const void* qids, const void* src_ids, const void* g,
                         void* dwc, int batch, int vs, int vq, int nc, int kzp, int n,
                         cudaStream_t stream) {
  if (batch == 0 || vq == 0 || n == 0 || nc == 0 || kzp == 0) return cudaSuccess;
  const int k_tiles = (kzp + wgrad::kWgK - 1) / wgrad::kWgK;
  const int n_tiles = (n + wgrad::kWgN - 1) / wgrad::kWgN;
  const long long gy = static_cast<long long>(kOffsets) * k_tiles * n_tiles;
  if (batch > 65535 || gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((vq + wgrad::kQueries - 1) / wgrad::kQueries, static_cast<unsigned int>(gy), batch);
  stencil_wgrad_kernel<T><<<grid, wgrad::kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const int32_t*>(qids),
      static_cast<const int32_t*>(src_ids), static_cast<const float*>(g),
      static_cast<float*>(dwc), vs, vq, nc, kzp, n, k_tiles, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// out (batch, vq, nc·n) float32 from src (batch, vs, nc·kzp), qids
// (batch, 9, vq) int32 (−1 absent), src_ids (batch, vs) int32 ascending and
// wc (9, kzp, n) on `stream`. `dtype` is 0 for float32 and 1 for bfloat16
// (src and wc alike). All tensors contiguous. Returns the CUDA error of the
// launch (0 on success).
extern "C" int stencil_conv_launch(const void* src, const void* qids, const void* src_ids,
                                   const void* wc, void* out, int batch, int vs, int vq, int nc,
                                   int kzp, int n, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dwc (9, kzp, n) float32, zeroed by the caller, += Σ over samples, queries and
// chunks of src[pos(qids)]ᵀ g, with src (batch, vs, nc·kzp) in the type
// `dtype` names and the cotangent g (batch, vq, nc·n) float32. Returns the
// CUDA error of the launch (0 on success).
extern "C" int stencil_wgrad_launch(const void* src, const void* qids, const void* src_ids,
                                    const void* g, void* dwc, int batch, int vs, int vq, int nc,
                                    int kzp, int n, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_wgrad<float>(src, qids, src_ids, g, dwc, batch, vs, vq, nc, kzp, n, s);
  } else if (dtype == 1) {
    err = launch_wgrad<__nv_bfloat16>(src, qids, src_ids, g, dwc, batch, vs, vq, nc, kzp, n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
