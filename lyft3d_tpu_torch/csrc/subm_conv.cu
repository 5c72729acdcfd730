// Rank gather + 27-tap contraction of a sparse 3D conv for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_kernel`
// (lyft3d_tpu/ops/subm_conv_kernel.py:42, launched by `subm_conv_pallas`
// :62): out[b, q] = Σ_k f[b, ranks[b, k, q]] @ W[k], rank −1 gives zeros,
// float32 accumulation, output in the features' type. The TPU kernel kept
// the whole feature table in VMEM so that the (K, V, C) neighbour tensor
// never reached HBM. Here the table (7.7 MB at 60,000 x 64 bf16) stays in
// L2, and the neighbour rows exist only as a shared-memory tile.
//
// Design: one block owns a tile of kRows output rows and up to 4·NCG output
// columns. For each of the K offsets it loads the tile's ranks, gathers the
// rows by address into shared memory kChunk channels at a time (converted
// to float32), stages the matching slice of W[k], and every thread
// accumulates an RM x 4 register tile with fused multiply-adds. A thread
// whose RM rows have no neighbour at this offset skips the arithmetic, and a
// block where no row has one skips the offset: on sparse clouds most of the
// 26 off-centre taps are absent.
//
// Bound: operations. At 4 x 60,000 rows, 16 → 16 channels, the function
// reads 7.7 MB of rows, 25.9 MB of ranks and writes 7.7 MB (0.012 ms of HBM
// bandwidth) against 2·27·16·16 operations a row (3.3 GFLOP, 0.05 ms at
// the float32 rate) when every neighbour exists.
//
// Backward (the JAX package's `_bwd`, subm_conv_kernel.py:106, is XLA code):
//   dW[k] = Σ_{b,q} f[b, ranks[b, k, q]]ᵀ g[b, q]      subm_wgrad_kernel
//   df[b, ranks[b, k, q]] += g[b, q] @ W[k]ᵀ            subm_dgrad_kernel
// The weight gradient is bound by bytes (a feature row and a cotangent row of
// 32 to 128 bytes a present neighbour against 2·C·Cout operations) and runs
// the tiles of wgrad_tile.cuh: bfloat16 on the tensor cores
// (`wgrad::wgrad_mma_kernel`: a block owns the whole C x Cout matrix of one
// offset at a time, pulls units of a few thousand queries from that offset's
// queue, compacts their present neighbours, drops those whose cotangent row
// is zero by a flag a row (`wgrad::row_flags_kernel`), and puts its sums out
// with one set of atomicAdds when the queue is empty), float32 on
// the FMA tile (`subm_wgrad_kernel`; float32 is the type of the gradient
// checks, which TF32 would break). The feature gradient keeps the
// forward's tiling with the roles of C and Cout exchanged and scatters each
// offset's rows with float32 atomicAdds into a zeroed buffer, which holds for
// any rank table (no reverse ranks are needed); the sum order varies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgrad_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // channels staged at a time

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

// NCG column groups of 4 columns; 256 / NCG row groups of RM rows.
template <typename T, int NCG, int RM>
__global__ void __launch_bounds__(kThreads)
subm_conv_kernel(const T* __restrict__ feats, const int32_t* __restrict__ ranks,
                 const T* __restrict__ weights, T* __restrict__ out,
                 int vs, int vq, int k_offsets, int c, int cout) {
  constexpr int kRowGroups = kThreads / NCG;
  constexpr int kRows = kRowGroups * RM;
  constexpr int kCols = NCG * 4;
  __shared__ float rows_s[kRows][kChunk + 1];
  __shared__ __align__(16) float w_s[kChunk][kCols];
  __shared__ int rank_s[kRows];
  __shared__ int group_any[kRowGroups];
  __shared__ int block_any;

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int rg = tid / NCG;
  const bool computes = rg < kRowGroups;

  const T* f = feats + static_cast<long long>(b) * vs * c;
  const int32_t* rk = ranks + static_cast<long long>(b) * k_offsets * vq;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n] = 0.0f;

  for (int k = 0; k < k_offsets; ++k) {
    __syncthreads();  // the previous offset's reads of rank_s and the flags are done
    if (tid == 0) block_any = 0;
    for (int g = tid; g < kRowGroups; g += kThreads) group_any[g] = 0;
    __syncthreads();
    for (int r = tid; r < kRows; r += kThreads) {
      const int q = row0 + r;
      int rank = -1;
      if (q < vq) {
        rank = rk[static_cast<long long>(k) * vq + q];
        if (rank >= vs) rank = -1;
      }
      rank_s[r] = rank;
      if (rank >= 0) {
        group_any[r / RM] = 1;
        block_any = 1;
      }
    }
    __syncthreads();
    if (!block_any) continue;
    const bool mine = computes && group_any[rg] != 0;
    const T* wk = weights + static_cast<long long>(k) * c * cout;

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int cw = min(kChunk, c - c0);
      for (int item = tid; item < kRows * kChunk; item += kThreads) {
        const int r = item / kChunk;
        const int ch = item - r * kChunk;
        const int rank = rank_s[r];
        float v = 0.0f;
        if (rank >= 0 && ch < cw) v = to_float<T>(f[static_cast<long long>(rank) * c + c0 + ch]);
        rows_s[r][ch] = v;
      }
      for (int item = tid; item < kChunk * kCols; item += kThreads) {
        const int ch = item / kCols;
        const int col = item - ch * kCols;
        float v = 0.0f;
        if (ch < cw && col0 + col < cout) {
          v = to_float<T>(wk[static_cast<long long>(c0 + ch) * cout + col0 + col]);
        }
        w_s[ch][col] = v;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 4
        for (int ch = 0; ch < kChunk; ++ch) {
          const float4 w4 = *reinterpret_cast<const float4*>(&w_s[ch][cg * 4]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float a = rows_s[rg * RM + i][ch];
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
  T* o = out + static_cast<long long>(b) * vq * cout;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int q = row0 + rg * RM + i;
    if (q >= vq) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = col0 + cg * 4 + n;
      if (col < cout) o[static_cast<long long>(q) * cout + col] = from_float<T>(acc[i][n]);
    }
  }
}

template <typename T, int NCG, int RM>
cudaError_t launch_tile(const void* feats, const void* ranks, const void* weights, void* out,
                        int batch, int vs, int vq, int k_offsets, int c, int cout,
                        cudaStream_t stream) {
  constexpr int kRows = (kThreads / NCG) * RM;
  constexpr int kCols = NCG * 4;
  const dim3 grid((vq + kRows - 1) / kRows, (cout + kCols - 1) / kCols, batch);
  subm_conv_kernel<T, NCG, RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(ranks),
      static_cast<const T*>(weights), static_cast<T*>(out), vs, vq, k_offsets, c, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* feats, const void* ranks, const void* weights, void* out,
                   int batch, int vs, int vq, int k_offsets, int c, int cout,
                   cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || cout <= 0) return cudaErrorInvalidValue;  // nothing to launch
  if (batch > 65535) return cudaErrorInvalidConfiguration;
  if (cout <= 16) {
    return launch_tile<T, 4, 4>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, stream);
  }
  if (cout <= 32) {
    return launch_tile<T, 8, 8>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, stream);
  }
  return launch_tile<T, 16, 8>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, stream);
}

// float32 route. One block: one tile of wgrad::kQueries queries, one offset
// k, one (kWgK x kWgN) tile of dW[k], one sample.
__global__ void __launch_bounds__(wgrad::kThreads)
subm_wgrad_kernel(const float* __restrict__ feats, const int32_t* __restrict__ ranks,
                  const float* __restrict__ g, float* __restrict__ dw, int vs, int vq,
                  int k_offsets, int c, int cout, int k_tiles, int n_tiles) {
  __shared__ int hit_row[wgrad::kQueries];
  __shared__ int hit_q[wgrad::kQueries];
  __shared__ int count;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * wgrad::kQueries;
  int y = blockIdx.y;
  const int nt = y % n_tiles;
  y /= n_tiles;
  const int kt = y % k_tiles;
  const int k = y / k_tiles;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int32_t* rk = ranks + (static_cast<long long>(b) * k_offsets + k) * vq;
  for (int r = threadIdx.x; r < wgrad::kQueries; r += wgrad::kThreads) {
    const int q = q0 + r;
    if (q >= vq) continue;
    const int rank = rk[q];
    if (rank >= 0 && rank < vs) wgrad::push_hit(hit_row, hit_q, &count, rank, q);
  }
  __syncthreads();
  const int nhits = count;
  if (nhits == 0) return;
  const int k0 = kt * wgrad::kWgK;
  const int n0 = nt * wgrad::kWgN;
  wgrad::accumulate_tile(
      feats + static_cast<long long>(b) * vs * c, c, g + static_cast<long long>(b) * vq * cout,
      cout, hit_row, hit_q, nhits, k0, min(wgrad::kWgK, c - k0), n0, min(wgrad::kWgN, cout - n0),
      dw + static_cast<long long>(k) * c * cout, cout);
}

// The forward's tiling with g as the rows and W[k]ᵀ as the weights: a block
// owns kRows queries and up to 4·NCG of the C input channels; per offset it
// computes g[q] @ W[k]ᵀ for the queries whose neighbour exists and adds each
// row into df at the neighbour's rank.
template <typename T, int NCG, int RM>
__global__ void __launch_bounds__(kThreads)
subm_dgrad_kernel(const T* __restrict__ g, const int32_t* __restrict__ ranks,
                  const T* __restrict__ weights, float* __restrict__ df,
                  int vs, int vq, int k_offsets, int c, int cout) {
  constexpr int kRowGroups = kThreads / NCG;
  constexpr int kRows = kRowGroups * RM;
  constexpr int kCols = NCG * 4;
  __shared__ float rows_s[kRows][kChunk + 1];
  __shared__ __align__(16) float w_s[kChunk][kCols];
  __shared__ int rank_s[kRows];
  __shared__ int group_any[kRowGroups];
  __shared__ int block_any;

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int rg = tid / NCG;

  const T* gb = g + static_cast<long long>(b) * vq * cout;
  const int32_t* rk = ranks + static_cast<long long>(b) * k_offsets * vq;
  float* out = df + static_cast<long long>(b) * vs * c;

  for (int k = 0; k < k_offsets; ++k) {
    __syncthreads();  // the previous offset's reads of rank_s and the flags are done
    if (tid == 0) block_any = 0;
    for (int gi = tid; gi < kRowGroups; gi += kThreads) group_any[gi] = 0;
    __syncthreads();
    for (int r = tid; r < kRows; r += kThreads) {
      const int q = row0 + r;
      int rank = -1;
      if (q < vq) {
        rank = rk[static_cast<long long>(k) * vq + q];
        if (rank >= vs) rank = -1;
      }
      rank_s[r] = rank;
      if (rank >= 0) {
        group_any[r / RM] = 1;
        block_any = 1;
      }
    }
    __syncthreads();
    if (!block_any) continue;
    const bool mine = group_any[rg] != 0;
    const T* wk = weights + static_cast<long long>(k) * c * cout;

    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[i][n] = 0.0f;

    for (int d0 = 0; d0 < cout; d0 += kChunk) {
      const int dw = min(kChunk, cout - d0);
      for (int item = tid; item < kRows * kChunk; item += kThreads) {
        const int r = item / kChunk;
        const int ch = item - r * kChunk;
        float v = 0.0f;
        if (rank_s[r] >= 0 && ch < dw) {
          v = to_float<T>(gb[static_cast<long long>(row0 + r) * cout + d0 + ch]);
        }
        rows_s[r][ch] = v;
      }
      for (int item = tid; item < kChunk * kCols; item += kThreads) {
        const int ch = item / kCols;
        const int col = item - ch * kCols;
        float v = 0.0f;
        if (ch < dw && col0 + col < c) {
          v = to_float<T>(wk[static_cast<long long>(col0 + col) * cout + d0 + ch]);
        }
        w_s[ch][col] = v;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 4
        for (int ch = 0; ch < kChunk; ++ch) {
          const float4 w4 = *reinterpret_cast<const float4*>(&w_s[ch][cg * 4]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float a = rows_s[rg * RM + i][ch];
            acc[i][0] = fmaf(a, w4.x, acc[i][0]);
            acc[i][1] = fmaf(a, w4.y, acc[i][1]);
            acc[i][2] = fmaf(a, w4.z, acc[i][2]);
            acc[i][3] = fmaf(a, w4.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rank = rank_s[rg * RM + i];
        if (rank < 0) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = col0 + cg * 4 + n;
          if (col < c) atomicAdd(out + static_cast<long long>(rank) * c + col, acc[i][n]);
        }
      }
    }
  }
}

cudaError_t launch_wgrad(const void* feats, const void* ranks, const void* g, void* dw,
                         int batch, int vs, int vq, int k_offsets, int c, int cout,
                         cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || c <= 0 || cout <= 0 || k_offsets <= 0) return cudaErrorInvalidValue;
  const int k_tiles = (c + wgrad::kWgK - 1) / wgrad::kWgK;
  const int n_tiles = (cout + wgrad::kWgN - 1) / wgrad::kWgN;
  const long long gy = static_cast<long long>(k_offsets) * k_tiles * n_tiles;
  if (batch > 65535 || gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((vq + wgrad::kQueries - 1) / wgrad::kQueries, static_cast<unsigned int>(gy), batch);
  subm_wgrad_kernel<<<grid, wgrad::kThreads, 0, stream>>>(
      static_cast<const float*>(feats), static_cast<const int32_t*>(ranks),
      static_cast<const float*>(g), static_cast<float*>(dw), vs, vq, k_offsets, c, cout, k_tiles,
      n_tiles);
  return cudaGetLastError();
}

template <typename T, int NCG, int RM>
cudaError_t launch_dgrad_tile(const void* g, const void* ranks, const void* weights, void* df,
                              int batch, int vs, int vq, int k_offsets, int c, int cout,
                              cudaStream_t stream) {
  constexpr int kRows = (kThreads / NCG) * RM;
  constexpr int kCols = NCG * 4;
  const dim3 grid((vq + kRows - 1) / kRows, (c + kCols - 1) / kCols, batch);
  subm_dgrad_kernel<T, NCG, RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(ranks),
      static_cast<const T*>(weights), static_cast<float*>(df), vs, vq, k_offsets, c, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dgrad(const void* g, const void* ranks, const void* weights, void* df,
                         int batch, int vs, int vq, int k_offsets, int c, int cout,
                         cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || c <= 0 || cout <= 0) return cudaErrorInvalidValue;
  if (batch > 65535) return cudaErrorInvalidConfiguration;
  if (c <= 16) {
    return launch_dgrad_tile<T, 4, 4>(g, ranks, weights, df, batch, vs, vq, k_offsets, c, cout, stream);
  }
  if (c <= 32) {
    return launch_dgrad_tile<T, 8, 8>(g, ranks, weights, df, batch, vs, vq, k_offsets, c, cout, stream);
  }
  return launch_dgrad_tile<T, 16, 8>(g, ranks, weights, df, batch, vs, vq, k_offsets, c, cout, stream);
}

}  // namespace

// out (batch, vq, cout) = Σ_k feats (batch, vs, c)[ranks (batch, k_offsets, vq)] @
// weights (k_offsets, c, cout) on `stream`; a rank outside [0, vs) contributes
// zeros. `dtype` is 0 for float32 and 1 for bfloat16 (features, weights and
// output alike; the sums are float32). All tensors contiguous. Returns the
// CUDA error of the launch (0 on success).
extern "C" int subm_conv_launch(const void* feats, const void* ranks, const void* weights,
                                void* out, int batch, int vs, int vq, int k_offsets, int c,
                                int cout, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dw (k_offsets, c, cout) float32, zeroed by the caller, += Σ over samples and
// queries of feats[ranks]ᵀ g, with g (batch, vq, cout) in the features' type:
// float32 (`dtype` 0) on the FMA tile, bfloat16 (1) on the tensor cores.
// The bfloat16 route alone uses `flags` (batch, vq) uint8, scratch of the
// caller that is filled here (0 drops the query: its cotangent row is zero),
// and `queues` (k_offsets zeroed int32 for each of the `tiles` tiles of a
// weight matrix; a count that differs from the launch's own is an error).
// Returns the CUDA error of the launch (0 on success); an empty shape is an
// error, nothing would be launched.
extern "C" int subm_wgrad_launch(const void* feats, const void* ranks, const void* g, void* flags,
                                 void* dw, void* queues, int tiles, int batch, int vs, int vq,
                                 int k_offsets, int c, int cout, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_wgrad(feats, ranks, g, dw, batch, vs, vq, k_offsets, c, cout, s);
  } else if (dtype == 1) {
    int sm_count = 0;
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (flags == nullptr || batch <= 0 || vq <= 0) return static_cast<int>(cudaErrorInvalidValue);
    err = wgrad::launch_row_flags<__nv_bfloat16>(g, flags, static_cast<long long>(batch) * vq, cout, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = wgrad::launch_mma<__nv_bfloat16>(feats, g, ranks, flags, dw, queues, tiles, batch, vs, vq,
                                           k_offsets, 1, c, cout, sm_count, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// df (batch, vs, c) float32, zeroed by the caller, += g (batch, vq, cout) @
// weights[k]ᵀ scattered to ranks (batch, k_offsets, vq); g and weights in the
// type `dtype` names. Returns the CUDA error of the launch (0 on success).
extern "C" int subm_dgrad_launch(const void* g, const void* ranks, const void* weights, void* df,
                                 int batch, int vs, int vq, int k_offsets, int c, int cout,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_dgrad<float>(g, ranks, weights, df, batch, vs, vq, k_offsets, c, cout, s);
  } else if (dtype == 1) {
    err = launch_dgrad<__nv_bfloat16>(g, ranks, weights, df, batch, vs, vq, k_offsets, c, cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
