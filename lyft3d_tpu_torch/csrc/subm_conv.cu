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
// Bound: at 4 x 16,384 queries, 64 → 64 channels in bfloat16, the function
// reads 8.4 MB of rows and 7.1 MB of ranks and writes 8.4 MB (0.007 ms of
// HBM bandwidth), against 2·64·64 operations a present neighbour: 14.5
// GFLOP when all 27 exist, 0.015 ms on the tensor cores, 0.22 ms in float32
// FMAs. The rows a block gathers from L2 and the latency of that gather are
// what a kernel really pays.
//
// bfloat16 runs on the tensor cores (`convmma::conv_mma_kernel` of
// conv_mma.cuh, the stencil's device code over 27 offsets): the weights are
// re-laid once a launch as (K, n_pad, kp) bfloat16 (`weight_prep_kernel`); a
// block owns 128 queries and all output columns (16 to 256), keeps its 27 x
// 128 ranks in shared memory, fetches the rows of each offset with a hit by
// rank into a `cp.async` ring (zero fill where the rank is −1), and runs
// `mma.sync.m16n8k16` with float32 accumulators; 16-query groups and
// offsets without a hit are skipped. The contraction of a stage is 16, 32
// or 64 channels (the largest that divides C padded to 16), so the 16- and
// 32-channel layers are not padded to 64.
// Rows whose width is not a multiple of 16 (the first layer's 3, 4 or 5
// point features) are copied once into zero-padded bfloat16 rows of 16
// (`rows_prep_kernel`): 16-byte `cp.async` needs rows of whole 16 bytes.
// float32 keeps the FMA kernel (`subm_conv_kernel`): float32 is the type of
// the 1e-5 gradient checks, which TF32 would break. One block owns a tile of
// kRows output rows and up to 4·NCG output columns; for each offset it loads
// the tile's ranks, gathers the rows into shared memory kChunk channels at a
// time, stages the matching slice of W[k], and every thread accumulates an
// RM x 4 register tile; offsets without a hit in the block are skipped.
//
// Backward (the JAX package's `_bwd`, subm_conv_kernel.py:106, is XLA code):
//   df[b, u] = Σ_k g[b, rev[b, k, u]] @ W[k]ᵀ   the forward route again
//   dW[k] = Σ_{b,q} f[b, ranks[b, k, q]]ᵀ g[b, q]      subm_wgrad_kernel
// On a submanifold table each offset maps at most one query to a source row,
// so the scatter df[ranks[k, q]] += g[q] @ W[k]ᵀ is a gather over the reverse
// ranks (rev[b, k, ranks[b, k, q]] = q, built in the same call by a scatter
// pass and a gather-back check that raises a flag the wrapper asserts on):
// the forward's launch on (g, rev, Wᵀ), with no atomics, no zeroed buffer and
// a fixed sum order; in bfloat16 the kernel rounds the float32 sums once.
// The weight gradient is bound by bytes (a feature row and a cotangent row of
// 32 to 128 bytes a present neighbour against 2·C·Cout operations) and runs
// the tiles of wgrad_tile.cuh: bfloat16 on the tensor cores
// (`wgrad::wgrad_mma_kernel`: a block owns the whole C x Cout matrix of one
// offset at a time, pulls units of a few thousand queries from that offset's
// queue, compacts their present neighbours, drops those whose cotangent row
// is zero by a flag a row (`wgrad::row_flags_kernel`), and puts its sums out
// with one set of atomicAdds when the queue is empty), float32 on
// the FMA tile (`subm_wgrad_kernel`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "wgrad_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // channels staged at a time

// float32 route. NCG column groups of 4 columns; 256 / NCG row groups of RM
// rows.
template <int NCG, int RM>
__global__ void __launch_bounds__(kThreads)
subm_conv_kernel(const float* __restrict__ feats, const int32_t* __restrict__ ranks,
                 const float* __restrict__ weights, float* __restrict__ out,
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

  const float* f = feats + static_cast<long long>(b) * vs * c;
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
    const float* wk = weights + static_cast<long long>(k) * c * cout;

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int cw = min(kChunk, c - c0);
      for (int item = tid; item < kRows * kChunk; item += kThreads) {
        const int r = item / kChunk;
        const int ch = item - r * kChunk;
        const int rank = rank_s[r];
        float v = 0.0f;
        if (rank >= 0 && ch < cw) v = f[static_cast<long long>(rank) * c + c0 + ch];
        rows_s[r][ch] = v;
      }
      for (int item = tid; item < kChunk * kCols; item += kThreads) {
        const int ch = item / kCols;
        const int col = item - ch * kCols;
        float v = 0.0f;
        if (ch < cw && col0 + col < cout) {
          v = wk[static_cast<long long>(c0 + ch) * cout + col0 + col];
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
  float* o = out + static_cast<long long>(b) * vq * cout;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int q = row0 + rg * RM + i;
    if (q >= vq) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = col0 + cg * 4 + n;
      if (col < cout) o[static_cast<long long>(q) * cout + col] = acc[i][n];
    }
  }
}

template <int NCG, int RM>
cudaError_t launch_tile(const void* feats, const void* ranks, const void* weights, void* out,
                        int batch, int vs, int vq, int k_offsets, int c, int cout,
                        cudaStream_t stream) {
  constexpr int kRows = (kThreads / NCG) * RM;
  constexpr int kCols = NCG * 4;
  const dim3 grid((vq + kRows - 1) / kRows, (cout + kCols - 1) / kCols, batch);
  subm_conv_kernel<NCG, RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(feats), static_cast<const int32_t*>(ranks),
      static_cast<const float*>(weights), static_cast<float*>(out), vs, vq, k_offsets, c, cout);
  return cudaGetLastError();
}

// The float32 route's launch.
cudaError_t launch(const void* feats, const void* ranks, const void* weights, void* out,
                   int batch, int vs, int vq, int k_offsets, int c, int cout,
                   cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || cout <= 0) return cudaErrorInvalidValue;  // nothing to launch
  if (batch > 65535) return cudaErrorInvalidConfiguration;
  if (cout <= 16) {
    return launch_tile<4, 4>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, stream);
  }
  if (cout <= 32) {
    return launch_tile<8, 8>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, stream);
  }
  return launch_tile<16, 8>(feats, ranks, weights, out, batch, vs, vq, k_offsets, c, cout, stream);
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

// The feature gradient's positions: rev[b, k, table[b, k, u]] = u for the
// forward's table (batch, k_offsets, n) with values in [0, vq), on rev filled
// with −1. A table that gives one (offset, row) pair to two entries leaves
// only one of them in rev; `reverse_check_kernel` then finds the other and
// sets *bad (no atomics: any writer stores the same 1).
__global__ void __launch_bounds__(kThreads)
reverse_scatter_kernel(const int32_t* __restrict__ table, int32_t* __restrict__ rev, long long total,
                       int n, int vq) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int r = table[i];
  if (r >= 0 && r < vq) rev[(i / n) * vq + r] = static_cast<int32_t>(i % n);
}

__global__ void __launch_bounds__(kThreads)
reverse_check_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ rev,
                     int32_t* __restrict__ bad, long long total, int n, int vq) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int r = table[i];
  if (r >= 0 && r < vq && rev[(i / n) * vq + r] != static_cast<int32_t>(i % n)) *bad = 1;
}

cudaError_t reverse_table(const void* table, void* rev, void* bad, int batch, int k_offsets, int n, int vq,
                          cudaStream_t s) {
  const long long total = static_cast<long long>(batch) * k_offsets * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaMemsetAsync(rev, 0xff, static_cast<size_t>(batch) * k_offsets * vq * 4, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(bad, 0, 4, s);
  if (err != cudaSuccess) return err;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  reverse_scatter_kernel<<<grid, kThreads, 0, s>>>(static_cast<const int32_t*>(table),
                                                   static_cast<int32_t*>(rev), total, n, vq);
  reverse_check_kernel<<<grid, kThreads, 0, s>>>(static_cast<const int32_t*>(table),
                                                 static_cast<const int32_t*>(rev), static_cast<int32_t*>(bad),
                                                 total, n, vq);
  return cudaGetLastError();
}

constexpr int kMaxOffsets = 27;

// Pipeline stages of the ring: deeper for narrow slices (a stage holds fewer
// bytes), fewer for the 16-warp tile of up to 256 columns.
constexpr int stages_for(int slice, bool wide) {
  return slice == 64 ? (wide ? 2 : 3) : slice == 32 ? (wide ? 3 : 4) : (wide ? 4 : 6);
}

// Up to 16 and 32 columns: 8 x 1 warps, a warp 16 queries x all columns; up
// to 64 and 128: 4 x 2 warps, a warp 32 queries x half the columns; up to
// 256: 8 x 2 warps of 16 queries x 128 columns.
template <int SLICE, typename TO>
cudaError_t launch_mma_slice(const void* rows, const void* ranks, const void* wt, const void* wmask,
                             void* out, int batch, int vs, int vq, int k_offsets, int kp, int cout,
                             int n_pad, cudaStream_t s) {
  constexpr int kS = stages_for(SLICE, false);
  if (n_pad <= 16) {
    return convmma::launch_conv_mma<kMaxOffsets, SLICE, 8, 1, 1, 2, kS, true, TO>(
        rows, ranks, wt, wmask, out, batch, k_offsets, vs, vq, 1, kp, cout, n_pad, s);
  }
  if (n_pad <= 32) {
    return convmma::launch_conv_mma<kMaxOffsets, SLICE, 8, 1, 1, 4, kS, true, TO>(
        rows, ranks, wt, wmask, out, batch, k_offsets, vs, vq, 1, kp, cout, n_pad, s);
  }
  if (n_pad <= 64) {
    return convmma::launch_conv_mma<kMaxOffsets, SLICE, 4, 2, 2, 4, kS, true, TO>(
        rows, ranks, wt, wmask, out, batch, k_offsets, vs, vq, 1, kp, cout, n_pad, s);
  }
  if (n_pad <= 128) {
    return convmma::launch_conv_mma<kMaxOffsets, SLICE, 4, 2, 2, 8, kS, true, TO>(
        rows, ranks, wt, wmask, out, batch, k_offsets, vs, vq, 1, kp, cout, n_pad, s);
  }
  return convmma::launch_conv_mma<kMaxOffsets, SLICE, 8, 2, 1, 16, stages_for(SLICE, true), true, TO>(
      rows, ranks, wt, wmask, out, batch, k_offsets, vs, vq, 1, kp, cout, n_pad, s);
}

template <typename TO>
cudaError_t launch_mma_kp(const void* a, const void* ranks, const void* wt, const void* wmask, void* out,
                          int batch, int vs, int vq, int k_offsets, int kp, int cout, int n_pad,
                          cudaStream_t s) {
  if (kp % 64 == 0) {
    return launch_mma_slice<64, TO>(a, ranks, wt, wmask, out, batch, vs, vq, k_offsets, kp, cout, n_pad, s);
  }
  if (kp % 32 == 0) {
    return launch_mma_slice<32, TO>(a, ranks, wt, wmask, out, batch, vs, vq, k_offsets, kp, cout, n_pad, s);
  }
  return launch_mma_slice<16, TO>(a, ranks, wt, wmask, out, batch, vs, vq, k_offsets, kp, cout, n_pad, s);
}

// The bfloat16 route, all its launches: rows padded to kp where C is not
// (`rows` non-null), weights re-laid, the tensor-core kernel, whose float32
// sums are written as float32 (`out_dtype` 0) or rounded to bfloat16 (1).
cudaError_t launch_mma(const void* feats, void* rows, const void* ranks, const void* weights, void* wt,
                       void* wmask, void* out, int out_dtype, int batch, int vs, int vq, int k_offsets,
                       int c, int cout, int kp, int n_pad, cudaStream_t s) {
  if (batch <= 0 || vs <= 0 || vq <= 0 || c <= 0 || cout <= 0 || k_offsets <= 0 ||
      k_offsets > kMaxOffsets || kp != (c + 15) / 16 * 16 || kp > 256 || n_pad != (cout + 15) / 16 * 16 ||
      n_pad > 256 || (rows != nullptr) != (kp != c) || (out_dtype != 0 && out_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (rows != nullptr) {
    err = convmma::rows_prep(feats, rows, nullptr, static_cast<long long>(batch) * vs, 1, c, kp, 1, s);
    if (err != cudaSuccess) return err;
  }
  err = convmma::weight_prep(weights, static_cast<long long>(c) * cout, cout, 1, wt, wmask, k_offsets, c,
                             cout, kp, n_pad, s);
  if (err != cudaSuccess) return err;
  const void* a = rows != nullptr ? rows : feats;
  if (out_dtype == 0) {
    return launch_mma_kp<float>(a, ranks, wt, wmask, out, batch, vs, vq, k_offsets, kp, cout, n_pad, s);
  }
  return launch_mma_kp<__nv_bfloat16>(a, ranks, wt, wmask, out, batch, vs, vq, k_offsets, kp, cout, n_pad, s);
}

}  // namespace

// out (batch, vq, cout) = Σ_k feats (batch, vs, c)[pos (batch, k_offsets, vq)] @
// weights (k_offsets, c, cout) on `stream`; a position outside [0, vs)
// contributes zeros. With `rev` null the positions are `ranks` (the
// forward). With `rev` (batch, k_offsets, vq) int32 scratch, `ranks` is a
// forward table (batch, k_offsets, vs) with values in [0, vq), and the
// positions are its reverse, built here into `rev` (the feature gradient:
// feats the cotangent, weights transposed); `bad` (one int32) is set to 1
// where the table reads an (offset, row) pair twice, and the result is then
// wrong. `dtype` is 0 for float32 (the FMA kernel) and 1 for bfloat16 (the
// tensor cores; at most 27 offsets and 256 channels in and out): features
// and weights alike, the sums float32. The output is of `out_dtype` (same
// codes): the features' type, or float32 sums of the bfloat16 route, which
// the checks hold to the plain version unrounded. All tensors contiguous,
// feats 16-byte aligned in bfloat16. Scratch of the caller in bfloat16: wt
// (k_offsets, n_pad, kp) bfloat16 and wmask (k_offsets, 16) int32, with kp
// and n_pad c and cout rounded up to 16; rows (batch, vs, kp) bfloat16 where
// kp != c, else null. Returns the CUDA error of the launch (0 on success);
// an empty shape is an error, nothing would be launched.
extern "C" int subm_conv_launch(const void* feats, const void* ranks, const void* weights, void* out,
                                void* rows, void* wt, void* wmask, void* rev, void* bad, int batch, int vs,
                                int vq, int k_offsets, int c, int cout, int kp, int n_pad, int dtype,
                                int out_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || vs <= 0 || vq <= 0 || k_offsets <= 0 || (rev != nullptr && bad == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* pos = ranks;
  if (rev != nullptr) {
    err = reverse_table(ranks, rev, bad, batch, k_offsets, vs, vq, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    pos = rev;
  }
  if (dtype == 0 && out_dtype == 0) {
    err = launch(feats, pos, weights, out, batch, vs, vq, k_offsets, c, cout, s);
  } else if (dtype == 1) {
    err = launch_mma(feats, rows, pos, weights, wt, wmask, out, out_dtype, batch, vs, vq, k_offsets, c,
                     cout, kp, n_pad, s);
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
