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
// Bound: bytes: the source rows, ids and positions read once, the weights
// once, the output written once (float32: at the column middle's 640
// columns its 614 MB are most of it), over 3.35 TB/s (chip_smoke.py's
// formulas); the real work, 2·hits·nc·kzp·N operations with the band's
// zeros, is far below the tensor cores' rate. What the kernels fight is
// what they add themselves: a row gathered more than once, weights re-read
// by every block, zeros multiplied, and, at one to four hits a query,
// instructions and their latency a hit.
//
// bfloat16 takes the tensor-core route of conv_mma.cuh, in one call:
//   1. `stencil_positions_kernel`: every (sample, offset, query) finds its
//      source row once, a binary search over the sample's ids (L2-resident:
//      300 KB at 75,000 units), into an int32 table; no tile searches again,
//      and the backward's `d_wc` takes the forward's table. With per-row
//      flags of the source a hit on an all-zero row (a cotangent row the
//      caps cut off) becomes a miss.
//   2. `convmma::weight_prep_kernel`: the weights as (9, n_pad, kp), the
//      contraction index contiguous, zero-padded, with one bit for every
//      16 x 8 block that holds a non-zero: the band weights are two thirds
//      zeros, and kzp pads (zs+2)·C to 128 lanes. For the wide tile also
//      `band_ranges_kernel` (each (offset, 16-lane step)'s range of non-zero
//      columns) and `fragment_prep_kernel` (the weights in the order of the
//      MMA's B fragments).
//   3. the tile the rule picks (`route`; `stencil_mma_variant` in
//      ops/column_sparse.py writes the same rule):
//      - the unit tile, `convmma::conv_mma_kernel`, for at most 256 lanes
//        and either fewer than 128 columns or 128 columns in more than one
//        chunk (the unit middle's strided layers, 65-68 columns; the column
//        middle's mask convs and its layers of 64-128 columns at 3-5
//        chunks): a block owns 128 queries and all their columns, and a
//        `cp.async` ring of (offset, 64-lane slice) stages feeds
//        `mma.sync.m16n8k16`; 16-query groups without a hit and zero weight
//        block pairs are skipped.
//      - the wide tile, `convmma::conv_wide_kernel`, for everything else
//        (the unit middle's 128-column layers, every `d_src`, the column
//        middle's 192-640 columns at 1-4 chunks): a 16-query group's warps
//        own a chunk's whole width (128 columns a warp), without shared
//        memory; each warp walks the offsets its queries hit and the
//        16-lane steps whose band range meets its columns, loading A
//        fragments straight from its rows and B fragments from the
//        fragment-ordered weights. What bounds it is the count of
//        instructions and their latency a (query group, hit offset, band
//        step), not bytes (conv_mma.cuh says how the ring version of this
//        tile measured).
//      The boundary is measured (tools/stencil_tile_ab.py, both tiles on
//      every shape both take): the wide tile was faster at every `d_src`
//      and at the unit middle's 128-column forward layers, the unit tile at
//      outputs under 128 columns and at 128 columns in 5 chunks.
// The unit tile reads bfloat16 rows of whole 64-lane slices; rows of
// another type or width (a float32 cotangent, a chunk that is not whole
// slices) are first copied into padded bfloat16 rows by
// `convmma::rows_prep_kernel`, which also writes the row flags. The wide
// tile reads float32 or bfloat16 rows as they are, two lanes at a time
// (float32 rounded to bfloat16 as it is read); only a chunk of an odd width
// is copied, and `d_src`'s zero cotangent rows are flagged by a pass that
// writes the flags alone (`wgrad::row_flags_kernel`).
//
// float32 keeps the float32 FMA route (`stencil_conv_kernel`): float32 is
// the type of the checks (1e-5), which TF32 would break. One block owns a
// tile of kRows queries, one chunk c and up to 4·NCG output columns, searches
// per offset, stages kChunk lanes at a time and accumulates an RM x 4
// register tile a thread.
//
// Backward (the JAX package's `_stencil_bwd`, column_sparse.py:742):
//   d_src  the same stencil launched a second time, as the JAX backward does
//          (column_sparse.py:773): the cotangent rows are the source, the
//          reverse queries pick them, the band weights are transposed, the
//          contraction is N (up to 640 lanes) and the output width is kzp
//          (128 or 256 columns), so every `d_src` takes the wide tile,
//          which reads the float32 cotangent as it is.
//   d_wc[j] = Σ_{b,q,c} src[b, pos(qids[b, j, q])][chunk c]ᵀ g[b, q][chunk c]
//          `wgrad::wgrad_mma_kernel` (bfloat16 sources, tensor cores, the
//          float32 cotangent split in two bfloat16 halves; 16-warp tiles of
//          128 x 256 or 256 x 128 above 128 columns, on the forward's
//          position table) or
//          `stencil_wgrad_kernel` (float32 sources, FMA), both of
//          wgrad_tile.cuh's tiles, ending in float32 atomicAdds into a zeroed
//          (9, kzp, N) buffer; the sum order varies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "wgrad_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // source lanes staged at a time (float32 route)
constexpr int kOffsets = 9;

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

// ---------------------------------------------------------------------------
// float32 route.
// ---------------------------------------------------------------------------

// NCG column groups of 4 columns; 256 / NCG row groups of RM queries.
template <int NCG, int RM>
__global__ void __launch_bounds__(kThreads)
stencil_conv_kernel(const float* __restrict__ src, const int32_t* __restrict__ qids,
                    const int32_t* __restrict__ src_ids, const float* __restrict__ wc,
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
  const float* s = src + static_cast<long long>(b) * vs * width + static_cast<long long>(chunk) * kzp;
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
    const float* wj = wc + static_cast<long long>(j) * kzp * n;

    for (int k0 = 0; k0 < kzp; k0 += kChunk) {
      const int kw = min(kChunk, kzp - k0);
      for (int item = tid; item < kRows * kChunk; item += kThreads) {
        const int r = item / kChunk;
        const int lane = item - r * kChunk;
        const int pos = pos_s[r];
        float v = 0.0f;
        if (pos >= 0 && lane < kw) v = s[static_cast<long long>(pos) * width + k0 + lane];
        rows_s[r][lane] = v;
      }
      for (int item = tid; item < kChunk * kCols; item += kThreads) {
        const int lane = item / kCols;
        const int col = item - lane * kCols;
        float v = 0.0f;
        if (lane < kw && col0 + col < n) {
          v = wj[static_cast<long long>(k0 + lane) * n + col0 + col];
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

template <int NCG, int RM>
cudaError_t launch_tile(const void* src, const void* qids, const void* src_ids, const void* wc,
                        void* out, int batch, int vs, int vq, int nc, int kzp, int n,
                        cudaStream_t stream) {
  constexpr int kRows = (kThreads / NCG) * RM;
  constexpr int kCols = NCG * 4;
  const int col_tiles = (n + kCols - 1) / kCols;
  if (static_cast<long long>(col_tiles) * nc > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((vq + kRows - 1) / kRows, col_tiles * nc, batch);
  stencil_conv_kernel<NCG, RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(qids),
      static_cast<const int32_t*>(src_ids), static_cast<const float*>(wc),
      static_cast<float*>(out), vs, vq, nc, kzp, n, col_tiles);
  return cudaGetLastError();
}

cudaError_t launch(const void* src, const void* qids, const void* src_ids, const void* wc,
                   void* out, int batch, int vs, int vq, int nc, int kzp, int n,
                   cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || n <= 0 || nc <= 0) return cudaErrorInvalidValue;  // nothing to launch
  if (batch > 65535) return cudaErrorInvalidConfiguration;
  // The smallest column tile that takes all n columns in one pass, so that a
  // query's rows are gathered once: 16, 32, 64, 68 (the strided layers' 64 +
  // mask channel widths) or 128 columns; wider outputs take several tiles.
  if (n <= 16) return launch_tile<4, 4>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  if (n <= 32) return launch_tile<8, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  if (n <= 64) return launch_tile<16, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  if (n <= 68) return launch_tile<17, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
  return launch_tile<32, 8>(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n, stream);
}

// One block: one tile of wgrad::kQueries queries, one offset j, one
// (kWgK x kWgN) tile of d_wc[j], one sample; it loops over the nc chunks.
__global__ void __launch_bounds__(wgrad::kThreads)
stencil_wgrad_kernel(const float* __restrict__ src, const int32_t* __restrict__ qids,
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
  const float* a = src + static_cast<long long>(b) * vs * a_stride;
  const float* gb = g + static_cast<long long>(b) * vq * g_stride;
  for (int chunk = 0; chunk < nc; ++chunk) {
    wgrad::accumulate_tile(
        a + static_cast<long long>(chunk) * kzp, a_stride, gb + static_cast<long long>(chunk) * n,
        g_stride, hit_row, hit_q, nhits, k0, min(wgrad::kWgK, kzp - k0), n0,
        min(wgrad::kWgN, n - n0), dwc + static_cast<long long>(j) * kzp * n, n);
  }
}

cudaError_t launch_wgrad(const void* src, const void* qids, const void* src_ids, const void* g,
                         void* dwc, int batch, int vs, int vq, int nc, int kzp, int n,
                         cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || n <= 0 || nc <= 0 || kzp <= 0) return cudaErrorInvalidValue;
  const int k_tiles = (kzp + wgrad::kWgK - 1) / wgrad::kWgK;
  const int n_tiles = (n + wgrad::kWgN - 1) / wgrad::kWgN;
  const long long gy = static_cast<long long>(kOffsets) * k_tiles * n_tiles;
  if (batch > 65535 || gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((vq + wgrad::kQueries - 1) / wgrad::kQueries, static_cast<unsigned int>(gy), batch);
  stencil_wgrad_kernel<<<grid, wgrad::kThreads, 0, stream>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(qids),
      static_cast<const int32_t*>(src_ids), static_cast<const float*>(g),
      static_cast<float*>(dwc), vs, vq, nc, kzp, n, k_tiles, n_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: positions, weight and row preparation, tensor-core kernel.
// ---------------------------------------------------------------------------

constexpr int kSlice = 64;  // contraction lanes a pipeline stage of the unit tile holds (conv_mma.cuh)

// pos[b, j, q] = position of qids[b, j, q] in src_ids[b], −1 where absent or,
// with `src_flags` (batch, vs), where the source row's flag is 0.
__global__ void __launch_bounds__(kThreads)
stencil_positions_kernel(const int32_t* __restrict__ qids, const int32_t* __restrict__ src_ids,
                         const uint8_t* __restrict__ src_flags, int32_t* __restrict__ pos,
                         int vs, int vq, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long b = i / (static_cast<long long>(kOffsets) * vq);
  const int32_t id = qids[i];
  int p = -1;
  if (id >= 0) {
    p = find_id(src_ids + b * vs, vs, id);
    if (p >= 0 && src_flags != nullptr && src_flags[b * vs + p] == 0) p = -1;
  }
  pos[i] = p;
}

// The unit tile (`route` 0), up to 128 columns: 8 warps (4 x 2, a warp 32
// queries x 64 columns), three stages.
template <typename TO>
cudaError_t launch_mma(const void* src, const void* pos, const void* wt, const void* wmask, void* out,
                       int batch, int vs, int vq, int nc, int kp, int n, int n_pad,
                       cudaStream_t stream) {
  if (n_pad > 128) return cudaErrorInvalidValue;
  return convmma::launch_conv_mma<kOffsets, kSlice, 4, 2, 2, 8, 3, false, TO>(
      src, pos, wt, wmask, out, batch, kOffsets, vs, vq, nc, kp, n, n_pad, stream);
}

// pos (batch, 9, vq) int32 from qids (batch, 9, vq) and src_ids (batch, vs);
// src_flags (batch, vs) uint8 or null.
cudaError_t positions(const void* qids, const void* src_ids, const void* src_flags, void* pos,
                      int batch, int vs, int vq, cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * kOffsets * vq;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  stencil_positions_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(qids), static_cast<const int32_t*>(src_ids),
      static_cast<const uint8_t*>(src_flags), static_cast<int32_t*>(pos), vs, vq, total);
  return cudaGetLastError();
}

// wt (9, n_pad, kp) bfloat16 and wmask (9, mask_tiles(n_pad), mask_steps(kp))
// uint32 (conv_mma.cuh); kp whole 64-lane slices, up to 640.
cudaError_t weight_prep(const void* w, long long sj, long long sk, long long so, void* wt,
                        void* wmask, int k_in, int n_out, int kp, int n_pad, cudaStream_t stream) {
  if (kp % kSlice != 0) return cudaErrorInvalidValue;
  return convmma::weight_prep(w, sj, sk, so, wt, wmask, kOffsets, k_in, n_out, kp, n_pad, stream);
}

// Rows (n_rows, nc·k_in) of `dtype` (0 float32, 1 bfloat16) → out (n_rows,
// nc·kp) bfloat16, each chunk zero-padded (a null `out`: flags only), and
// flags (n_rows) uint8: 1 where the row holds a non-zero.
cudaError_t rows_prep(const void* in, void* out, void* flags, long long n_rows, int nc, int k_in,
                      int kp, int dtype, cudaStream_t stream) {
  if (n_rows == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (out == nullptr) {
    if (dtype == 0) return wgrad::launch_row_flags<float>(in, flags, n_rows, nc * k_in, stream);
    return wgrad::launch_row_flags<__nv_bfloat16>(in, flags, n_rows, nc * k_in, stream);
  }
  return convmma::rows_prep(in, out, flags, n_rows, nc, k_in, kp, dtype, stream);
}

}  // namespace

// float32 route. out (batch, vq, nc·n) float32 from src (batch, vs, nc·kzp),
// qids (batch, 9, vq) int32 (−1 absent), src_ids (batch, vs) int32 ascending
// and wc (9, kzp, n), all float32 and contiguous, on `stream`. Returns the
// CUDA error of the launch (0 on success).
extern "C" int stencil_conv_launch(const void* src, const void* qids, const void* src_ids,
                                   const void* wc, void* out, int batch, int vs, int vq, int nc,
                                   int kzp, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(src, qids, src_ids, wc, out, batch, vs, vq, nc, kzp, n,
                                 static_cast<cudaStream_t>(stream)));
}

// float32 route. dwc (9, kzp, n) float32, zeroed by the caller, += Σ over
// samples, queries and chunks of src[pos(qids)]ᵀ g, with src (batch, vs,
// nc·kzp) and the cotangent g (batch, vq, nc·n) float32.
extern "C" int stencil_wgrad_launch(const void* src, const void* qids, const void* src_ids,
                                    const void* g, void* dwc, int batch, int vs, int vq, int nc,
                                    int kzp, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wgrad(src, qids, src_ids, g, dwc, batch, vs, vq, nc, kzp, n,
                                       static_cast<cudaStream_t>(stream)));
}

// The three preparation kernels on their own (positions, weight_prep and
// rows_prep above), for checks against their plain versions.
extern "C" int stencil_positions_launch(const void* qids, const void* src_ids, const void* src_flags,
                                        void* pos, int batch, int vs, int vq, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(positions(qids, src_ids, src_flags, pos, batch, vs, vq,
                                    static_cast<cudaStream_t>(stream)));
}

extern "C" int stencil_weight_prep_launch(const void* w, long long sj, long long sk, long long so,
                                          void* wt, void* wmask, int k_in, int n_out, int kp,
                                          int n_pad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(weight_prep(w, sj, sk, so, wt, wmask, k_in, n_out, kp, n_pad,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int stencil_rows_prep_launch(const void* in, void* out, void* flags, long long n_rows,
                                        int nc, int k_in, int kp, int dtype, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(rows_prep(in, out, flags, n_rows, nc, k_in, kp, dtype,
                                    static_cast<cudaStream_t>(stream)));
}

// bfloat16 route, all its launches in one call. out (batch, vq, nc·n) float32
// (`out_dtype` 0) or bfloat16 (1) from src (batch, vs, nc·k) of `src_dtype`
// (0 float32, 1 bfloat16), qids (batch, 9, vq), src_ids (batch, vs) and
// bfloat16 weights whose element (j, k, o) lies at w[j·sj + k·sk + o·so], on
// the unit tile (`route` 0) or the wide tile (1; conv_mma.cuh). Scratch of
// the caller: pos (batch, 9, vq) int32 (the positions, which the caller may
// keep), wt (9, n_pad, kp) bfloat16, wmask (9, mask_tiles(n_pad),
// mask_steps(kp)) uint32 and, for the wide tile (else null), wband (9, kp/16)
// uint32 and wfrag (9, kp/16, n_pad/16, 32) uint4. The rows are read as they
// are, unless `rows` is given: then rows (batch, vs, nc·kp) bfloat16 is a
// padded copy made first (the unit tile's rows of another type or width; the
// wide tile's rows of an odd width). flags (batch, vs) uint8, or null, marks
// the source rows that hold a non-zero (filled here, by the copy or by a pass
// of its own): a hit on a row that is all zero is then a miss.
// An empty shape is an error: nothing would be launched.
extern "C" int stencil_conv_mma_launch(const void* src, int src_dtype, void* rows, void* flags,
                                       const void* qids, const void* src_ids, void* pos,
                                       const void* w, long long sj, long long sk, long long so,
                                       void* wt, void* wmask, void* wband, void* wfrag, void* out,
                                       int out_dtype, int batch, int vs, int vq, int nc, int k, int n, int kp,
                                       int n_pad, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || vs <= 0 || vq <= 0 || nc <= 0 || k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 65535 || nc > 65535 || n > n_pad || k > kp || (src_dtype != 0 && src_dtype != 1) ||
      route < 0 || route > 1 || (route != 0) != (wband != nullptr) || (route != 0) != (wfrag != nullptr) ||
      (rows != nullptr && flags == nullptr) ||
      (route == 0 && rows == nullptr && (src_dtype != 1 || k != kp))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = static_cast<long long>(batch) * vs;
  if (rows != nullptr) {
    err = rows_prep(src, rows, flags, n_rows, nc, k, kp, src_dtype, s);
  } else if (flags != nullptr) {
    err = rows_prep(src, nullptr, flags, n_rows, nc, k, k, src_dtype, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = positions(qids, src_ids, flags, pos, batch, vs, vq, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = weight_prep(w, sj, sk, so, wt, wmask, k, n, kp, n_pad, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* a = rows != nullptr ? rows : src;
  const int a_dtype = rows != nullptr ? 1 : src_dtype;
  const int ka = rows != nullptr ? kp : k;
  if (out_dtype != 0 && out_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    err = out_dtype == 0 ? launch_mma<float>(a, pos, wt, wmask, out, batch, vs, vq, nc, kp, n, n_pad, s)
                         : launch_mma<__nv_bfloat16>(a, pos, wt, wmask, out, batch, vs, vq, nc, kp, n, n_pad, s);
    return static_cast<int>(err);
  }
  err = convmma::band_ranges(wmask, wband, kOffsets, kp, n_pad, s);
  if (err == cudaSuccess) err = convmma::fragment_prep(wt, wfrag, kOffsets, kp, n_pad, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a_dtype == 1 && out_dtype == 0) {
    err = convmma::launch_conv_wide<__nv_bfloat16, float>(a, pos, wfrag, wband, out, batch, kOffsets, vs, vq, nc,
                                                          ka, kp, n, n_pad, s);
  } else if (a_dtype == 1) {
    err = convmma::launch_conv_wide<__nv_bfloat16, __nv_bfloat16>(a, pos, wfrag, wband, out, batch, kOffsets, vs,
                                                                  vq, nc, ka, kp, n, n_pad, s);
  } else if (out_dtype == 0) {
    err = convmma::launch_conv_wide<float, float>(a, pos, wfrag, wband, out, batch, kOffsets, vs, vq, nc, ka, kp,
                                                  n, n_pad, s);
  } else {
    err = convmma::launch_conv_wide<float, __nv_bfloat16>(a, pos, wfrag, wband, out, batch, kOffsets, vs, vq, nc,
                                                          ka, kp, n, n_pad, s);
  }
  return static_cast<int>(err);
}

// bfloat16 route, all its launches in one call. dwc (9, kzp, n) float32,
// zeroed by the caller, += Σ over samples, queries and chunks of
// src[pos(qids)]ᵀ g with src (batch, vs, nc·kzp) bfloat16 and the cotangent g
// (batch, vq, nc·n) float32. flags (batch, vq) uint8, 0 drops the query (its
// cotangent row is zero): the caller's when `flags_given`, else scratch that
// is filled here from g. pos (batch, 9, vq) int32: the forward's positions
// when `pos_given` (a hit on a source row that is all zero may be a miss
// there: it adds nothing), else scratch that is filled here. `queues`, 9
// zeroed int32 for each of the `tiles` tiles of a weight matrix (a count that
// differs from the launch's own is an error, as is an empty shape).
extern "C" int stencil_wgrad_mma_launch(const void* src, const void* qids, const void* src_ids,
                                        const void* g, void* flags, int flags_given, void* pos,
                                        int pos_given, void* dwc, void* queues, int tiles, int batch,
                                        int vs, int vq, int nc, int kzp, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sm_count = 0;
  err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || vs <= 0 || vq <= 0 || nc <= 0 || kzp <= 0 || n <= 0 || flags == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flags_given) {
    err = rows_prep(g, nullptr, flags, static_cast<long long>(batch) * vq, nc, n, n, 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!pos_given) {
    err = positions(qids, src_ids, nullptr, pos, batch, vs, vq, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(wgrad::launch_mma<float>(src, g, pos, flags, dwc, queues, tiles, batch, vs,
                                                   vq, kOffsets, nc, kzp, n, sm_count, s));
}
