// Weight-gradient tiles shared by the sparse-conv backward kernels
// (stencil_conv.cu, subm_conv.cu) for Hopper (sm_90a).
//
// Both weight gradients are sums of outer products over (source row, query)
// pairs, "hits": dW[j][k, n] += Σ_hits a[row(hit)][k] · g[query(hit)][n], with
// the row of a query at offset j read from a table (batch, offsets, vq) of
// positions (−1 or ≥ vs: absent), float32 sums into a zeroed output.
//
// Bound: bytes (every `a` row and every `g` row read once per hit against
// 2·K·N operations a hit on the tensor cores). What the design does about it:
//
// bfloat16 sources take the tensor-core route, `wgrad_mma_kernel`:
//   - A block owns a TK x TN tile of the weight matrices and one offset at a
//     time, so hits are found and gathered once per tile, and its float32
//     accumulators stay in registers while it works on that offset: one set
//     of atomicAdds per block and offset, not per 1,024 queries. Each hit
//     reads its `a` row once per N tile and its cotangent row once per K
//     tile, so the tile is as large as the registers allow: up to 128 x 128
//     on 8 warps (two blocks an SM) for the unit middle's and the rank
//     gather's matrices; above 128 columns (the dense-z column middle's
//     `d_wc`, 128 x 640 and 256 x 192-448) 16 warps over 128 x 256 at 128
//     lanes (the 640-column layer: three N tiles, the float32 cotangent row
//     read once) or 256 x 128 (a whole 256-lane contraction: the cotangent
//     row read once). The stencil's caller hands in the forward's position
//     table, so the backward searches no ids again.
//   - Hits are spread unevenly: the centre offset hits at every query, the
//     others at a tenth of them on a sparse cloud and at most on a dense one,
//     and the valid units fill only the head of each sample. So the work of
//     an offset is a queue of units of a few thousand queries, blocks start
//     on different offsets, pull units until the queue is empty, put their
//     sums out and move on to the next offset.
//   - Hits of 1,024 queries are compacted in query order (ballot + popc prefix),
//     staged 64 at a time into shared memory (16-byte loads where rows are
//     aligned), and are the contraction dimension of `mma.sync.m16n8k16`;
//     `ldmatrix.trans` turns the hit-major rows into the aᵀ and g operands.
//     The last group of 16 is padded with zeros.
//   - A float32 cotangent (the stencil's) is split as g = g_hi + g_lo, two
//     bfloat16 values and two MMAs, which keeps 16 bits of it; a bfloat16
//     cotangent (the rank gather's) takes one MMA.
//   - A tensor core's running sum is not a float32 sum: earlier parts are
//     reported to round it towards zero (not measured on this one), which
//     would bias a sum of 300,000 products by thousands of ulps. So every
//     group of 16 hits is multiplied into a fresh zero accumulator and added
//     to the thread's running sums with an ordinary round-to-nearest float32
//     add.
//   - A flag per query drops hits whose cotangent row is all zero before
//     anything is gathered (it wins where the caps leave 3% of the rows a
//     gradient and ties where most rows have one: PERF.md).
//   - Small matrices (up to 32 x 32 and 64 x 64) give every warp the whole
//     tile and deal the groups of hits round the warps; the warps' sums meet
//     in shared memory before the atomics.
// float32 sources keep the float32 FMA route, `accumulate_tile`: float32 is
// the type of the gradient checks (1e-5 / 5e-5), which TF32 would break.
//
// The order of the atomics varies from run to run, so the sums agree to
// float32 rounding and not bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace wgrad {

// ---------------------------------------------------------------------------
// float32 route: a 64 x 64 FMA tile over the compacted hits of 1,024 queries.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWgK = 64;       // rows of the weight tile (lanes of `a`)
constexpr int kWgN = 64;       // columns of the weight tile (lanes of `g`)
constexpr int kWgQ = 16;       // hits staged at a time
constexpr int kQueries = 1024; // queries a block compacts

// Appends (row, query) to the block's compacted hit list.
__device__ __forceinline__ void push_hit(int* hit_row, int* hit_q, int* count, int row, int q) {
  const int slot = atomicAdd(count, 1);
  hit_row[slot] = row;
  hit_q[slot] = q;
}

// out[(k0 + i) · out_stride + n0 + m] += Σ_h a[hit_row[h] · a_stride + k0 + i] ·
// g[hit_q[h] · g_stride + n0 + m] for i < kw, m < nw. All threads of the
// block call it; `hit_row`/`hit_q` lie in shared memory.
__device__ __forceinline__ void accumulate_tile(
    const float* __restrict__ a, long long a_stride, const float* __restrict__ g, long long g_stride,
    const int* hit_row, const int* hit_q, int nhits, int k0, int kw, int n0, int nw,
    float* __restrict__ out, int out_stride) {
  __shared__ __align__(16) float a_s[kWgQ][kWgK];
  __shared__ __align__(16) float g_s[kWgQ][kWgN];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;

  for (int h0 = 0; h0 < nhits; h0 += kWgQ) {
    for (int item = tid; item < kWgQ * kWgK; item += kThreads) {
      const int h = item / kWgK;
      const int lane = item - h * kWgK;
      float v = 0.0f;
      if (h0 + h < nhits && lane < kw) {
        v = a[static_cast<long long>(hit_row[h0 + h]) * a_stride + k0 + lane];
      }
      a_s[h][lane] = v;
    }
    for (int item = tid; item < kWgQ * kWgN; item += kThreads) {
      const int h = item / kWgN;
      const int lane = item - h * kWgN;
      float v = 0.0f;
      if (h0 + h < nhits && lane < nw) {
        v = g[static_cast<long long>(hit_q[h0 + h]) * g_stride + n0 + lane];
      }
      g_s[h][lane] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int h = 0; h < kWgQ; ++h) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[h][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&g_s[h][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[i][m] = fmaf(av[i], gv[m], acc[i][m]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = ty * 4 + i;
    if (k >= kw) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = tx * 4 + m;
      if (n < nw && acc[i][m] != 0.0f) {
        atomicAdd(out + static_cast<long long>(k0 + k) * out_stride + n0 + n, acc[i][m]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMmaRounds = 4;      // queries a thread looks up in one compaction
constexpr int kMmaHits = 64;      // hits staged at a time
constexpr int kMmaPad = 8;        // bfloat16 elements of row padding (no ldmatrix bank conflicts)
constexpr int kStageBatch = 4;    // 16-byte loads a thread keeps in flight while staging

// Tile geometry: THREADS / 32 warps, WK x WN of them over the TK x TN tile,
// each MT m-tiles of 16 weight rows by NT n-tiles of 8 columns; the others
// split the hits. A block compacts THREADS · kMmaRounds queries at a time.
template <typename TG, int MT, int NT, int WK, int WN, int THREADS = 256>
struct MmaTile {
  static_assert(NT % 2 == 0, "n-tiles come in pairs (ldmatrix.x4)");
  static constexpr int kThreads = THREADS;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kQueries = THREADS * kMmaRounds;
  static_assert(kWarps % (WK * WN) == 0, "warps must divide");
  static constexpr int kTK = WK * MT * 16;
  static constexpr int kTN = WN * NT * 8;
  static constexpr int kWH = kWarps / (WK * WN);
  static constexpr int kLda = kTK + kMmaPad;
  static constexpr int kLdg = kTN + kMmaPad;
  static constexpr bool kSplit = sizeof(TG) == 4;  // float32 cotangent: hi + lo
  static constexpr int kStageBytes =
      kMmaHits * (kLda + kLdg * (kSplit ? 2 : 1)) * static_cast<int>(sizeof(__nv_bfloat16));
  static constexpr int kReduceBytes = kWH > 1 ? kTK * kTN * static_cast<int>(sizeof(float)) : 0;
  static constexpr int kSmemBytes = kStageBytes > kReduceBytes ? kStageBytes : kReduceBytes;
};

__device__ __forceinline__ float g_to_float(float v) { return v; }
__device__ __forceinline__ float g_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Stages rows idx[0, hcount) of `src` (lanes col0 .. col0 + valid) into
// dst[h · ld + lane], h < h16, lane < cols (a multiple of 16), zero beyond the
// hits and beyond `valid`; 16-byte accesses where the rows are aligned. All
// THREADS threads of the block call it.
template <int THREADS>
__device__ __forceinline__ void stage_rows(
    const __nv_bfloat16* __restrict__ src, long long stride, long long col0, int valid, int cols,
    const int* idx, int hcount, int h16, __nv_bfloat16* dst, __nv_bfloat16* /*no low half*/, int ld) {
  const int tid = threadIdx.x;
  if (stride % 8 == 0 && col0 % 8 == 0 && valid % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    // Four loads in flight a thread before the first store.
    const int segs = cols / 8;
    const int items = h16 * segs;
    for (int first = tid; first < items; first += THREADS * kStageBatch) {
      uint4 v[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int item = first + u * THREADS;
        const int h = item / segs;
        const int s = item - h * segs;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (item < items && h < hcount && s * 8 < valid) {
          v[u] = *reinterpret_cast<const uint4*>(src + static_cast<long long>(idx[h]) * stride + col0 + s * 8);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int item = first + u * THREADS;
        const int h = item / segs;
        if (item < items) *reinterpret_cast<uint4*>(dst + h * ld + (item - h * segs) * 8) = v[u];
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int item = tid; item < h16 * cols; item += THREADS) {
      const int h = item / cols;
      const int col = item - h * cols;
      __nv_bfloat16 v = zero;
      if (h < hcount && col < valid) v = src[static_cast<long long>(idx[h]) * stride + col0 + col];
      dst[h * ld + col] = v;
    }
  }
}

// The same for float32 rows, split as hi + lo: hi = bfloat16(v), lo =
// bfloat16(v − hi).
template <int THREADS>
__device__ __forceinline__ void stage_rows(
    const float* __restrict__ src, long long stride, long long col0, int valid, int cols,
    const int* idx, int hcount, int h16, __nv_bfloat16* hi, __nv_bfloat16* lo, int ld) {
  const int tid = threadIdx.x;
  if (stride % 4 == 0 && col0 % 4 == 0 && valid % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int segs = cols / 4;
    const int items = h16 * segs;
    for (int first = tid; first < items; first += THREADS * kStageBatch) {
      float4 v[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int item = first + u * THREADS;
        const int h = item / segs;
        const int s = item - h * segs;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (item < items && h < hcount && s * 4 < valid) {
          v[u] = *reinterpret_cast<const float4*>(src + static_cast<long long>(idx[h]) * stride + col0 + s * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int item = first + u * THREADS;
        if (item >= items) continue;
        const int h = item / segs;
        const int s = item - h * segs;
        const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        __nv_bfloat16 fh[4], fl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fh[e] = __float2bfloat16_rn(f[e]);
          fl[e] = __float2bfloat16_rn(f[e] - __bfloat162float(fh[e]));
        }
        *reinterpret_cast<uint2*>(hi + h * ld + s * 4) = make_uint2(pack_bf16(fh[0], fh[1]), pack_bf16(fh[2], fh[3]));
        *reinterpret_cast<uint2*>(lo + h * ld + s * 4) = make_uint2(pack_bf16(fl[0], fl[1]), pack_bf16(fl[2], fl[3]));
      }
    }
  } else {
    for (int item = tid; item < h16 * cols; item += THREADS) {
      const int h = item / cols;
      const int col = item - h * cols;
      float v = 0.0f;
      if (h < hcount && col < valid) v = src[static_cast<long long>(idx[h]) * stride + col0 + col];
      const __nv_bfloat16 vh = __float2bfloat16_rn(v);
      hi[h * ld + col] = vh;
      lo[h * ld + col] = __float2bfloat16_rn(v - __bfloat162float(vh));
    }
  }
}

// One flag per row of `rows` (n_rows, width): 1 where any element is non-zero.
// A warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
row_flags_kernel(const T* __restrict__ rows, uint8_t* __restrict__ flags, long long n_rows, int width) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const T* r = rows + row * width;
  bool nz = false;
  for (int i = lane; i < width; i += 32) nz = nz || (g_to_float(r[i]) != 0.0f);
  const unsigned any = __ballot_sync(0xffffffffu, nz);
  if (lane == 0) flags[row] = any != 0u;
}

template <typename T>
cudaError_t launch_row_flags(const void* rows, void* flags, long long n_rows, int width,
                             cudaStream_t stream) {
  if (n_rows == 0) return cudaSuccess;
  const long long blocks = (n_rows + 7) / 8;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  row_flags_kernel<T><<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<uint8_t*>(flags), n_rows, width);
  return cudaGetLastError();
}

// dw (offsets, K, N) += the weight gradient, with atomicAdds. `a` (batch, vs,
// nc·K) bfloat16; `g` (batch, vq, nc·N); `table` (batch, offsets, vq); `flags`
// (batch, vq), 0 where g's row is all zero; `queues` (gridDim.y, offsets) int32, zeroed by the
// caller. One block: one (TK x TN) tile of the weight matrices (blockIdx.y)
// and, one offset after the other starting at blockIdx.x % offsets, whatever
// work units (`unit_tiles` tiles of kMmaQueries queries of the flattened
// (sample, query) space) it pulls from that offset's queue; its sums for an
// offset go out when the queue is empty.
template <typename TG, int MT, int NT, int WK, int WN, int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ a, const TG* __restrict__ g,
                 const int32_t* __restrict__ table, const uint8_t* __restrict__ flags,
                 float* __restrict__ dw, int* __restrict__ queues, int batch, int vs, int vq,
                 int offsets, int nc, int K, int N, int n_tiles, int unit_tiles) {
  using Tile = MmaTile<TG, MT, NT, WK, WN, THREADS>;
  constexpr int kLda = Tile::kLda;
  constexpr int kLdg = Tile::kLdg;
  constexpr int kMmaWarps = Tile::kWarps;
  constexpr int kMmaQueries = Tile::kQueries;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int hit_row[kMmaQueries];
  __shared__ int hit_q[kMmaQueries];
  __shared__ int warp_count[kMmaRounds * kMmaWarps];
  __shared__ int pulled;
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ghi_s = a_s + kMmaHits * kLda;
  __nv_bfloat16* glo_s = ghi_s + kMmaHits * kLdg;  // only with a float32 cotangent

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wk = warp % WK;
  const int wn = (warp / WK) % WN;
  const int wh = warp / (WK * WN);
  const int kt = blockIdx.y / n_tiles;
  const int k0 = kt * Tile::kTK;
  const int n0 = (blockIdx.y - kt * n_tiles) * Tile::kTN;
  const int kw = min(Tile::kTK, K - k0);
  const int nw = min(Tile::kTN, N - n0);
  const int kcols = (kw + 15) & ~15;
  const int ncols = (nw + 15) & ~15;
  const long long a_stride = static_cast<long long>(nc) * K;
  const long long g_stride = static_cast<long long>(nc) * N;
  const int tiles_per_sample = (vq + kMmaQueries - 1) / kMmaQueries;
  const int tiles = batch * tiles_per_sample;
  const int units = (tiles + unit_tiles - 1) / unit_tiles;
  int* queue = queues + blockIdx.y * offsets;
  const int gq = lane / 4;
  const int tq = lane % 4;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int turn = 0; turn < offsets; ++turn) {
    const int j = (blockIdx.x + turn) % offsets;
    bool dirty = false;
    while (true) {
      if (tid == 0) pulled = atomicAdd(queue + j, 1);
      __syncthreads();
      const int unit = pulled;
      __syncthreads();  // everyone has read `pulled` before it is written again
      if (unit >= units) break;
      const int tile_end = min(tiles, (unit + 1) * unit_tiles);
      for (int tile = unit * unit_tiles; tile < tile_end; ++tile) {
        const int b = tile / tiles_per_sample;
        const int q_base = (tile - b * tiles_per_sample) * kMmaQueries;
        // Compaction in query order: kMmaRounds ballots a warp, then a prefix
        // over the (round, warp) counts.
        int row[kMmaRounds];
        unsigned ballot[kMmaRounds];
#pragma unroll
        for (int r = 0; r < kMmaRounds; ++r) {
          const int q = q_base + r * THREADS + tid;
          row[r] = -1;
          if (q < vq) {
            const int p = table[(static_cast<long long>(b) * offsets + j) * vq + q];
            if (p >= 0 && p < vs && flags[static_cast<long long>(b) * vq + q] != 0) row[r] = p;
          }
          ballot[r] = __ballot_sync(0xffffffffu, row[r] >= 0);
          if (lane == 0) warp_count[r * kMmaWarps + warp] = __popc(ballot[r]);
        }
        __syncthreads();
        int base[kMmaRounds];
        int total = 0;
#pragma unroll
        for (int i = 0; i < kMmaRounds * kMmaWarps; ++i) {
          if (i % kMmaWarps == warp) base[i / kMmaWarps] = total;
          total += warp_count[i];
        }
#pragma unroll
        for (int r = 0; r < kMmaRounds; ++r) {
          if (row[r] >= 0) {
            const int slot = base[r] + __popc(ballot[r] & ((1u << lane) - 1u));
            hit_row[slot] = b * vs + row[r];
            hit_q[slot] = b * vq + q_base + r * THREADS + tid;
          }
        }
        __syncthreads();
        if (total == 0) continue;
        dirty = true;

        for (int h0 = 0; h0 < total; h0 += kMmaHits) {
          const int hcount = min(kMmaHits, total - h0);
          const int h16 = (hcount + 15) & ~15;
          for (int chunk = 0; chunk < nc; ++chunk) {
            const long long a_col = static_cast<long long>(chunk) * K + k0;
            const long long g_col = static_cast<long long>(chunk) * N + n0;
            // The gathered `a` rows and the cotangent rows (a float32 one as hi + lo).
            stage_rows<THREADS>(a, a_stride, a_col, kw, kcols, hit_row + h0, hcount, h16, a_s, nullptr, kLda);
            stage_rows<THREADS>(g, g_stride, g_col, nw, ncols, hit_q + h0, hcount, h16, ghi_s, glo_s, kLdg);
            __syncthreads();

            for (int grp = wh; grp < h16 / 16; grp += Tile::kWH) {
              const int hb = grp * 16;
              uint32_t afr[MT][4];
#pragma unroll
              for (int mi = 0; mi < MT; ++mi) {
                const int m0 = (wk * MT + mi) * 16;
                if (m0 < kw) {
                  mma::ldmatrix_x4_trans(
                      afr[mi], mma::smem_addr(a_s + (hb + (lane & 7) + ((lane >> 4) << 3)) * kLda + m0 +
                                              (((lane >> 3) & 1) << 3)));
                }
              }
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                const int c0 = (wn * NT + 2 * np) * 8;
                if (c0 >= nw) continue;
                const int g_off = (hb + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdg + c0 + ((lane >> 4) << 3);
                uint32_t bhi[4], blo[4];
                mma::ldmatrix_x4_trans(bhi, mma::smem_addr(ghi_s + g_off));
                if (Tile::kSplit) mma::ldmatrix_x4_trans(blo, mma::smem_addr(glo_s + g_off));
#pragma unroll
                for (int mi = 0; mi < MT; ++mi) {
                  if ((wk * MT + mi) * 16 >= kw) continue;
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    if (c0 + half * 8 >= nw) continue;
                    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    if (Tile::kSplit) mma::mma_bf16(c, afr[mi], blo[2 * half], blo[2 * half + 1]);
                    mma::mma_bf16(c, afr[mi], bhi[2 * half], bhi[2 * half + 1]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][2 * np + half][e] += c[e];
                  }
                }
              }
            }
            __syncthreads();
          }
        }
      }
    }
    if (!dirty) continue;

    // This offset's sums go out: the warps that split the hits meet in shared
    // memory; then one atomicAdd for each non-zero element of the tile.
    float* out = dw + static_cast<long long>(j) * K * N;
    if (Tile::kWH > 1) {
      float* red = reinterpret_cast<float*>(smem);
      for (int i = tid; i < Tile::kTK * Tile::kTN; i += THREADS) red[i] = 0.0f;
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = (wk * MT + mi) * 16 + gq + (e >> 1) * 8;
            const int n = (wn * NT + ni) * 8 + tq * 2 + (e & 1);
            if (acc[mi][ni][e] != 0.0f) atomicAdd(red + m * Tile::kTN + n, acc[mi][ni][e]);
            acc[mi][ni][e] = 0.0f;
          }
      __syncthreads();
      for (int i = tid; i < Tile::kTK * Tile::kTN; i += THREADS) {
        const int m = i / Tile::kTN;
        const int n = i - m * Tile::kTN;
        const float v = red[i];
        if (m < kw && n < nw && v != 0.0f) atomicAdd(out + static_cast<long long>(k0 + m) * N + n0 + n, v);
      }
      __syncthreads();  // `red` is the next offset's staging area
    } else {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = (wk * MT + mi) * 16 + gq + (e >> 1) * 8;
            const int n = (wn * NT + ni) * 8 + tq * 2 + (e & 1);
            const float v = acc[mi][ni][e];
            if (m < kw && n < nw && v != 0.0f) atomicAdd(out + static_cast<long long>(k0 + m) * N + n0 + n, v);
            acc[mi][ni][e] = 0.0f;
          }
    }
  }
}

template <typename TG, int MT, int NT, int WK, int WN, int THREADS = 256>
cudaError_t launch_mma_tile(const void* a, const void* g, const void* table, const void* flags,
                            void* dw, void* queues, int queue_tiles, int batch, int vs, int vq,
                            int offsets, int nc, int K, int N, int sm_count, cudaStream_t stream) {
  using Tile = MmaTile<TG, MT, NT, WK, WN, THREADS>;
  const int k_tiles = (K + Tile::kTK - 1) / Tile::kTK;
  const int n_tiles = (N + Tile::kTN - 1) / Tile::kTN;
  // The caller sized `queues` by its own reckoning of the tiles.
  if (static_cast<long long>(k_tiles) * n_tiles != queue_tiles) return cudaErrorInvalidValue;
  if (static_cast<long long>(k_tiles) * n_tiles > 65535) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(batch) * ((vq + Tile::kQueries - 1) / Tile::kQueries);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  // About three 256-thread blocks an SM in all (one of 512 threads), at least
  // one an offset to start with; some eight work units a block and offset, so
  // that late blocks find work.
  long long blocks = ((THREADS == 256 ? 3LL : 1LL) * sm_count) / (static_cast<long long>(k_tiles) * n_tiles);
  if (blocks < offsets) blocks = offsets;
  if (blocks > tiles * offsets) blocks = tiles * offsets;
  long long unit_tiles = tiles * offsets / (8 * blocks);
  if (unit_tiles < 1) unit_tiles = 1;
  if (unit_tiles > 8) unit_tiles = 8;
  auto kernel = wgrad_mma_kernel<TG, MT, NT, WK, WN, THREADS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(k_tiles * n_tiles));
  kernel<<<grid, THREADS, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const TG*>(g),
      static_cast<const int32_t*>(table), static_cast<const uint8_t*>(flags),
      static_cast<float*>(dw), static_cast<int*>(queues), batch, vs, vq, offsets, nc, K, N, n_tiles,
      static_cast<int>(unit_tiles));
  return cudaGetLastError();
}

// The tile by the shape of one offset's K x N weight matrix: above 128
// columns (the dense-z column middle's outputs; at most 640 x 640) 16 warps
// of 32 x 64 over 128 x 256 where K ≤ 128, else over 256 x 128;
// otherwise up to 32 x 32 and up to 64 x 64 whole in every warp, anything
// larger in 128 x 128 tiles. `queue_tiles`: the tiles of one weight matrix
// that `queues` was sized for.
template <typename TG>
cudaError_t launch_mma(const void* a, const void* g, const void* table, const void* flags, void* dw,
                       void* queues, int queue_tiles, int batch, int vs, int vq, int offsets, int nc,
                       int K, int N, int sm_count, cudaStream_t stream) {
  if (batch <= 0 || vq <= 0 || offsets <= 0 || nc <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  if (N > 128 && K <= 640 && N <= 640) {
    if (K <= 128) {
      return launch_mma_tile<TG, 2, 8, 4, 4, 512>(a, g, table, flags, dw, queues, queue_tiles, batch, vs, vq,
                                                 offsets, nc, K, N, sm_count, stream);
    }
    return launch_mma_tile<TG, 2, 8, 8, 2, 512>(a, g, table, flags, dw, queues, queue_tiles, batch, vs, vq,
                                               offsets, nc, K, N, sm_count, stream);
  }
  if (K <= 32 && N <= 32) {
    return launch_mma_tile<TG, 2, 4, 1, 1>(a, g, table, flags, dw, queues, queue_tiles, batch, vs, vq, offsets, nc, K, N, sm_count, stream);
  }
  if (K <= 64 && N <= 64) {
    return launch_mma_tile<TG, 2, 8, 2, 1>(a, g, table, flags, dw, queues, queue_tiles, batch, vs, vq, offsets, nc, K, N, sm_count, stream);
  }
  return launch_mma_tile<TG, 2, 8, 4, 2>(a, g, table, flags, dw, queues, queue_tiles, batch, vs, vq, offsets, nc, K, N, sm_count, stream);
}

}  // namespace wgrad
