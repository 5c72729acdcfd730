// Tensor-core gather-conv tile for Hopper (sm_90a), shared by the two
// sparse-conv kernels: the 9-offset stencil (stencil_conv.cu) and the
// 27-offset rank gather-GEMM (subm_conv.cu), forward and feature gradient.
//
//   out[b, q, c·N:(c+1)·N] = Σ_{j<offsets} src[b, pos[b, j, q]][c·kp:(c+1)·kp] @ W[j]
//
// with pos −1 (or ≥ vs) an absent row. The caller turns its own index into
// `pos` (the stencil searches ids, the rank gather has ranks already) and
// prepares the weights once a launch (`weight_prep_kernel`): W[j] as
// (n_pad, kp) bfloat16, the contraction index contiguous and zero-padded,
// with one bit for every 16 x 8 block that holds a non-zero.
//
// `conv_mma_kernel`: a block owns 128 queries and all output columns up to
// the tile's width (128 or 256), so a query's rows are gathered once; wider
// outputs take a grid dimension of column tiles, and each tile's block
// gathers its queries' rows again. It walks the (offset, SLICE-lane slice)
// pairs that have both a hit in the tile and a non-zero weight block,
// through a ring of shared-memory stages filled by 16-byte `cp.async` (rows
// of misses are zero-filled, 16-query groups without a hit are not copied at
// all) STAGES − 1 stages ahead of the `mma.sync.m16n8k16` that consume them.
// Queries are the M dimension, so a result row is its query's row and the
// float32 accumulators stay in registers until the one store: hits are not
// compacted (on the tensor cores the products on zero rows cost little, and
// a compacted tile would have to scatter its rows back), but 16-query groups
// without a hit at an offset and pairs of weight blocks (16 lanes x 16
// columns) without a non-zero are skipped. bfloat16 products are exact in
// float32: the result differs from a float32 sum by order only.
//
// SLICE is the contraction a stage holds: 64 lanes for the stencil's wide
// band rows, 16 or 32 for the rank gather's 16- and 32-channel rows, so that
// a narrow layer does not pad its rows to 64. The contraction is at most
// MAXSTEPS 16-lane steps: 16 (256 lanes) for the rank gather, 40 (640) for
// the stencil, whose feature gradient contracts over a dense-z column's
// output (up to 640 lanes). The ring holds one slice a stage whatever the
// contraction, so its shared memory does not grow with it.
//
// The block bitmap of the weights has one 32-bit word for every (offset,
// 256-column tile, 16-lane step), bit o / 8 for the tile's column o:
// wmask[(j·mask_tiles(n_pad) + t)·mask_steps(kp) + step]. Up to 256 lanes
// and 256 columns that is the (offsets, 16) table of one tile. Rows whose width is not a
// multiple of 16 lanes are first copied into padded bfloat16 rows
// (`rows_prep_kernel`), which also converts float32 and can flag zero rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgrad_tile.cuh"

namespace convmma {

constexpr int kPrepThreads = 256;
constexpr int kMaxSteps = 16;      // 16-lane steps of the rank gather's contraction: kp ≤ 256
constexpr int kMaxStepsWide = 40;  // of the stencil's: kp ≤ 640
constexpr int kMaskCols = 256;     // columns of one bitmap word (a bit each 8)

// Words of the bitmap a (offset, column tile): whole 16-step rows, as before
// the contraction grew, so that narrow weights keep the (offsets, 16) table.
__host__ __device__ inline int mask_steps(int kp) { return kp / 16 > kMaxSteps ? kp / 16 : kMaxSteps; }
__host__ __device__ inline int mask_tiles(int n_pad) { return (n_pad + kMaskCols - 1) / kMaskCols; }

// wt[j, o, k] = w[j·sj + k·sk + o·so] for o < n_out, k < k_in, zero up to
// (n_pad, kp); the bitmap word of (j, o / 256, k / 16) has bit (o % 256) / 8
// set where the 16 x 8 block holds a non-zero. One block: one offset
// (blockIdx.y), one 16-lane step, one 256-column tile (blockIdx.z).
__global__ void __launch_bounds__(kPrepThreads)
weight_prep_kernel(const __nv_bfloat16* __restrict__ w, long long sj, long long sk, long long so,
                   __nv_bfloat16* __restrict__ wt, uint32_t* __restrict__ wmask, int k_in, int n_out,
                   int kp, int n_pad) {
  __shared__ unsigned int mask;
  const int j = blockIdx.y;
  const int step = blockIdx.x;
  const int tile = blockIdx.z;
  const int o0 = tile * kMaskCols;
  const int cols = min(kMaskCols, n_pad - o0);
  if (threadIdx.x == 0) mask = 0u;
  __syncthreads();
  unsigned int mine = 0u;
  for (int item = threadIdx.x; item < cols * 16; item += kPrepThreads) {
    const int ol = item / 16;
    const int o = o0 + ol;
    const int k = step * 16 + (item - ol * 16);
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (o < n_out && k < k_in) v = w[j * sj + k * sk + o * so];
    wt[(static_cast<long long>(j) * n_pad + o) * kp + k] = v;
    if (__bfloat162float(v) != 0.0f) mine |= 1u << (ol / 8);
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (threadIdx.x % 32 == 0 && mine != 0u) atomicOr(&mask, mine);
  __syncthreads();
  if (threadIdx.x == 0) wmask[(j * mask_tiles(n_pad) + tile) * mask_steps(kp) + step] = mask;
}

// out[r, c·kp + k] = bfloat16(in[r, c·k_in + k]) for k < k_in, zero up to kp;
// flags[r] (unless null) = any element of row r is non-zero. A warp a row.
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
rows_prep_kernel(const T* __restrict__ in, __nv_bfloat16* __restrict__ out,
                 uint8_t* __restrict__ flags, long long n_rows, int nc, int k_in, int kp) {
  const long long row = static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const T* r = in + row * nc * k_in;
  bool nz = false;
  __nv_bfloat16* o = out + row * nc * kp;
  for (int i = lane; i < nc * kp; i += 32) {
    const int c = i / kp;
    const int k = i - c * kp;
    float v = 0.0f;
    if (k < k_in) v = wgrad::g_to_float(r[c * k_in + k]);
    nz = nz || (v != 0.0f);
    o[i] = __float2bfloat16_rn(v);
  }
  const unsigned any = __ballot_sync(0xffffffffu, nz);
  if (lane == 0 && flags != nullptr) flags[row] = any != 0u;
}

// wt (offsets, n_pad, kp) bfloat16 and wmask (offsets, mask_tiles(n_pad),
// mask_steps(kp)) uint32 from bfloat16 weights whose element (j, k, o) lies
// at w[j·sj + k·sk + o·so]; kp a multiple of 16 up to 640, n_pad a multiple
// of 16.
inline cudaError_t weight_prep(const void* w, long long sj, long long sk, long long so, void* wt,
                               void* wmask, int offsets, int k_in, int n_out, int kp, int n_pad,
                               cudaStream_t stream) {
  if (offsets <= 0 || offsets > 65535 || kp <= 0 || kp % 16 != 0 || kp / 16 > kMaxStepsWide || n_pad <= 0 ||
      n_pad % 16 != 0 || mask_tiles(n_pad) > 65535 || k_in > kp || n_out > n_pad) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(kp / 16, offsets, mask_tiles(n_pad));
  weight_prep_kernel<<<grid, kPrepThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w), sj, sk, so, static_cast<__nv_bfloat16*>(wt),
      static_cast<uint32_t*>(wmask), k_in, n_out, kp, n_pad);
  return cudaGetLastError();
}

// Rows (n_rows, nc·k_in) of `dtype` (0 float32, 1 bfloat16) → out (n_rows,
// nc·kp) bfloat16, each chunk zero-padded, and, unless `flags` is null,
// flags (n_rows) uint8: 1 where the row holds a non-zero.
inline cudaError_t rows_prep(const void* in, void* out, void* flags, long long n_rows, int nc, int k_in,
                             int kp, int dtype, cudaStream_t stream) {
  if (n_rows == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const long long blocks = (n_rows + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (dtype == 0) {
    rows_prep_kernel<float><<<grid, kPrepThreads, 0, stream>>>(
        static_cast<const float*>(in), static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(flags), n_rows,
        nc, k_in, kp);
  } else {
    rows_prep_kernel<__nv_bfloat16><<<grid, kPrepThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(flags),
        n_rows, nc, k_in, kp);
  }
  return cudaGetLastError();
}

// WM x WN warps; a warp owns MT m-tiles of 16 queries and NT n-tiles of 8
// columns: the block 16·WM·MT queries and 8·WN·NT columns (a column tile of
// 256 columns or a divisor of 256). MAXOFF offsets at most, SLICE contraction
// lanes a stage, MAXSTEPS 16-lane steps of contraction at most. POS_SMEM keeps the block's positions
// in shared memory after the first read (MAXOFF x 128 int32 behind the ring),
// so that filling a stage waits on no global load; without it a stage's fill
// reads them again from L2, which leaves the stencil's wide ring two blocks
// an SM.
template <int MAXOFF, int SLICE, int WM, int WN, int MT, int NT, int STAGES, bool POS_SMEM,
          int MAXSTEPS = kMaxSteps>
struct ConvTile {
  static_assert(NT % 2 == 0, "n-tiles come in pairs (ldmatrix.x4)");
  static_assert(SLICE % 16 == 0 && (MAXSTEPS * 16) % SLICE == 0, "a slice is whole 16-lane steps");
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kQueries = WM * MT * 16;
  static constexpr int kCols = WN * NT * 8;
  static_assert(kMaskCols % kCols == 0, "a column tile lies in one bitmap word");
  static constexpr int kLd = SLICE + 8;  // shared-memory row stride (no ldmatrix bank conflicts)
  static constexpr int kMaxSlices = MAXSTEPS * 16 / SLICE;
  static constexpr int kStageElems = (kQueries + kCols) * kLd;
  static constexpr int kRingBytes = STAGES * kStageElems * static_cast<int>(sizeof(__nv_bfloat16));
  static constexpr int kSmemBytes = kRingBytes + (POS_SMEM ? MAXOFF * kQueries * 4 : 0);
  static_assert(kQueries <= 512, "one bit a 16-query group in a 32-bit word");
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// src (batch, vs, nc·kp) bfloat16, pos (batch, offsets, vq) int32, wt and
// wmask from weight_prep; out (batch, vq, nc·n) of TO: float32, or bfloat16,
// the float32 sums rounded once here instead of in a pass of their own.
// grid (query tiles, nc · column tiles, batch), the column tile minor.
template <int MAXOFF, int SLICE, int WM, int WN, int MT, int NT, int STAGES, bool POS_SMEM, typename TO,
          int MAXSTEPS = kMaxSteps>
__global__ void __launch_bounds__(WM * WN * 32, 512 / (WM * WN * 32))
conv_mma_kernel(const __nv_bfloat16* __restrict__ src, const int32_t* __restrict__ pos,
                const __nv_bfloat16* __restrict__ wt, const uint32_t* __restrict__ wmask,
                TO* __restrict__ out, int offsets, int vs, int vq, int nc, int kp, int n, int n_pad,
                int col_tiles) {
  using Tile = ConvTile<MAXOFF, SLICE, WM, WN, MT, NT, STAGES, POS_SMEM, MAXSTEPS>;
  constexpr int kT = Tile::kThreads;
  constexpr int kQ = Tile::kQueries;
  constexpr int kLd = Tile::kLd;
  constexpr int kMaxSlices = Tile::kMaxSlices;
  constexpr int kKs = SLICE / 16;
  constexpr int kTileBits = Tile::kCols / 8;
  constexpr uint32_t kTileMask = kTileBits == 32 ? 0xffffffffu : (1u << kTileBits) - 1u;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int32_t* pos_s = reinterpret_cast<int32_t*>(smem_raw + Tile::kRingBytes);  // POS_SMEM only
  // This column tile's bits of the bitmap, shifted down to bit 0.
  __shared__ uint32_t wmask_s[MAXOFF * MAXSTEPS];
  __shared__ unsigned int mt_any_s[MAXOFF];
  __shared__ int list_s[MAXOFF * kMaxSlices];
  __shared__ int n_it_s;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int b = blockIdx.z;
  const int chunk = blockIdx.y / col_tiles;
  const int col0 = (blockIdx.y - chunk * col_tiles) * Tile::kCols;
  const int tile_cols = min(Tile::kCols, n_pad - col0);
  const int q0 = blockIdx.x * kQ;
  const int steps = kp / 16;
  const int msteps = mask_steps(kp);
  const int mword = col0 / kMaskCols;
  const int mshift = (col0 - mword * kMaskCols) / 8;
  const int mtiles = mask_tiles(n_pad);
  const long long width = static_cast<long long>(nc) * kp;
  const __nv_bfloat16* src_b = src + static_cast<long long>(b) * vs * width + static_cast<long long>(chunk) * kp;
  const int32_t* pos_b = pos + static_cast<long long>(b) * offsets * vq;

  for (int i = tid; i < offsets * MAXSTEPS; i += kT) {
    const int j = i / MAXSTEPS;
    const int s = i - j * MAXSTEPS;
    wmask_s[i] = s < steps ? (wmask[(j * mtiles + mword) * msteps + s] >> mshift) & kTileMask : 0u;
  }
  for (int j = tid; j < offsets; j += kT) mt_any_s[j] = 0u;
  __syncthreads();
  if (POS_SMEM) {
    // The copy first, with no atomic in the loop, so that its loads overlap.
#pragma unroll 4
    for (int i = tid; i < offsets * kQ; i += kT) {
      const int j = i / kQ;
      const int q = q0 + i - j * kQ;
      const int p = q < vq ? pos_b[static_cast<long long>(j) * vq + q] : -1;
      pos_s[i] = p < vs ? p : -1;
    }
    __syncthreads();
  }
  // Which 16-query groups hit at each offset: a ballot a warp (kQ and kT are
  // whole warps, so a warp's 32 rows share an offset: two groups).
  for (int i = tid; i < offsets * kQ; i += kT) {
    const int j = i / kQ;
    const int r = i - j * kQ;
    const int q = q0 + r;
    const int p = POS_SMEM ? pos_s[i] : (q < vq ? pos_b[static_cast<long long>(j) * vq + q] : -1);
    const unsigned hits = __ballot_sync(0xffffffffu, p >= 0 && p < vs);
    if (lane == 0 && hits != 0u) {
      const unsigned bits = ((hits & 0xffffu) != 0u ? 1u : 0u) | ((hits >> 16) != 0u ? 2u : 0u);
      atomicOr(&mt_any_s[j], bits << (r / 16));
    }
  }
  __syncthreads();
  // The (offset, slice) pairs with a hit in the tile and a non-zero weight
  // block; warp 0 lists them in (offset, slice) order, 32 pairs a ballot.
  if (warp == 0) {
    const int nsl = kp / SLICE;
    int count = 0;
    for (int base = 0; base < offsets * nsl; base += 32) {
      const int idx = base + lane;
      bool take = false;
      int code = 0;
      if (idx < offsets * nsl) {
        const int j = idx / nsl;
        const int sl = idx - j * nsl;
        uint32_t any = 0u;
        for (int ks = 0; ks < kKs; ++ks) any |= wmask_s[j * MAXSTEPS + sl * kKs + ks];
        take = mt_any_s[j] != 0u && any != 0u;
        code = j * kMaxSlices + sl;
      }
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) list_s[count + __popc(m & ((1u << lane) - 1u))] = code;
      count += __popc(m);
    }
    if (lane == 0) n_it_s = count;
  }
  __syncthreads();
  const int n_it = n_it_s;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  // Copies the rows and the weights of pair `it` into its stage of the ring.
  auto fill_stage = [&](int it) {
    const int code = list_s[it];
    const int j = code / kMaxSlices;
    const int sl = code - j * kMaxSlices;
    __nv_bfloat16* a_s = stages + (it % STAGES) * Tile::kStageElems;
    __nv_bfloat16* b_s = a_s + kQ * kLd;
    const unsigned int mt_mask = mt_any_s[j];
    for (int i = tid; i < kQ * (SLICE / 8); i += kT) {
      const int r = i / (SLICE / 8);
      const int s = i - r * (SLICE / 8);
      if (((mt_mask >> (r / 16)) & 1u) == 0u) continue;
      int p;
      if (POS_SMEM) {
        p = pos_s[j * kQ + r];
      } else {
        p = q0 + r < vq ? pos_b[static_cast<long long>(j) * vq + q0 + r] : -1;
        if (p >= vs) p = -1;
      }
      const __nv_bfloat16* g = src_b + static_cast<long long>(p >= 0 ? p : 0) * width + sl * SLICE + s * 8;
      mma::cp_async_16(mma::smem_addr(a_s + r * kLd + s * 8), g, p >= 0 ? 16 : 0);
    }
    // The tile's whole slice of the weights: leaving out its zero blocks
    // measured no faster (the ring waits on latency, not on bytes).
    const __nv_bfloat16* wj = wt + (static_cast<long long>(j) * n_pad + col0) * kp + sl * SLICE;
    for (int i = tid; i < tile_cols * (SLICE / 8); i += kT) {
      const int o = i / (SLICE / 8);
      const int s = i - o * (SLICE / 8);
      mma::cp_async_16(mma::smem_addr(b_s + o * kLd + s * 8), wj + static_cast<long long>(o) * kp + s * 8, 16);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) fill_stage(s);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` has landed; everyone is done with the stage refilled next
    if (it + STAGES - 1 < n_it) fill_stage(it + STAGES - 1);
    mma::cp_async_commit();

    const int code = list_s[it];
    const int j = code / kMaxSlices;
    const int sl = code - j * kMaxSlices;
    const __nv_bfloat16* a_s = stages + (it % STAGES) * Tile::kStageElems;
    const __nv_bfloat16* b_s = a_s + kQ * kLd;
    const unsigned int mt_mask = mt_any_s[j] >> (wm * MT);
    if ((mt_mask & ((1u << MT) - 1u)) == 0u) continue;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const uint32_t m = (wmask_s[j * MAXSTEPS + sl * kKs + ks] >> (wn * NT)) & ((1u << NT) - 1u);
      if (m == 0u) continue;
      uint32_t afr[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (((mt_mask >> mi) & 1u) == 0u) continue;
        mma::ldmatrix_x4(afr[mi], mma::smem_addr(a_s + ((wm * MT + mi) * 16 + (lane & 15)) * kLd +
                                                 ks * 16 + ((lane >> 4) << 3)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (((m >> (2 * np)) & 3u) == 0u) continue;
        uint32_t bfr[4];
        mma::ldmatrix_x4(bfr, mma::smem_addr(b_s + ((wn * NT + 2 * np) * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                             ks * 16 + (((lane >> 3) & 1) << 3)));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (((mt_mask >> mi) & 1u) == 0u) continue;
          mma::mma_bf16(acc[mi][2 * np], afr[mi], bfr[0], bfr[1]);
          mma::mma_bf16(acc[mi][2 * np + 1], afr[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();

  const long long out_width = static_cast<long long>(nc) * n;
  TO* o = out + static_cast<long long>(b) * vq * out_width + static_cast<long long>(chunk) * n;
  const int gq = lane / 4;
  const int tq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + (wm * MT + mi) * 16 + gq + (e >> 1) * 8;
        const int col = col0 + (wn * NT + ni) * 8 + tq * 2 + (e & 1);
        if (q < vq && col < n) store_out(o + static_cast<long long>(q) * out_width + col, acc[mi][ni][e]);
      }
}

// Launches conv_mma_kernel with its dynamic shared memory; kp a multiple of
// SLICE of at most MAXSTEPS steps, offsets ≤ MAXOFF; n_pad wider than the
// tile's columns takes several column tiles.
template <int MAXOFF, int SLICE, int WM, int WN, int MT, int NT, int STAGES, bool POS_SMEM, typename TO,
          int MAXSTEPS = kMaxSteps>
cudaError_t launch_conv_mma(const void* src, const void* pos, const void* wt, const void* wmask, void* out,
                            int batch, int offsets, int vs, int vq, int nc, int kp, int n, int n_pad,
                            cudaStream_t stream) {
  using Tile = ConvTile<MAXOFF, SLICE, WM, WN, MT, NT, STAGES, POS_SMEM, MAXSTEPS>;
  const int col_tiles = (n_pad + Tile::kCols - 1) / Tile::kCols;
  if (offsets <= 0 || offsets > MAXOFF || kp <= 0 || kp % SLICE != 0 || kp / 16 > MAXSTEPS || n_pad <= 0 ||
      n_pad % 16 != 0 || n > n_pad || batch > 65535 || static_cast<long long>(nc) * col_tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  auto kernel = conv_mma_kernel<MAXOFF, SLICE, WM, WN, MT, NT, STAGES, POS_SMEM, TO, MAXSTEPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((vq + Tile::kQueries - 1) / Tile::kQueries, nc * col_tiles, batch);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const int32_t*>(pos),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const uint32_t*>(wmask), static_cast<TO*>(out),
      offsets, vs, vq, nc, kp, n, n_pad, col_tiles);
  return cudaGetLastError();
}

}  // namespace convmma
