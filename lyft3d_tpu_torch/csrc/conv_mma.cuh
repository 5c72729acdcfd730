// Tensor-core gather-conv tiles for Hopper (sm_90a), shared by the two
// sparse-conv kernels: the 9-offset stencil (stencil_conv.cu) and the
// 27-offset rank gather-GEMM (subm_conv.cu), forward and feature gradient.
//
//   out[b, q, c·N:(c+1)·N] = Σ_{j<offsets} src[b, pos[b, j, q]][c·ka:c·ka+kp] @ W[j]
//
// with pos −1 (or ≥ vs) an absent row. The caller turns its own index into
// `pos` (the stencil searches ids, the rank gather has ranks already) and
// prepares the weights once a launch (`weight_prep_kernel`): W[j] as
// (n_pad, kp) bfloat16, the contraction index contiguous and zero-padded,
// with one bit for every 16 x 8 block that holds a non-zero.
//
// Two tiles. Both are bound by bytes (every source row read once, the
// output written once: 2·hits·kp·N operations are far below the tensor
// cores' rate), and what they fight is the traffic they add themselves:
// rows gathered again, weights staged again by every block, zeros
// multiplied. Hits are not compacted (on the tensor cores the products on
// zero rows cost little, and a compacted tile would have to scatter its rows
// back): queries are the M dimension, so a result row is its query's row and
// the float32 accumulators stay in registers until the one store. bfloat16
// products are exact in float32: the result differs from a float32 sum by
// order only.
//
// `conv_mma_kernel`, the unit tile (the rank gather; the stencil's outputs
// under 128 columns, or of 128 in several chunks, at most 256 lanes): a
// block owns 128 queries and all output columns, so a query's rows are gathered
// once. It walks the (offset, SLICE-lane slice) pairs that have both a hit in
// the tile and a non-zero weight block, through a ring of shared-memory
// stages filled by 16-byte `cp.async` (rows of misses are zero-filled,
// 16-query groups without a hit are not copied at all) STAGES − 1 stages
// ahead of the `mma.sync.m16n8k16` that consume them; 16-query groups without
// a hit at an offset and pairs of weight blocks (16 lanes x 16 columns)
// without a non-zero are skipped. SLICE is the contraction a stage holds: 64
// lanes for the stencil's band rows, 16 or 32 for the rank gather's 16- and
// 32-channel rows, so that a narrow layer does not pad its rows to 64. It
// stages a slice's whole weight rows (zeros included): at these shapes the
// ring waits on latency, not on bytes.
//
// `conv_wide_kernel`, the wide tile (the stencil's other shapes: the
// dense-z column middle's outputs of 192 to 640 columns at 1-4 chunks, the
// unit middle's of 128, and every `d_src`, contractions up to 640 lanes).
// At 640 columns the unit tile's three 256-column tiles each
// gathered their queries' rows again, and every block copied each (offset,
// slice)'s whole 256 x 64 weight slice into its ring (two thirds zeros in a
// band). A ring that stages a chunk's whole width instead, and only the
// band, was built first and measured on the card (clock64 splits of its
// loop): its blocks hardly waited on their copies and spent about half of
// each item issuing them (a cp.async a 16 bytes, with its address
// arithmetic, for a stage whose few hits give few products), so deeper
// rings gained nothing and fewer bytes barely showed: at one to four hits a
// query the work is bound by instructions and latency, not by bytes. The
// wide tile:
//   1. owns a chunk's whole output width without shared memory: a warp owns
//      16 queries and 128 columns (8 pairs of 16), a 16-query group's
//      ceil(n_pad / 128) warps own every column, so a query's rows are read
//      once a chunk from memory (its column warps share them through L1) and
//      no column tile gathers them again;
//   2. multiplies over the band only: `band_ranges_kernel` reads the bitmap
//      into the range [lo, hi) of 16-column pairs holding the non-zeros of
//      each (offset, 16-lane step), a warp walks only the steps whose range
//      meets its pairs and only the pairs inside it, and the weights,
//      re-laid by `fragment_prep_kernel` in the order of the B fragments of
//      `mma.sync.m16n8k16`, are one coalesced 16-byte load a lane and block
//      (L1 serves them to every warp of the SM). A general matrix stays
//      right: a range covers every non-zero by construction;
//   3. has no ring: each warp loads its next offset's two positions a
//      thread while it works on the current offset, its step loop is
//      unrolled by two, and 16 warps an SM (128 registers a thread) hide the
//      rest of the latency;
//   4. reads float32 rows (the backward's cotangent) as they are, rounding
//      each pair to bfloat16 as it is loaded (`__float2bfloat16_rn`, as the
//      copy pass did), so `d_src` writes no bfloat16 copy of the cotangent;
//      rows are read two lanes at a time, so only a chunk of an odd number
//      of lanes (the unit middle's 65) needs the padded copy
//      (`rows_prep_kernel`).
// The unit tile keeps the shapes of at most 256 lanes and either fewer
// than 128 columns or 128 in several chunks (the unit middle's strided
// layers, the column middle's mask convs and its layers of 64-128 columns):
// there a wide-tile warp would own fewer than 8 column pairs, and the ring
// reuses each staged weight block over 128 queries. Both tiles were timed
// on every shape both take (tools/stencil_tile_ab.py); the rule follows
// the faster.

// The block bitmap of the weights has one 32-bit word for every (offset,
// 256-column tile, 16-lane step), bit o / 8 for the tile's column o:
// wmask[(j·mask_tiles(n_pad) + t)·mask_steps(kp) + step]. Up to 256 lanes
// and 256 columns that is the (offsets, 16) table of one tile. Rows whose
// width is not a multiple of 16 lanes are first copied into padded bfloat16
// rows (`rows_prep_kernel`), which also converts float32 and can flag zero
// rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgrad_tile.cuh"

namespace convmma {

constexpr int kPrepThreads = 256;
constexpr int kMaxSteps = 16;      // 16-lane steps of the unit tile's contraction: kp ≤ 256
constexpr int kMaxStepsWide = 40;  // of the wide tile's: kp ≤ 640
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

// The unit tile. WM x WN warps; a warp owns MT m-tiles of 16 queries and NT
// n-tiles of 8 columns: the block 16·WM·MT queries and all 8·WN·NT ≤ 256
// columns. MAXOFF offsets at most, SLICE contraction lanes a stage, at most
// kMaxSteps 16-lane steps of contraction. POS_SMEM keeps the block's
// positions in shared memory after the first read (MAXOFF x 128 int32 behind
// the ring), so that filling a stage waits on no global load.
template <int MAXOFF, int SLICE, int WM, int WN, int MT, int NT, int STAGES, bool POS_SMEM>
struct ConvTile {
  static_assert(NT % 2 == 0, "n-tiles come in pairs (ldmatrix.x4)");
  static_assert(SLICE % 16 == 0 && (kMaxSteps * 16) % SLICE == 0, "a slice is whole 16-lane steps");
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kQueries = WM * MT * 16;
  static constexpr int kCols = WN * NT * 8;
  static_assert(kMaskCols % kCols == 0, "the columns lie in one bitmap word");
  static constexpr int kLd = SLICE + 8;  // shared-memory row stride (no ldmatrix bank conflicts)
  static constexpr int kMaxSlices = kMaxSteps * 16 / SLICE;
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
// grid (query tiles, nc, batch).
template <int MAXOFF, int SLICE, int WM, int WN, int MT, int NT, int STAGES, bool POS_SMEM, typename TO>
__global__ void __launch_bounds__(WM * WN * 32, 512 / (WM * WN * 32))
conv_mma_kernel(const __nv_bfloat16* __restrict__ src, const int32_t* __restrict__ pos,
                const __nv_bfloat16* __restrict__ wt, const uint32_t* __restrict__ wmask,
                TO* __restrict__ out, int offsets, int vs, int vq, int nc, int kp, int n, int n_pad) {
  using Tile = ConvTile<MAXOFF, SLICE, WM, WN, MT, NT, STAGES, POS_SMEM>;
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
  // The bitmap's words of the block's (one) 256-column tile.
  __shared__ uint32_t wmask_s[MAXOFF * kMaxSteps];
  __shared__ unsigned int mt_any_s[MAXOFF];
  __shared__ int list_s[MAXOFF * kMaxSlices];
  __shared__ int n_it_s;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int steps = kp / 16;
  const int msteps = mask_steps(kp);
  const int mtiles = mask_tiles(n_pad);
  const long long width = static_cast<long long>(nc) * kp;
  const __nv_bfloat16* src_b = src + static_cast<long long>(b) * vs * width + static_cast<long long>(chunk) * kp;
  const int32_t* pos_b = pos + static_cast<long long>(b) * offsets * vq;

  for (int i = tid; i < offsets * kMaxSteps; i += kT) {
    const int j = i / kMaxSteps;
    const int s = i - j * kMaxSteps;
    wmask_s[i] = s < steps ? wmask[j * mtiles * msteps + s] & kTileMask : 0u;
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
        for (int ks = 0; ks < kKs; ++ks) any |= wmask_s[j * kMaxSteps + sl * kKs + ks];
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
    const __nv_bfloat16* wj = wt + static_cast<long long>(j) * n_pad * kp + sl * SLICE;
    for (int i = tid; i < n_pad * (SLICE / 8); i += kT) {
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
      const uint32_t m = (wmask_s[j * kMaxSteps + sl * kKs + ks] >> (wn * NT)) & ((1u << NT) - 1u);
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
        const int col = (wn * NT + ni) * 8 + tq * 2 + (e & 1);
        if (q < vq && col < n) store_out(o + static_cast<long long>(q) * out_width + col, acc[mi][ni][e]);
      }
}

// Launches conv_mma_kernel with its dynamic shared memory; kp a multiple of
// SLICE of at most kMaxSteps steps, offsets ≤ MAXOFF, n_pad ≤ the tile's
// columns.
template <int MAXOFF, int SLICE, int WM, int WN, int MT, int NT, int STAGES, bool POS_SMEM, typename TO>
cudaError_t launch_conv_mma(const void* src, const void* pos, const void* wt, const void* wmask, void* out,
                            int batch, int offsets, int vs, int vq, int nc, int kp, int n, int n_pad,
                            cudaStream_t stream) {
  using Tile = ConvTile<MAXOFF, SLICE, WM, WN, MT, NT, STAGES, POS_SMEM>;
  if (offsets <= 0 || offsets > MAXOFF || kp <= 0 || kp % SLICE != 0 || kp / 16 > kMaxSteps || n_pad <= 0 ||
      n_pad % 16 != 0 || n_pad > Tile::kCols || n > n_pad || batch > 65535 || nc > 65535) {
    return cudaErrorInvalidValue;
  }
  auto kernel = conv_mma_kernel<MAXOFF, SLICE, WM, WN, MT, NT, STAGES, POS_SMEM, TO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((vq + Tile::kQueries - 1) / Tile::kQueries, nc, batch);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const int32_t*>(pos),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const uint32_t*>(wmask), static_cast<TO*>(out),
      offsets, vs, vq, nc, kp, n, n_pad);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The wide tile (the stencil's dense-z column middle).
// ---------------------------------------------------------------------------

constexpr int kWideNT = 16;  // n-tiles of 8 columns a warp of the wide tile: 8 16-column pairs

// wband[j·(kp/16) + s] = lo | hi << 16: the 16-column pairs [lo, hi) outside
// which offset j's weights hold no non-zero at 16-lane step s (0 where the
// step is all zero), from weight_prep's bitmap. A thread a (offset, step).
__global__ void __launch_bounds__(kPrepThreads)
band_ranges_kernel(const uint32_t* __restrict__ wmask, uint32_t* __restrict__ wband, int offsets, int kp,
                   int n_pad) {
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  const int steps = kp / 16;
  if (i >= offsets * steps) return;
  const int j = i / steps;
  const int s = i - j * steps;
  const int mtiles = mask_tiles(n_pad);
  const int msteps = mask_steps(kp);
  int lo = -1, hi = 0;
  for (int p = 0; p < n_pad / 16; ++p) {
    const int col = p * 16;
    const uint32_t word = wmask[(j * mtiles + col / kMaskCols) * msteps + s];
    if ((word >> ((col % kMaskCols) / 8)) & 3u) {
      if (lo < 0) lo = p;
      hi = p + 1;
    }
  }
  wband[i] = lo < 0 ? 0u : static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The weights in fragment order: wf[((j·steps + s)·pairs + p)·32 + lane]
// holds lane (g, t)'s B fragments of the 16 x 16 block at 16-lane step s and
// 16-column pair p of offset j, {b0, b1} of the pair's first 8 columns, then
// of its second (mma.cuh's layout: b0 = k 2t..2t+1, b1 = k 2t+8..2t+9, at
// column g), so that a warp loads a block's fragments as one coalesced
// 512-byte read. From weight_prep's (offsets, n_pad, kp) copy; a thread a
// (block, lane).
__global__ void __launch_bounds__(kPrepThreads)
fragment_prep_kernel(const __nv_bfloat16* __restrict__ wt, uint4* __restrict__ wf, long long total, int kp,
                     int n_pad) {
  const long long i = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (i >= total) return;
  const int lane = static_cast<int>(i % 32);
  long long r = i / 32;
  const int pairs = n_pad / 16;
  const int steps = kp / 16;
  const int p = static_cast<int>(r % pairs);
  r /= pairs;
  const int s = static_cast<int>(r % steps);
  const long long j = r / steps;
  const __nv_bfloat16* w = wt + (j * n_pad + p * 16 + lane / 4) * kp + s * 16 + 2 * (lane % 4);
  wf[i] = make_uint4(*reinterpret_cast<const uint32_t*>(w), *reinterpret_cast<const uint32_t*>(w + 8),
                     *reinterpret_cast<const uint32_t*>(w + 8 * kp),
                     *reinterpret_cast<const uint32_t*>(w + 8 * kp + 8));
}

inline cudaError_t band_ranges(const void* wmask, void* wband, int offsets, int kp, int n_pad,
                               cudaStream_t stream) {
  if (offsets <= 0 || kp <= 0 || kp % 16 != 0 || n_pad <= 0 || n_pad % 16 != 0) return cudaErrorInvalidValue;
  const int total = offsets * (kp / 16);
  band_ranges_kernel<<<(total + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0, stream>>>(
      static_cast<const uint32_t*>(wmask), static_cast<uint32_t*>(wband), offsets, kp, n_pad);
  return cudaGetLastError();
}

inline cudaError_t fragment_prep(const void* wt, void* wf, int offsets, int kp, int n_pad, cudaStream_t stream) {
  if (offsets <= 0 || kp <= 0 || kp % 16 != 0 || n_pad <= 0 || n_pad % 16 != 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(offsets) * (kp / 16) * (n_pad / 16) * 32;
  const long long blocks = (total + kPrepThreads - 1) / kPrepThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  fragment_prep_kernel<<<static_cast<unsigned int>(blocks), kPrepThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(wt), static_cast<uint4*>(wf), total, kp, n_pad);
  return cudaGetLastError();
}

// Two lanes of a row as one bfloat16 pair (zero where the row is absent or
// the lanes lie at or past ka).
__device__ __forceinline__ uint32_t wide_a_pair(const __nv_bfloat16* row, bool ok, int lane, int ka) {
  return ok && lane < ka ? *reinterpret_cast<const uint32_t*>(row + lane) : 0u;
}

// The same from float32 lanes, each rounded to bfloat16 here (as the copy
// pass rounds them).
__device__ __forceinline__ uint32_t wide_a_pair(const float* row, bool ok, int lane, int ka) {
  if (!(ok && lane < ka)) return 0u;
  const float2 v = *reinterpret_cast<const float2*>(row + lane);
  return wgrad::pack_bf16(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
}

// A thread's A fragment of the 16 x 16 block at lane l (its rows a and b:
// the group's rows g and g + 8).
template <typename TA>
__device__ __forceinline__ void wide_a_fragment(uint32_t (&afr)[4], const TA* ra, const TA* rb, bool oka, bool okb,
                                                int l, int ka) {
  afr[0] = wide_a_pair(ra, oka, l, ka);
  afr[1] = wide_a_pair(rb, okb, l, ka);
  afr[2] = wide_a_pair(ra, oka, l + 8, ka);
  afr[3] = wide_a_pair(rb, okb, l + 8, ka);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *p = a;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<uint32_t*>(p) = wgrad::pack_bf16(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  } else {
    *p = __float2bfloat16_rn(a);
  }
}

// A warp owns 16 queries of one chunk and the 16-column pairs [8·cw, 8·cw +
// 8) of the output (128 columns); a 16-query group's `col_warps` warps
// together own every column, and a block holds 32·groups·col_warps threads,
// `groups` 16-query groups side by side. No shared memory and no barrier:
// each warp walks the offsets at which one of its 16 queries hits (the next
// offset's two positions a thread loaded while it works on this one) and,
// for each 16-lane step whose band range meets its pairs, loads the A
// fragment straight from its two rows a thread (rows of misses and lanes at
// or past ka read as zeros), then each of its pairs' B fragments in the
// range from `wf` (one 16-byte load a lane, served by L1 to the SM's other
// warps), and multiplies. src (batch, vs, nc·ka) of TA, pos (batch, offsets,
// vq) int32, wf from fragment_prep, wband from band_ranges; out (batch, vq,
// nc·n) of TO. grid (query tiles of 16·groups, nc, batch).
template <typename TA, typename TO>
__global__ void __launch_bounds__(256, 2)
conv_wide_kernel(const TA* __restrict__ src, const int32_t* __restrict__ pos, const uint4* __restrict__ wf,
                 const uint32_t* __restrict__ wband, TO* __restrict__ out, int offsets, int vs, int vq, int nc,
                 int ka, int kp, int n, int n_pad, int col_warps) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int grp = warp / col_warps;
  const int cw = warp - grp * col_warps;
  const int groups = blockDim.x / 32 / col_warps;
  const int b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int q0 = (blockIdx.x * groups + grp) * 16;
  if (q0 >= vq) return;  // a whole warp: nothing waits on it
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int steps = kp / 16;
  const int pairs = n_pad / 16;
  const int p0 = cw * (kWideNT / 2);  // the warp's first pair
  const long long width = static_cast<long long>(nc) * ka;
  const TA* src_b = src + static_cast<long long>(b) * vs * width + static_cast<long long>(chunk) * ka;
  const int32_t* pos_b = pos + static_cast<long long>(b) * offsets * vq;
  const int qa = q0 + gq;
  const int qb = qa + 8;

  float acc[kWideNT][4];
#pragma unroll
  for (int ni = 0; ni < kWideNT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;

  int na = qa < vq ? __ldg(pos_b + qa) : -1;
  int nb = qb < vq ? __ldg(pos_b + qb) : -1;
  for (int j = 0; j < offsets; ++j) {
    const int pa = na < vs ? na : -1;
    const int pb = nb < vs ? nb : -1;
    if (j + 1 < offsets) {  // the next offset's positions, in flight while this one's rows are read
      na = qa < vq ? __ldg(pos_b + static_cast<long long>(j + 1) * vq + qa) : -1;
      nb = qb < vq ? __ldg(pos_b + static_cast<long long>(j + 1) * vq + qb) : -1;
    }
    if (!__any_sync(0xffffffffu, pa >= 0 || pb >= 0)) continue;
    const TA* ra = src_b + static_cast<long long>(pa >= 0 ? pa : 0) * width;
    const TA* rb = src_b + static_cast<long long>(pb >= 0 ? pb : 0) * width;
    const uint32_t* band_j = wband + j * steps;
    const uint4* wf_j = wf + static_cast<long long>(j) * steps * pairs * 32 + lane;
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const uint32_t w = __ldg(band_j + s);
      const int lo = max(static_cast<int>(w & 0xffffu), p0) - p0;  // the range in the warp's own pairs
      const int hi = min(static_cast<int>(w >> 16), p0 + kWideNT / 2) - p0;
      if (hi <= lo) continue;
      uint32_t afr[4];
      wide_a_fragment(afr, ra, rb, pa >= 0, pb >= 0, s * 16 + 2 * tq, ka);
      const uint4* wfs = wf_j + (static_cast<long long>(s) * pairs + p0) * 32;
#pragma unroll
      for (int np = 0; np < kWideNT / 2; ++np) {
        if (np < lo || np >= hi) continue;
        const uint4 bf = __ldg(wfs + np * 32);
        mma::mma_bf16(acc[2 * np], afr, bf.x, bf.y);
        mma::mma_bf16(acc[2 * np + 1], afr, bf.z, bf.w);
      }
    }
  }

  const long long out_width = static_cast<long long>(nc) * n;
  TO* o = out + static_cast<long long>(b) * vq * out_width + static_cast<long long>(chunk) * n;
  const bool even = n % 2 == 0;  // a thread's two columns as one store
#pragma unroll
  for (int ni = 0; ni < kWideNT; ++ni) {
    const int col = p0 * 16 + ni * 8 + 2 * tq;
    if (col >= n) continue;
    if (qa < vq) store_pair(o + static_cast<long long>(qa) * out_width + col, acc[ni][0], acc[ni][1], even);
    if (qb < vq) store_pair(o + static_cast<long long>(qb) * out_width + col, acc[ni][2], acc[ni][3], even);
    if (!even && col + 1 < n) {
      if (qa < vq) store_out(o + static_cast<long long>(qa) * out_width + col + 1, acc[ni][1]);
      if (qb < vq) store_out(o + static_cast<long long>(qb) * out_width + col + 1, acc[ni][3]);
    }
  }
}

// Column warps of a 16-query group (each at most 8 pairs: 128 columns) and
// 16-query groups a block (at most 8 warps) of the wide tile for n_pad.
__host__ __device__ inline int wide_col_warps(int n_pad) { return (n_pad + 127) / 128; }
__host__ __device__ inline int wide_groups(int n_pad) { return 8 / wide_col_warps(n_pad) > 1 ? 8 / wide_col_warps(n_pad) : 1; }

// Launches conv_wide_kernel: kp whole 16-lane steps up to 640, n_pad up to
// 640, ka ≤ kp and even (rows read two lanes at a time), src 8-byte aligned.
template <typename TA, typename TO>
cudaError_t launch_conv_wide(const void* src, const void* pos, const void* wf, const void* wband, void* out,
                             int batch, int offsets, int vs, int vq, int nc, int ka, int kp, int n, int n_pad,
                             cudaStream_t stream) {
  if (offsets <= 0 || kp <= 0 || kp % 16 != 0 || kp / 16 > kMaxStepsWide || n_pad <= 0 || n_pad % 16 != 0 ||
      n_pad > 640 || n > n_pad || ka <= 0 || ka > kp || ka % 2 != 0 || batch > 65535 || nc > 65535 ||
      reinterpret_cast<uintptr_t>(src) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const int col_warps = wide_col_warps(n_pad);
  const int groups = wide_groups(n_pad);
  const dim3 grid((vq + 16 * groups - 1) / (16 * groups), nc, batch);
  conv_wide_kernel<TA, TO><<<grid, 32 * groups * col_warps, 0, stream>>>(
      static_cast<const TA*>(src), static_cast<const int32_t*>(pos), static_cast<const uint4*>(wf),
      static_cast<const uint32_t*>(wband), static_cast<TO*>(out), offsets, vs, vq, nc, ka, kp, n, n_pad,
      col_warps);
  return cudaGetLastError();
}

}  // namespace convmma
