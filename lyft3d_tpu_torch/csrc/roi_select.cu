// Points-in-rotated-box selection for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_roi_kernel` with `_extract_min_k`
// (lyft3d_tpu/ops/select_kernel.py:127 and :53, launched by `_run` :164 for
// `roi_inside_select_fused`) together with its `_postprocess_first_k` (:196).
// What it computes: for every box, the first k valid point indices inside the
// enlarged rotated box, in index order, and their count; slots past the count
// repeat the first hit, a box without a point is all 0, the count is clipped
// to k. A point is inside when |lx| <= hl, |ly| <= hw and |dz| <= hh with
// lx = c*dx + s*dy, ly = -s*dx + c*dy in the box frame.
//
// Bound: bytes are small (13 B a point, 32 B a box, 4 B an output slot); the
// work is about 15 float32 operations for every (box, point) pair tested, and
// a box may stop once it has k hits. Neither is what held the first kernel
// back (a warp a box walking the cloud 32 points at a time, 100 blocks of 4
// warps for the PointRCNN call's 400 boxes): it had too few warps for 132 SMs
// and every step waited on the last.
//
// Design: a block of T threads owns G boxes of one sample and walks the cloud
// in segments of 32·T points. In a segment, warp w takes the 1,024 points
// [w·1024, (w+1)·1024) of it in 32 steps of 32 consecutive points: each lane
// loads one point (x, y, z, valid) into registers once, tests it against the
// G boxes, and one __ballot_sync a box makes a 32-bit word of hits; lane i
// keeps the words of step i. So thread t holds the words of points
// [32·t, 32·t + 32) of the segment, one a box, in index order across the
// block. An exclusive scan of the words' popcounts (warp shuffles, then the
// warp totals from shared memory) gives each thread the output slot of its
// first hit: running + prefix_t. The thread writes its hits' indices to the
// slots below k, and every thread adds the segment's total to its running
// count, the same number everywhere: the block leaves the loop as soon as
// each of its boxes has k hits, a decision uniform across the block. The
// first hit of a box is the lowest bit of the word whose slot is 0.
//
// G boxes a block read each point once for all G: a sample's cloud crosses
// L2 R / G times. The launch shape (G, T) is the wrapper's rule
// (`_roi_launch_shape` in ops/pointnet2.py), measured on an H100.
//
// Each box arrives as eight float32 numbers (cx, cy, cz, hl, hw, hh, cos,
// sin) that the wrapper computed in PyTorch, so that the kernel and the plain
// version test the same numbers; products and sums are spelled with the
// round-to-nearest intrinsics in the plain version's order, so that no fused
// multiply-add moves a point across a face: the indices must be equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int G, int T>
__global__ void __launch_bounds__(T)
roi_select_kernel(const float* __restrict__ boxes, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, int* __restrict__ out_idx,
                  int* __restrict__ out_cnt, int r, int n, int k, int groups) {
  constexpr int kWarps = T / 32;
  constexpr int kSegment = 32 * T;
  // Warp totals, double-buffered by segment: a thread can only write buffer
  // s % 2 again in segment s + 2, after every thread passed the barrier of
  // segment s + 1 and so finished reading segment s.
  __shared__ int s_total[2][G][kWarps];
  __shared__ int s_first[G];
  const int b = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* pts = points + static_cast<long long>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * n;

  float box[G][8];
  int running[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool has_row = row0 + g < r;
    const float* p = boxes + (static_cast<long long>(b) * r + (has_row ? row0 + g : 0)) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) box[g][q] = has_row ? p[q] : 0.0f;
    // A box past the end of the sample's boxes counts as full from the start.
    running[g] = has_row ? 0 : k;
  }
  if (threadIdx.x < G) s_first[threadIdx.x] = 0;

  for (int seg0 = 0, parity = 0; seg0 < n; seg0 += kSegment, parity ^= 1) {
    bool done = true;
#pragma unroll
    for (int g = 0; g < G; ++g) done = done && running[g] >= k;
    if (done) break;

    unsigned word[G];
#pragma unroll
    for (int g = 0; g < G; ++g) word[g] = 0u;
    const int base = seg0 + warp * 1024 + lane;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int j = base + i * 32;
      const bool in = j < n;
      const long long jj = in ? j : n - 1;
      const float x = pts[3 * jj];
      const float y = pts[3 * jj + 1];
      const float z = pts[3 * jj + 2];
      const bool live = in && ok[jj] != 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float dx = __fadd_rn(x, -box[g][0]);
        const float dy = __fadd_rn(y, -box[g][1]);
        const float dz = __fadd_rn(z, -box[g][2]);
        const float c = box[g][6];
        const float s = box[g][7];
        const float lx = __fadd_rn(__fmul_rn(c, dx), __fmul_rn(s, dy));
        const float ly = __fadd_rn(__fmul_rn(-s, dx), __fmul_rn(c, dy));
        const bool hit = live && fabsf(lx) <= box[g][3] && fabsf(ly) <= box[g][4] &&
                         fabsf(dz) <= box[g][5];
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (lane == i) word[g] = m;
      }
    }

    // Inclusive scan of the popcounts over the warp's lanes.
    int incl[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      incl[g] = __popc(word[g]);
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl[g], d);
        if (lane >= d) incl[g] += v;
      }
      if (lane == 31) s_total[parity][g][warp] = incl[g];
    }
    __syncthreads();

    const int first_point = seg0 + static_cast<int>(threadIdx.x) * 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int v = s_total[parity][g][w];
        total += v;
        if (w < warp) before += v;
      }
      int slot = running[g] + before + incl[g] - __popc(word[g]);
      unsigned m = word[g];
      if (m != 0u && slot == 0) s_first[g] = first_point + __ffs(m) - 1;
      int* row_out = out_idx + (static_cast<long long>(b) * r + row0 + g) * k;
      while (m != 0u && slot < k) {
        row_out[slot++] = first_point + __ffs(m) - 1;
        m &= m - 1u;
      }
      running[g] += total;
    }
  }
  __syncthreads();  // s_first of every box is written

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (row0 + g >= r) continue;
    const int got = min(running[g], k);
    const int first = s_first[g];
    int* row_out = out_idx + (static_cast<long long>(b) * r + row0 + g) * k;
    for (int slot = got + static_cast<int>(threadIdx.x); slot < k; slot += T) row_out[slot] = first;
    if (threadIdx.x == 0) out_cnt[static_cast<long long>(b) * r + row0 + g] = got;
  }
}

template <int G, int T>
cudaError_t launch(const float* boxes, const float* points, const uint8_t* valid, int* out_idx,
                   int* out_cnt, int batch, int r, int n, int k, cudaStream_t stream) {
  const int groups = (r + G - 1) / G;
  const long long blocks = static_cast<long long>(batch) * groups;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  roi_select_kernel<G, T><<<static_cast<unsigned int>(blocks), T, 0, stream>>>(
      boxes, points, valid, out_idx, out_cnt, r, n, k, groups);
  return cudaGetLastError();
}

}  // namespace

// For `batch` clouds: the first `k` of `n` points ((B, N, 3) float32, (B, N)
// uint8 valid) inside each of `r` boxes ((B, R, 8) float32: centre, half
// sizes along the box's x, y and z, cos and sin of its yaw), into `out_idx`
// ((B, R, k) int32) and `out_cnt` ((B, R) int32), `group` boxes (1, 2 or 4)
// a block of `threads` (256). Returns the CUDA error of the launch (0
// on success), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int roi_select_launch(const void* boxes, const void* points, const void* valid,
                                 void* out_idx, void* out_cnt, int batch, int r, int n, int k,
                                 int group, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || k < 1 || n > 2147483647 - 32 * 256) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || r <= 0) return static_cast<int>(cudaGetLastError());
  const float* bx = static_cast<const float*>(boxes);
  const float* p = static_cast<const float*>(points);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* oi = static_cast<int*>(out_idx);
  int* oc = static_cast<int*>(out_cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROI_CASE(G, T) \
  if (group == G && threads == T) return static_cast<int>(launch<G, T>(bx, p, v, oi, oc, batch, r, n, k, s));
  ROI_CASE(1, 256) ROI_CASE(2, 256) ROI_CASE(4, 256)
#undef ROI_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
