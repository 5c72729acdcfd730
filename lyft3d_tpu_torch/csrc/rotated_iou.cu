// Pairwise rotated BEV overlap and IoU for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces no TPU kernel: the JAX package computes the rotated IoU as jnp
// (lyft3d_tpu/ops/rotated_iou.py). The kernel was added because the port's
// plain version of it (ops/rotated_iou.py::polygon_intersection_area over
// blocks of rows) was most of SECOND inference on the card: for the NMS of 80
// sweeps of 1,000 candidates it ran ~100 elementwise, sort, gather and roll
// launches a block of 13 rows, each writing (80, 13, 1000, 24) tensors to
// device memory, 8,055 launches and 722 ms of device time a batch.
//
// Work: (B, N, 5) x (B, M, 5) boxes [x, y, w, l, yaw] -> a contiguous
// (B, N, M) float32: the bare intersection area (mode 0, rotated_overlap_bev)
// or its ratio to the union (1), to the row box's area (2) or to the column
// box's (3) (rotated_iou_bev's criterion -1, 0, 1).
//
// Bound: the store of the result, 4·B·N·M bytes (320 MB at 80 x 1,000 x
// 1,000: 0.096 ms at 3.35 TB/s); the boxes are 20·B·(N + M) bytes. The
// arithmetic is divergent float32 scalar code, some 460 operations for a
// pair that does the polygon work and a dozen for one that does not.
//
// Design:
// - One thread a pair, neighbouring threads on neighbouring columns, so a
//   warp's stores coalesce. A block owns a tile of kRows rows x kCols columns
//   of one sample (looping over row tiles and samples beyond the grid's
//   limits) and computes the tile's corners once into shared memory with
//   ops/box_ops.py::box_corners_2d's arithmetic, op for op: one IEEE rounding
//   an operation (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which the
//   compiler never contracts into FMAs), and cosf and sinf, which PyTorch's
//   CUDA cos and sin call. Corners made here instead of by box_corners_2d
//   spare its ~20 launches a call.
// - An exact early-out. A pair whose centres lie farther apart than the sum
//   of the two half-diagonals plus `gap` has disjoint quads with at least
//   `gap` between them, so no edge crosses another. Where besides `gap` x the
//   shorter edge of the two boxes exceeds `gap_edge`, no corner passes the
//   containment test, whose tolerance is _EPS_IN = 1e-6 on a cross product
//   (1e-6 / edge length in metres). The plain version returns exactly 0
//   there, and the kernel writes 0 without the polygon work. The wrapper
//   passes both margins; a CPU test holds the plain version to 0 on pairs
//   that the rule skips. A zero-size box is never skipped: the plain
//   version's containment test passes every point for it.
// - Otherwise the plain version's algorithm with its constants and
//   roundings: the 16 edge crossings and 8 containment tests, the valid
//   candidates compacted in index order, their centroid, the diamond
//   pseudo-angle, a stable insertion sort over the valid candidates only
//   (usually 8 or fewer, at most 24), the shoelace formula; fewer than 3
//   candidates give 0. Only the order of the centroid's and the shoelace's
//   sums differs from the plain version's.
// - The ratio is taken in the epilogue, as rotated_iou_bev takes it:
//   inter / max(denominator, 1e-12).
// No --use_fast_math (_build.NVCC_FLAGS): the divisions are IEEE's.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;       // columns of a tile: blockDim.x
constexpr int kRowThreads = 4;  // blockDim.y
constexpr int kRows = 32;       // rows of a tile: kRows / kRowThreads a thread
constexpr int kCand = 24;       // 16 crossings, 4 + 4 corners
constexpr float kEpsIn = 1e-6f;    // _EPS_IN
constexpr float kEpsDen = 1e-12f;  // _EPS_DEN
constexpr long long kMaxGridYZ = 65535;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float cross2(float ax, float ay, float bx, float by) {
  return sub(mul(ax, by), mul(ay, bx));
}

// A tile's boxes, one array a field: corners (CCW), centre, half-diagonal,
// shorter edge, area w·l.
template <int T>
struct Tile {
  float x[4][T], y[4][T];
  float cx[T], cy[T], half_diag[T], short_edge[T], area[T];
};

template <int T>
__device__ __forceinline__ void stage(Tile<T>& tile, int k, const float* __restrict__ box) {
  const float x = box[0], y = box[1], w = box[2], l = box[3], yaw = box[4];
  const float c = cosf(yaw), s = sinf(yaw);
  // box_corners_2d: [l, -l, -l, l] / 2 along local x, [w, w, -w, -w] / 2
  // along local y, rotated, then moved to the centre.
  const float hl = __fdiv_rn(l, 2.0f), nhl = __fdiv_rn(-l, 2.0f);
  const float hw = __fdiv_rn(w, 2.0f), nhw = __fdiv_rn(-w, 2.0f);
  const float lx[4] = {hl, nhl, nhl, hl};
  const float wy[4] = {hw, hw, nhw, nhw};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    tile.x[q][k] = add(sub(mul(c, lx[q]), mul(s, wy[q])), x);
    tile.y[q][k] = add(add(mul(s, lx[q]), mul(c, wy[q])), y);
  }
  tile.cx[k] = x;
  tile.cy[k] = y;
  tile.half_diag[k] = 0.5f * sqrtf(w * w + l * l);
  tile.short_edge[k] = fminf(fabsf(w), fabsf(l));
  tile.area[k] = mul(w, l);
}

// Whether (px, py) lies inside the quad with edge origins (qx, qy) and edge
// vectors (dx, dy), within kEpsIn on each edge's cross product.
__device__ __forceinline__ bool inside(float px, float py, const float (&qx)[4],
                                       const float (&qy)[4], const float (&dx)[4],
                                       const float (&dy)[4]) {
  bool in = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float cr = cross2(dx[e], dy[e], sub(px, qx[e]), sub(py, qy[e]));
    in = in && cr >= -kEpsIn;
  }
  return in;
}

// Intersection area of two convex CCW quads: polygon_intersection_area for
// one pair.
__device__ float intersection_area(const float (&ax)[4], const float (&ay)[4], const float (&bx)[4],
                                   const float (&by)[4]) {
  float rx[4], ry[4], sx[4], sy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rx[k] = sub(ax[(k + 1) & 3], ax[k]);
    ry[k] = sub(ay[(k + 1) & 3], ay[k]);
    sx[k] = sub(bx[(k + 1) & 3], bx[k]);
    sy[k] = sub(by[(k + 1) & 3], by[k]);
  }
  float px[kCand], py[kCand], pa[kCand];
  int cnt = 0;
  // Crossings p = a_i + t·r_i = b_j + u·s_j with t, u in [0, 1], in the plain
  // version's order (i over the first quad's edges, then j).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float denom = cross2(rx[i], ry[i], sx[j], sy[j]);
      if (!(fabsf(denom) < kEpsDen)) {
        const float qpx = sub(bx[j], ax[i]), qpy = sub(by[j], ay[i]);
        const float t = __fdiv_rn(cross2(qpx, qpy, sx[j], sy[j]), denom);
        const float u = __fdiv_rn(cross2(qpx, qpy, rx[i], ry[i]), denom);
        if (t >= 0.0f && t <= 1.0f && u >= 0.0f && u <= 1.0f) {
          px[cnt] = add(ax[i], mul(t, rx[i]));
          py[cnt] = add(ay[i], mul(t, ry[i]));
          ++cnt;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inside(ax[k], ay[k], bx, by, sx, sy)) {
      px[cnt] = ax[k];
      py[cnt] = ay[k];
      ++cnt;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inside(bx[k], by[k], ax, ay, rx, ry)) {
      px[cnt] = bx[k];
      py[cnt] = by[k];
      ++cnt;
    }
  }
  if (cnt < 3) return 0.0f;

  float sum_x = 0.0f, sum_y = 0.0f;
  for (int k = 0; k < cnt; ++k) {
    sum_x = add(sum_x, px[k]);
    sum_y = add(sum_y, py[k]);
  }
  const float inv_cnt = __fdiv_rn(1.0f, static_cast<float>(cnt));
  const float cx = mul(sum_x, inv_cnt), cy = mul(sum_y, inv_cnt);
  // Diamond pseudo-angle about the centroid, monotone in atan2.
  for (int k = 0; k < cnt; ++k) {
    const float dx = sub(px[k], cx), dy = sub(py[k], cy);
    const float den = add(fabsf(dx), fabsf(dy));
    const float tt = __fdiv_rn(dy, den < kEpsDen ? 1.0f : den);
    pa[k] = dx < 0.0f ? sub(2.0f, tt) : (dy < 0.0f ? add(4.0f, tt) : tt);
  }
  // Stable insertion sort by pseudo-angle, as torch.sort(stable=True).
  for (int k = 1; k < cnt; ++k) {
    const float key = pa[k], kx = px[k], ky = py[k];
    int q = k - 1;
    while (q >= 0 && pa[q] > key) {
      pa[q + 1] = pa[q];
      px[q + 1] = px[q];
      py[q + 1] = py[q];
      --q;
    }
    pa[q + 1] = key;
    px[q + 1] = kx;
    py[q + 1] = ky;
  }
  float acc = 0.0f;
  for (int k = 0; k < cnt; ++k) {
    const int q = k + 1 == cnt ? 0 : k + 1;
    acc = add(acc, sub(mul(px[k], py[q]), mul(px[q], py[k])));
  }
  return mul(0.5f, fabsf(acc));
}

// grid (column tiles, row tiles, samples), both of the latter looped beyond
// the grid; block (kCols, kRowThreads).
__global__ void __launch_bounds__(kCols * kRowThreads)
rotated_iou_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
                   float* __restrict__ out, long long batch, long long n, long long m, int mode,
                   float gap, float gap_edge) {
  __shared__ Tile<kRows> rows;
  __shared__ Tile<kCols> cols;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  const long long j = col0 + threadIdx.x;
  const long long row_tiles = (n + kRows - 1) / kRows;

  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    __syncthreads();  // the previous sample's readers are done with `cols`
    if (tid < kCols && col0 + tid < m) stage(cols, tid, boxes2 + (b * m + col0 + tid) * 5);
    for (long long rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
      const long long row0 = rt * kRows;
      __syncthreads();  // the previous row tile's readers are done with `rows`
      if (tid >= kCols && tid < kCols + kRows && row0 + (tid - kCols) < n)
        stage(rows, tid - kCols, boxes1 + (b * n + row0 + tid - kCols) * 5);
      __syncthreads();
      if (j >= m) continue;
      const int c = threadIdx.x;
      float bx[4], by[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bx[q] = cols.x[q][c];
        by[q] = cols.y[q][c];
      }
      const float ccx = cols.cx[c], ccy = cols.cy[c], chd = cols.half_diag[c];
      const float cse = cols.short_edge[c], carea = cols.area[c];
      for (int r = threadIdx.y; r < kRows && row0 + r < n; r += kRowThreads) {
        const float dx = rows.cx[r] - ccx, dy = rows.cy[r] - ccy;
        const float apart = sqrtf(dx * dx + dy * dy) - (rows.half_diag[r] + chd);
        float inter = 0.0f;
        if (!(apart > gap && apart * fminf(rows.short_edge[r], cse) > gap_edge)) {
          float ax[4], ay[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ax[q] = rows.x[q][r];
            ay[q] = rows.y[q][r];
          }
          inter = intersection_area(ax, ay, bx, by);
        }
        float v = inter;
        if (mode != 0) {
          const float denom =
              mode == 1 ? sub(add(rows.area[r], carea), inter) : (mode == 2 ? rows.area[r] : carea);
          v = __fdiv_rn(inter, denom < kEpsDen ? kEpsDen : denom);
        }
        out[(b * n + row0 + r) * m + j] = v;
      }
    }
  }
}

}  // namespace

// (batch, n, 5) x (batch, m, 5) contiguous float32 boxes [x, y, w, l, yaw]
// -> out, a contiguous (batch, n, m) float32. `mode`: 0 the intersection
// area, 1 intersection / union, 2 intersection / area of the row box, 3
// intersection / area of the column box. `gap` and `gap_edge` are the
// early-out's margins (metres, square metres). Returns the CUDA error of the
// launch (0 on success); batch, n and m must be positive.
extern "C" int rotated_iou_launch(const void* boxes1, const void* boxes2, void* out,
                                  long long batch, long long n, long long m, int mode, float gap,
                                  float gap_edge, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long col_tiles = (m + kCols - 1) / kCols;
  if (mode < 0 || mode > 3 || batch <= 0 || n <= 0 || m <= 0 || col_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = (n + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(row_tiles < kMaxGridYZ ? row_tiles : kMaxGridYZ),
                  static_cast<unsigned>(batch < kMaxGridYZ ? batch : kMaxGridYZ));
  rotated_iou_kernel<<<grid, dim3(kCols, kRowThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<float*>(out), batch, n, m, mode, gap, gap_edge);
  return static_cast<int>(cudaGetLastError());
}
