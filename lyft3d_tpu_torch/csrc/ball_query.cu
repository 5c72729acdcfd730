// Multi-radius ball query for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ball_kernel` with `_extract_min_k`
// (lyft3d_tpu/ops/select_kernel.py:94 and :53, launched by `_run` :164 for
// `multi_radius_ball_query_fused` / `ball_query_fused`) together with its
// `_postprocess_first_k` (:196). What it computes: for every centre and every
// radius, the first k valid point indices with d2 < r^2 in index order and
// their count; slots past the count repeat the first hit, a row without a
// hit is all 0, the count is clipped to k. One squared distance per
// (centre, point) pair serves all radii.
//
// The TPU kernel held a (rows, N) key tile in VMEM and pulled k minima out of
// it with k masked full-tile passes. Two kernels take its place here; the
// wrapper picks one by shape (`_ball_query_kernel` in ops/pointnet2.py):
//
// * The scan (`ball_query_launch`): one warp owns one centre and walks the
//   cloud in index order, 32 points at a time. Each lane tests one point
//   against every radius; __ballot_sync and __popc hand the hits their output
//   slots in index order, and the warp stops as soon as every radius has its
//   k. The block's eight warps share the points through 1,024-point
//   shared-memory tiles. Where no radius fills it tests every pair: bound by
//   float32 operations on N pairs a centre. It stays for small clouds, where
//   the cell table costs more than the scan.
//
// * The cell grid (`ball_grid_launch`): only the points that can lie inside
//   the largest radius are tested. A table is built on the card first,
//   without a host sync: `ball_keys_kernel` gives each valid point the
//   bucket of its cell, b * buckets + cell_hash(cell) with buckets =
//   2^log2_buckets a sample, where the cell is floor(p * inv_side) per axis
//   in float64, clamped to +-2^62 and held as int64; an invalid point gets
//   B * buckets, past every bucket. The wrapper sorts the keys (one stable
//   `torch.sort` of int32, so the points of a bucket keep ascending index),
//   and `ball_starts_kernel` finds each bucket's first position by binary
//   search. `ball_cell_table` in ops/pointnet2.py is the plain version of
//   the table. One warp owns one centre; lane l < 27 takes the bucket of
//   neighbouring cell l. Two neighbouring cells that hash to one bucket keep
//   one lane (__match_any_sync), or a point would be emitted twice. Each lane walks
//   its bucket in ascending index and stops at its next point with
//   d2 < r2_max; the warp takes the lowest index among the lane heads
//   (__reduce_min_sync, `redux.sync.min`), appends it to every radius it lies
//   inside that is not yet full, and the owning lane moves on. The warp stops
//   when every radius is full or every lane is exhausted. A hash collision
//   only adds candidates that the distance test rejects or that are true
//   hits; bound by the bytes of the inputs and outputs, or by the pairs
//   inside the largest radius.
//
// Completeness of the 27 cells. side = sqrt(r2_max) * (1 + 2^-10) and
// inv_side = 1 / side (the wrapper's `_ball_cell_inverse`). If a valid point
// passes d2 < r2_max (float32, u = 2^-24): every rounded square is at most
// the rounded sum, so fl(dx*dx) < r2_max, |dx| < sqrt(r2_max) (1 + u), and the
// exact |c - p| on each axis is below sqrt(r2_max) (1 + 2u) < side (1 - 2^-11).
// The quotients q = c * inv_side and p * inv_side carry two float64 roundings
// each (inv_side and the product): while |q| < 2^25 their difference is
// off by less than 2^-26, so it stays below 1 and the floors differ by at
// most 1: the point lies in one of the 27 cells. Where |q| >= 2^25, two
// different float32 coordinates are at least ulp >= 2^-24 |q| side >= 2 side
// apart, so a point within the radius has the centre's coordinate on that
// axis and, computed alike, the same cell. Float64 division is never used:
// the kernels and the plain version (`ball_cell_keys`) multiply by the same
// inv_side, one IEEE product, so a coordinate gets the same cell in each. The clamp keeps
// a cell and its neighbours inside int64 (a centre at 1,000 m, or at 1e30 m,
// is a cell like any other); a NaN coordinate gets some cell and is never a
// hit, as in the plain version.
//
// In both kernels d2 is ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest
// intrinsics, the order of the plain PyTorch version, and r^2 arrives as the
// float32 the host rounded once: the indices must be equal, not close.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRadii = 4;
constexpr int kWarps = 8;
constexpr int kTile = 1024;

struct Radii {
  int count;
  float r2[kMaxRadii];
  int k[kMaxRadii];
  int offset[kMaxRadii];
};

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ centers, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, int* __restrict__ out_idx,
                  int* __restrict__ out_cnt, int s, int n, int ktot,
                  int blocks_per_cloud, Radii radii) {
  __shared__ float tile[3 * kTile];
  __shared__ uint8_t tile_ok[kTile];
  const int b = blockIdx.x / blocks_per_cloud;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (blockIdx.x % blocks_per_cloud) * kWarps + warp;
  const bool has_row = row < s;
  const float* pts = points + static_cast<long long>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<long long>(b) * n;

  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (has_row) {
    const float* c = centers + (static_cast<long long>(b) * s + row) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  int* idx_row = out_idx + (static_cast<long long>(b) * s + row) * ktot;
  int found[kMaxRadii];
  int first[kMaxRadii];
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    found[r] = 0;
    first[r] = 0;
  }
  bool done = !has_row;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    for (int i = threadIdx.x; i < 3 * len; i += blockDim.x) tile[i] = pts[3 * t0 + i];
    for (int i = threadIdx.x; i < len; i += blockDim.x) tile_ok[i] = ok[t0 + i];
    __syncthreads();
    for (int c0 = 0; c0 < len && !done; c0 += 32) {
      const int j = c0 + lane;
      bool live = false;
      float d2 = 0.0f;
      if (j < len) {
        live = tile_ok[j] != 0;
        const float dx = __fadd_rn(cx, -tile[3 * j]);
        const float dy = __fadd_rn(cy, -tile[3 * j + 1]);
        const float dz = __fadd_rn(cz, -tile[3 * j + 2]);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
      done = true;
#pragma unroll
      for (int r = 0; r < kMaxRadii; ++r) {
        if (r >= radii.count) break;
        const int k = radii.k[r];
        if (found[r] < k) {
          const bool hit = live && d2 < radii.r2[r];
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (mask != 0u) {
            if (found[r] == 0) first[r] = t0 + c0 + __ffs(mask) - 1;
            const int slot = found[r] + __popc(mask & ((1u << lane) - 1u));
            if (hit && slot < k) idx_row[radii.offset[r] + slot] = t0 + j;
            found[r] += __popc(mask);
          }
        }
        done = done && found[r] >= k;
      }
    }
    // Also the barrier that lets the next tile overwrite this one.
    if (__syncthreads_and(done)) break;
  }

  if (!has_row) return;
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r >= radii.count) break;
    const int k = radii.k[r];
    const int got = min(found[r], k);
    for (int slot = got + lane; slot < k; slot += 32) idx_row[radii.offset[r] + slot] = first[r];
    if (lane == 0) {
      out_cnt[(static_cast<long long>(b) * s + row) * radii.count + r] = got;
    }
  }
}

// ------------------------------------------------------------- the cell grid

constexpr int kGridWarps = 8;
constexpr int kNeighbours = 27;
constexpr double kCellClamp = 4611686018427387904.0;  // 2^62

// The cell of one coordinate: floor(x * inv_side) in float64, clamped, as
// the plain `ball_cell_keys` computes it.
__device__ __forceinline__ long long cell_of(float x, double inv_side) {
  const double q = __dmul_rn(static_cast<double>(x), inv_side);
  return static_cast<long long>(floor(fmin(fmax(q, -kCellClamp), kCellClamp)));
}

// (cell) -> bucket within a sample's table of `mask + 1` buckets. Every
// product is below 2^47, so the wrapper's int64 arithmetic gives the same.
__device__ __forceinline__ unsigned long long cell_hash(long long cx, long long cy, long long cz,
                                                        unsigned long long mask) {
  const unsigned long long h = ((static_cast<unsigned long long>(cx) & 0xFFFFFull) * 73856093ull) ^
                               ((static_cast<unsigned long long>(cy) & 0xFFFFFull) * 19349663ull) ^
                               ((static_cast<unsigned long long>(cz) & 0xFFFFFull) * 83492791ull);
  return (h ^ (h >> 20)) & mask;
}

// Bucket of every point of the (B, N) clouds, int32; invalid points get
// `sentinel` (B * buckets).
__global__ void ball_keys_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                                 int* __restrict__ keys, long long count, int n, int log2_buckets,
                                 double inv_side, int sentinel) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  if (!valid[i]) {
    keys[i] = sentinel;
    return;
  }
  const long long b = i / n;
  const unsigned long long h =
      cell_hash(cell_of(points[3 * i], inv_side), cell_of(points[3 * i + 1], inv_side),
                cell_of(points[3 * i + 2], inv_side), (1ull << log2_buckets) - 1ull);
  keys[i] = static_cast<int>((static_cast<unsigned long long>(b) << log2_buckets) | h);
}

// starts[j] = the first position of the sorted keys at or above bucket j,
// for j in [0, buckets_total].
__global__ void ball_starts_kernel(const int* __restrict__ sorted, int* __restrict__ starts,
                                   int count, int buckets_total) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > buckets_total) return;
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  starts[j] = lo;
}

__global__ void __launch_bounds__(kGridWarps * 32)
ball_grid_kernel(const float* __restrict__ centers, const float* __restrict__ points,
                 const long long* __restrict__ order, const int* __restrict__ starts,
                 int* __restrict__ out_idx, int* __restrict__ out_cnt, long long rows, int s,
                 int n, int ktot, int log2_buckets, double inv_side, float r2_max, Radii radii) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kGridWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const long long b = row / s;
  const float cx = centers[3 * row], cy = centers[3 * row + 1], cz = centers[3 * row + 2];
  const long long sample_base = b * n;

  // Lane l < 27 owns neighbouring cell (l % 3 - 1, l / 3 % 3 - 1, l / 9 - 1);
  // lanes without a cell get values no bucket has.
  unsigned long long bucket = ~0ull - lane;
  if (lane < kNeighbours) {
    const long long x = cell_of(cx, inv_side) + lane % 3 - 1;
    const long long y = cell_of(cy, inv_side) + lane / 3 % 3 - 1;
    const long long z = cell_of(cz, inv_side) + lane / 9 - 1;
    bucket = (static_cast<unsigned long long>(b) << log2_buckets) |
             cell_hash(x, y, z, (1ull << log2_buckets) - 1ull);
  }
  const unsigned same = __match_any_sync(0xffffffffu, bucket);
  int pos = 0, end = 0;
  if (lane < kNeighbours && __ffs(same) - 1 == lane) {
    pos = starts[bucket];
    end = starts[bucket + 1];
  }

  // This lane's head: its next point inside the largest radius, or INT_MAX.
  int head = INT_MAX;
  float head_d2 = 0.0f;
  auto advance = [&]() {
    head = INT_MAX;
    for (; pos < end; ++pos) {
      const long long g = order[pos];  // b * n + index: a bucket holds one sample's points
      const float dx = __fadd_rn(cx, -points[3 * g]);
      const float dy = __fadd_rn(cy, -points[3 * g + 1]);
      const float dz = __fadd_rn(cz, -points[3 * g + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < r2_max) {
        head = static_cast<int>(g - sample_base);
        head_d2 = d2;
        return;
      }
    }
  };
  advance();

  int* idx_row = out_idx + row * ktot;
  int found[kMaxRadii];
  int first[kMaxRadii];
#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    found[r] = 0;
    first[r] = 0;
  }
  while (true) {
    const int m = __reduce_min_sync(0xffffffffu, head);
    if (m == INT_MAX) break;
    const int owner = __ffs(__ballot_sync(0xffffffffu, head == m)) - 1;
    const float d2 = __shfl_sync(0xffffffffu, head_d2, owner);
    bool full = true;
#pragma unroll
    for (int r = 0; r < kMaxRadii; ++r) {
      if (r >= radii.count) break;
      if (found[r] < radii.k[r] && d2 < radii.r2[r]) {
        if (lane == 0) idx_row[radii.offset[r] + found[r]] = m;
        if (found[r] == 0) first[r] = m;
        ++found[r];
      }
      full = full && found[r] >= radii.k[r];
    }
    if (full) break;
    if (lane == owner) {
      ++pos;
      advance();
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRadii; ++r) {
    if (r >= radii.count) break;
    for (int slot = found[r] + lane; slot < radii.k[r]; slot += 32) {
      idx_row[radii.offset[r] + slot] = first[r];
    }
    if (lane == 0) out_cnt[row * radii.count + r] = found[r];
  }
}

}  // namespace

namespace {

// Fills `radii` from the host arrays; returns the total of k, or -1 for a
// count the kernels cannot take.
int make_radii(Radii* radii, int n_radii, const float* r2, const int* k) {
  if (n_radii < 1 || n_radii > kMaxRadii) return -1;
  radii->count = n_radii;
  int ktot = 0;
  for (int i = 0; i < kMaxRadii; ++i) {
    radii->r2[i] = i < n_radii ? r2[i] : 0.0f;
    radii->k[i] = i < n_radii ? k[i] : 0;
    radii->offset[i] = ktot;
    ktot += radii->k[i];
  }
  return ktot;
}

}  // namespace

// For `batch` clouds: `s` centres ((B, S, 3) float32) against `n` points
// ((B, N, 3) float32, (B, N) uint8 valid) at `n_radii` <= 4 radii. `r2[i]` is
// the squared radius as float32, `k[i]` the number of samples; the indices of
// radius i go to columns [sum(k[:i]), sum(k[:i+1])) of `out_idx`
// ((B, S, sum(k)) int32) and its count to column i of `out_cnt`
// ((B, S, n_radii) int32). Returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int ball_query_launch(const void* centers, const void* points, const void* valid,
                                 void* out_idx, void* out_cnt, int batch, int s, int n,
                                 int n_radii, const float* r2, const int* k, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Radii radii;
  const int ktot = make_radii(&radii, n_radii, r2, k);
  if (ktot < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || s <= 0 || ktot <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks_per_cloud = (s + kWarps - 1) / kWarps;
  const long long blocks = static_cast<long long>(batch) * blocks_per_cloud;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<const uint8_t*>(valid), static_cast<int*>(out_idx),
      static_cast<int*>(out_cnt), s, n, ktot, blocks_per_cloud, radii);
  return static_cast<int>(cudaGetLastError());
}

// The cell grid's table, step one: `keys` ((B, N) int32) gets each point's
// bucket for cells of 1 / `inv_side` and 2^`log2_buckets` buckets a sample,
// B << log2_buckets for an invalid point. The wrapper then sorts the keys
// (stably) into `sorted` and `order` for `ball_grid_launch`. Returns the CUDA
// error of the launch, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int ball_grid_keys_launch(const void* points, const void* valid, void* keys, int batch,
                                     int n, int log2_buckets, double inv_side, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || batch < 0 || log2_buckets < 0 || log2_buckets > 30 || !(inv_side > 0.0) ||
      (static_cast<long long>(batch) << log2_buckets) > 2147483646LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long count = static_cast<long long>(batch) * n;
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  ball_keys_kernel<<<static_cast<unsigned int>((count + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid), static_cast<int*>(keys),
      count, n, log2_buckets, inv_side, batch << log2_buckets);
  return static_cast<int>(cudaGetLastError());
}

// The query through the cell table, step two: `sorted` ((B * N,) int32, the
// keys of `ball_grid_keys_launch` in ascending order) and `order` ((B * N,)
// int64, the flat point index b * N + i of each, ascending within a bucket)
// as the stable sort gives them; `starts` (((B << log2_buckets) + 1,) int32)
// is scratch for each bucket's first position. `inv_side` and
// `log2_buckets` are the keys'. Same outputs and errors as
// `ball_query_launch`.
extern "C" int ball_grid_launch(const void* centers, const void* points, const void* sorted,
                                const void* order, void* starts, void* out_idx, void* out_cnt,
                                int batch, int s, int n, int log2_buckets, double inv_side,
                                int n_radii, const float* r2, const int* k, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Radii radii;
  const int ktot = make_radii(&radii, n_radii, r2, k);
  if (ktot < 0 || n < 0 || batch < 0 || log2_buckets < 0 || log2_buckets > 30 ||
      !(inv_side > 0.0) || (static_cast<long long>(batch) << log2_buckets) > 2147483646LL ||
      static_cast<long long>(batch) * n > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float r2_max = r2[0];
  for (int i = 1; i < n_radii; ++i) r2_max = fmaxf(r2_max, r2[i]);
  if (batch <= 0 || s <= 0 || ktot <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int buckets_total = batch << log2_buckets;
  ball_starts_kernel<<<buckets_total / 256 + 1, 256, 0, st>>>(
      static_cast<const int*>(sorted), static_cast<int*>(starts), batch * n, buckets_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * s;
  const long long blocks = (rows + kGridWarps - 1) / kGridWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ball_grid_kernel<<<static_cast<unsigned int>(blocks), kGridWarps * 32, 0, st>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<const long long*>(order), static_cast<const int*>(starts),
      static_cast<int*>(out_idx), static_cast<int*>(out_cnt), rows, s, n, ktot, log2_buckets,
      inv_side, r2_max, radii);
  return static_cast<int>(cudaGetLastError());
}
