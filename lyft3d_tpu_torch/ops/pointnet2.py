"""PointNet++ primitives: furthest-point sampling, ball query, grouping,
3-NN interpolation, RoI pooling (port of ``lyft3d_tpu/ops/pointnet2.py`` and
``lyft3d_tpu/ops/select_kernel.py``).

Everything is batched: points are ``(B, N, 3)`` float32 with a ``(B, N)``
bool validity mask, features ``(B, N, C)``; the JAX package's ``vmap`` over
samples (and over RoIs) is the leading dimension here. Index outputs are
int32, as in JAX.

Four functions are kernel wrappers. Each chooses its path by the device of
its tensors alone:

- CUDA tensor: launches the hand-written kernel (``csrc/fps.cu``,
  ``csrc/ball_query.cu``, ``csrc/knn.cu``, ``csrc/roi_select.cu``, built by
  ``nvcc`` at first use) or raises. There is no fallback. FPS and ball query
  have two kernels each, chosen by a pure function of the shape
  (:func:`_fps_launch_shape`, :func:`_ball_query_kernel`); 3-NN's split of
  the work is :func:`_knn_launch_shape`, RoI select's boxes and threads a
  block :func:`_roi_launch_shape`.
- CPU tensor: runs the plain version beside it.
- anything else: raises.

=========================  ==============================  ===================
wrapper                    plain version                   kernel
=========================  ==============================  ===================
:func:`fps`                :func:`furthest_point_sample`   ``fps``
:func:`multi_radius_ball_query`, :func:`ball_query`
                           :func:`multi_radius_ball_query_dense`
                                                           ``ball_query``
:func:`three_nn`           :func:`three_nn_dense`          ``knn``
:func:`roi_inside_select`  :func:`roi_inside_select_dense` ``roi_select``
=========================  ==============================  ===================

The kernels return indices, so kernel and plain version must round alike:
every squared distance is ``((dx·dx) + (dy·dy)) + (dz·dz)`` in separate
float32 multiplies and adds (:func:`_sq_dist`), a squared radius is rounded
to float32 once on the host, and a box reaches both versions as the same
eight float32 numbers (:func:`_box_params`).

The JAX package's size thresholds, its ``approx_min_k`` paths and
``grid_multi_radius_ball_query`` exist for the TPU and are not ported. The
port's own choices are shape rules over exact kernels: FPS's launch shape,
ball query's scan or hashed cell grid (``csrc/ball_query.cu`` states why the
grid's 27 cells hold every hit), and 3-NN's split of the known cloud.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from lyft3d_tpu_torch import _build

__all__ = [
    "KERNEL_LAUNCHES",
    "furthest_point_sample",
    "fps",
    "ball_query",
    "multi_radius_ball_query",
    "multi_radius_ball_query_dense",
    "group_points",
    "three_nn",
    "three_nn_dense",
    "three_interpolate",
    "roi_inside_select",
    "roi_inside_select_dense",
    "roi_pool3d",
]

# Number of times each wrapper launched its CUDA kernel in this process.
KERNEL_LAUNCHES: Dict[str, int] = {"fps": 0, "ball_query": 0, "knn": 0, "roi_select": 0}

_BIG = 1e10
MISS_DISTANCE = 1e5  # distance of an open 3-NN slot (sqrt of the JAX kernel's 1e10)
MAX_RADII = 4  # csrc/ball_query.cu kMaxRadii
FPS_MAX_POINTS = 65536  # 1,024 threads x 64 register slots in csrc/fps.cu
FPS_CLUSTER = 16  # CTAs a cloud of the cluster kernel (at most csrc/fps.cu kMaxCluster)
FPS_CLUSTER_THREADS = 256  # csrc/fps.cu kClusterThreads
FPS_SMS = 132  # an H100 SXM's SMs: from this many clouds on, one block a cloud fills the card
BALL_GRID_MIN_PAIRS = 1 << 26  # (centre, point) pairs from which the cell grid beats the scan
BALL_CELL_MARGIN = 2.0 ** -10  # a cell's side over the largest radius, less one (csrc/ball_query.cu)
BALL_CELL_CLAMP = 2.0 ** 62  # cells are clamped to ±2^62 (int64 with room for the neighbours)
_CELL_PRIMES = (73856093, 19349663, 83492791)  # csrc/ball_query.cu cell_hash
KNN_SHAPES = ((1, 4), (1, 8), (1, 16), (2, 4), (2, 8), (2, 16))  # (queries a thread, threads a query) of csrc/knn.cu
KNN_THREADS = 256  # csrc/knn.cu kThreads
KNN_WAVE = 131072  # threads of about one full wave on an H100 (132 SMs x ~1,000)
ROI_SHAPES = ((1, 256), (2, 256), (4, 256))  # (boxes, threads) a block, csrc/roi_select.cu
ROI_MIN_BLOCKS = 132  # blocks the RoI-select launch keeps as it groups boxes: one an SM of an H100
ROI_MAX_POINTS = 2**31 - 1 - 32 * 256  # int32 point indices with a segment to spare (csrc/roi_select.cu)


# ----------------------------------------------------------------- helpers


def _device_kind(what: str, *tensors) -> str:
    kind = tensors[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {kind!r}")
    for t in tensors[1:]:
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on {tensors[0].device} and {t.device}")
    return kind


def _check_cloud(what: str, points, valid):
    if points.dtype != torch.float32:
        raise TypeError(f"{what}: points must be float32, got {points.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{what}: valid must be bool, got {valid.dtype}")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"{what}: points must be (B, N, 3), got {tuple(points.shape)}")
    if tuple(valid.shape) != tuple(points.shape[:2]):
        raise ValueError(
            f"{what}: valid {tuple(valid.shape)} must be {tuple(points.shape[:2])}"
        )
    if points.shape[1] < 1:
        raise ValueError(f"{what}: the cloud is empty")


def _check_queries(what: str, queries, points, width: int):
    if queries.dtype != torch.float32:
        raise TypeError(f"{what}: queries must be float32, got {queries.dtype}")
    if queries.dim() != 3 or queries.shape[-1] != width or queries.shape[0] != points.shape[0]:
        raise ValueError(
            f"{what}: queries must be ({points.shape[0]}, S, {width}), got {tuple(queries.shape)}"
        )


def _sq_dist(a, b):
    """``(B, S, 3)`` × ``(B, N, 3)`` → ``(B, S, N)`` squared distances,
    ``((dx·dx) + (dy·dy)) + (dz·dz)`` with every product and sum rounded to
    float32 on its own, as the kernels compute it."""
    dx = a[:, :, None, 0] - b[:, None, :, 0]
    dy = a[:, :, None, 1] - b[:, None, :, 1]
    dz = a[:, :, None, 2] - b[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _first_k_true(mask, k: int):
    """Indices of the first ``k`` True entries of each row of ``mask``
    ``(…, N)``, and the found count clipped to ``k``. Open slots repeat the
    first found index, or hold 0 in an empty row."""
    n = mask.shape[-1]
    kk = min(k, n)
    key = torch.where(mask, torch.arange(n, dtype=torch.int32, device=mask.device), n)
    out = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
    if kk < k:
        out = torch.cat([out, out.new_full((*out.shape[:-1], k - kk), n)], dim=-1)
    count = mask.sum(dim=-1).clamp(max=k).to(torch.int32)
    out = torch.where(out >= n, out[..., :1], out)
    out = torch.where(out >= n, 0, out)
    return out.to(torch.int32), count


def _stream(tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def _device_index(tensor) -> int:
    return tensor.device.index if tensor.device.index is not None else torch.cuda.current_device()


def _ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


# --------------------------------------------------- furthest-point sampling


def furthest_point_sample(points, valid, npoint: int):
    """Plain version: ``(B, N, 3)`` → ``(B, npoint)`` int32 indices.

    Starts at the first valid point, then ``npoint − 1`` times lowers a
    running distance to ``min(dist, valid ? d² : −1)`` and takes the argmax
    (the first index on equal values). Invalid points are never picked; with
    fewer valid points than ``npoint`` the picks repeat an argmax.
    """
    b, n, _ = points.shape
    x, y, z = points.unbind(-1)
    rows = torch.arange(b, device=points.device)
    last = valid.to(torch.uint8).argmax(dim=-1)
    dists = torch.where(valid, _BIG, -1.0).to(torch.float32)
    sel = torch.zeros((b, npoint), dtype=torch.int64, device=points.device)
    sel[:, 0] = last
    for i in range(1, npoint):
        p = points[rows, last]
        dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
        d = (dx * dx + dy * dy) + dz * dz
        dists = torch.minimum(dists, torch.where(valid, d, -1.0))
        last = dists.argmax(dim=-1)
        sel[:, i] = last
    return sel.to(torch.int32)


def _fps_library(entry: str = "fps_launch"):
    fn = getattr(_build.load_library("fps"), entry)
    if fn.argtypes is None:
        fn.argtypes = {
            "fps_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
            "fps_max_active_clusters": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
        }[entry]
        fn.restype = ctypes.c_int
    return fn


def _fps_launch_shape(batch: int, n: int) -> Tuple[int, int, int]:
    """The one rule that picks the FPS kernel and its shape for ``batch``
    clouds of ``n`` points: ``(ctas, threads, slots)`` with ``ctas · threads ·
    slots ≥ n``.

    The cluster kernel, :data:`FPS_CLUSTER` CTAs of 256 threads a cloud, where
    one block a cloud would leave SMs idle (fewer clouds than :data:`FPS_SMS`)
    and each of the cluster's threads holds more than one point (``n`` above
    4,096): there a step's exchange across the cluster costs less than the
    arithmetic and reductions it spreads. Otherwise the one-block kernel, one
    block a cloud with about 8 points a thread, whole warps, at most 1,024
    threads: the RCNN's 400 RoI clouds fill the card, and on 4,096 points or
    fewer one block's step is the shorter (both measured on an H100 by
    ``chip_smoke.py``, phase 8)."""
    if batch < FPS_SMS and n > FPS_CLUSTER * FPS_CLUSTER_THREADS:
        slots = 1
        while FPS_CLUSTER * FPS_CLUSTER_THREADS * slots < n:
            slots *= 2
        return FPS_CLUSTER, FPS_CLUSTER_THREADS, slots
    threads = 32
    while threads < 1024 and threads * 8 < n:
        threads *= 2
    slots = 1
    while threads * slots < n:
        slots *= 2
    return 1, threads, slots


def fps_max_active_clusters(ctas: int, slots: int, device=None) -> int:
    """How many clouds the cluster kernel with ``ctas`` CTAs of ``slots``
    slots a thread keeps resident on the card at once
    (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _raise_on(_fps_library("fps_max_active_clusters")(ctas, slots, index, ctypes.byref(count)),
              "fps occupancy query")
    return count.value


def _fps_cuda(points, valid, npoint: int):
    launch = _fps_library()
    b, n, _ = points.shape
    if n > FPS_MAX_POINTS:
        raise ValueError(f"fps: the kernel takes at most {FPS_MAX_POINTS} points, got {n}")
    points, valid = points.contiguous(), valid.contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    ctas, threads, slots = _fps_launch_shape(b, n)
    err = launch(_ptr(points), _ptr(valid), _ptr(out), b, n, npoint, ctas, threads, slots,
                 _device_index(points), _stream(points))
    _raise_on(err, "fps")
    KERNEL_LAUNCHES["fps"] += 1
    return out


def fps(points, valid, npoint: int):
    """Furthest-point sampling, ``(B, N, 3)`` + ``(B, N)`` → ``(B, npoint)``
    int32: the CUDA kernel for CUDA tensors, :func:`furthest_point_sample`
    for CPU tensors, an error otherwise."""
    kind = _device_kind("fps", points, valid)
    _check_cloud("fps", points, valid)
    if npoint < 1:
        raise ValueError(f"fps: npoint must be positive, got {npoint}")
    if kind == "cuda":
        return _fps_cuda(points, valid, npoint)
    return furthest_point_sample(points, valid, npoint)


# ---------------------------------------------------------------- ball query


def _squared_radii(radii: Sequence[float]) -> List[float]:
    """``r·r`` in double precision, rounded to float32 once (the JAX kernel
    compares against ``r * r`` of Python floats as a float32 constant)."""
    return [float(np.float32(float(r) * float(r))) for r in radii]


def multi_radius_ball_query_dense(centers, points, valid, radii, nsamples):
    """Plain version of :func:`multi_radius_ball_query`: one ``(B, S, N)``
    distance matrix, then mask and first-k per radius."""
    d2 = _sq_dist(centers, points)
    ok = valid[:, None, :]
    return [_first_k_true((d2 < r2) & ok, int(k))
            for r2, k in zip(_squared_radii(radii), nsamples)]


def _ball_query_library(entry: str = "ball_query_launch"):
    fn = getattr(_build.load_library("ball_query"), entry)
    if fn.argtypes is None:
        radii = [ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        fn.argtypes = {
            "ball_query_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + radii
            + [ctypes.c_int, ctypes.c_void_p],
            "ball_grid_keys_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_double]
            + [ctypes.c_int, ctypes.c_void_p],
            "ball_grid_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_double]
            + radii + [ctypes.c_int, ctypes.c_void_p],
        }[entry]
        fn.restype = ctypes.c_int
    return fn


def _ball_query_kernel(batch: int, s: int, n: int, r_max: float) -> str:
    """The one rule that picks the ball-query kernel: ``"grid"`` (the cell
    table and the 27-bucket merge) from :data:`BALL_GRID_MIN_PAIRS` (centre,
    point) pairs on, ``"scan"`` (every pair tested) below. The grid's route
    costs about 0.2 ms a call whatever the shape (its table: a keys launch
    and a stable sort, most of it on the host), the scan about 3 ns for 1,000
    pairs, so they cross near 2^26 pairs: on an H100 the grid won at 4 x
    4,096 x 16,384 (2^28 pairs) by about four times and lost at the five
    other shapes of a PointRCNN call, 2^16 to 2^24.6 pairs, both on a uniform
    cloud and on a LiDAR-like one, dense near the sensor and on the ground
    (``chip_smoke.py``, phase 10). The scan stops early only where every
    radius fills, which at these shapes is rare on either cloud.
    A radius that is not a positive finite number has no cells: the scan."""
    if not (0.0 < r_max < float("inf")):
        return "scan"
    return "grid" if batch * s * n >= BALL_GRID_MIN_PAIRS else "scan"


def _ball_cell_inverse(radii: Sequence[float]) -> float:
    """``1 / side`` of the cell grid, in float64: the side is the largest
    radius (as the float32 square the kernels compare against) enlarged by
    :data:`BALL_CELL_MARGIN`, so that every point within it lies in one of a
    centre's 27 cells (the argument is in ``csrc/ball_query.cu``)."""
    return 1.0 / (math.sqrt(max(_squared_radii(radii))) * (1.0 + BALL_CELL_MARGIN))


def _ball_buckets(n: int) -> int:
    """Buckets a sample: the power of two at or above ``2 n``, at least 16."""
    return 1 << max(4, (2 * n - 1).bit_length())


def _cell_bucket(cells, buckets: int):
    """``(…, 3)`` int64 cells → ``(…)`` int64 bucket in ``[0, buckets)``;
    the arithmetic of ``cell_hash`` in ``csrc/ball_query.cu`` (every product
    below 2^47, no overflow)."""
    m = cells & 0xFFFFF
    h = (m[..., 0] * _CELL_PRIMES[0]) ^ (m[..., 1] * _CELL_PRIMES[1]) ^ (m[..., 2] * _CELL_PRIMES[2])
    return (h ^ (h >> 20)) & (buckets - 1)


def _check_buckets(buckets: int, batch: int, n: int):
    if buckets < 1 or buckets & (buckets - 1):
        raise ValueError(f"ball query: buckets must be a power of two, got {buckets}")
    if batch * buckets >= 2 ** 31 - 1 or batch * n >= 2 ** 31:
        raise ValueError(f"ball query: the cell grid takes fewer than 2^31 buckets and points, "
                         f"got {batch} x {buckets} and {batch} x {n}")


def ball_cell_keys(points, valid, inv_side: float, buckets: int):
    """Plain version of the grid's keys: ``(B, N)`` int32, the bucket
    ``b · buckets + hash(cell)`` of each valid point, ``B · buckets`` for an
    invalid one. The cell is ``floor(p · inv_side)`` per axis in float64,
    clamped to ±2^62 (``csrc/ball_query.cu``, ``ball_keys_kernel``)."""
    b, n, _ = points.shape
    _check_buckets(buckets, b, n)
    cells = torch.floor(points.double() * inv_side).clamp_(-BALL_CELL_CLAMP, BALL_CELL_CLAMP).long()
    bucket = _cell_bucket(cells, buckets) + torch.arange(b, device=points.device)[:, None] * buckets
    return torch.where(valid, bucket, b * buckets).int()


def _ball_cell_keys_cuda(points, valid, inv_side: float, buckets: int):
    b, n, _ = points.shape
    _check_buckets(buckets, b, n)
    points, valid = points.contiguous(), valid.contiguous()
    keys = torch.empty((b, n), dtype=torch.int32, device=points.device)
    err = _ball_query_library("ball_grid_keys_launch")(
        _ptr(points), _ptr(valid), _ptr(keys), b, n, buckets.bit_length() - 1, inv_side,
        _device_index(points), _stream(points))
    _raise_on(err, "ball_query (cell keys)")
    return keys


def ball_cell_table(points, valid, inv_side: float, buckets: int):
    """Plain version of the grid kernel's cell table: ``(order (B·N,)
    int64, starts (B·buckets + 1,) int64)``. ``order`` lists flat point
    indices ``b · N + i`` sorted by (bucket of :func:`ball_cell_keys`,
    index), invalid points last; bucket ``j`` holds
    ``order[starts[j]:starts[j + 1]]``."""
    b = points.shape[0]
    keys, order = torch.sort(ball_cell_keys(points, valid, inv_side, buckets).flatten(), stable=True)
    starts = torch.searchsorted(keys, torch.arange(b * buckets + 1, dtype=torch.int32,
                                                   device=points.device))
    return order, starts


def _ball_args(radii, nsamples):
    ks = [int(k) for k in nsamples]
    return (len(ks), (ctypes.c_float * len(ks))(*_squared_radii(radii)), (ctypes.c_int * len(ks))(*ks))


def _ball_outputs(centers, ks):
    b, s, _ = centers.shape
    idx = torch.empty((b, s, sum(ks)), dtype=torch.int32, device=centers.device)
    cnt = torch.empty((b, s, len(ks)), dtype=torch.int32, device=centers.device)
    return idx, cnt


def _ball_scan_cuda(centers, points, valid, radii, nsamples):
    launch = _ball_query_library()
    b, n, _ = points.shape
    s = centers.shape[1]
    ks = [int(k) for k in nsamples]
    centers, points, valid = centers.contiguous(), points.contiguous(), valid.contiguous()
    idx, cnt = _ball_outputs(centers, ks)
    err = launch(_ptr(centers), _ptr(points), _ptr(valid), _ptr(idx), _ptr(cnt),
                 b, s, n, *_ball_args(radii, ks), _device_index(points), _stream(points))
    _raise_on(err, "ball_query")
    KERNEL_LAUNCHES["ball_query"] += 1
    return [(part, cnt[..., j]) for j, part in enumerate(torch.split(idx, ks, dim=-1))]


def _ball_grid_table(points, valid, radii, buckets: int = None):
    """The grid kernel's cell table, step one: the keys kernel and one stable
    sort. Returns ``(sorted keys, order, inv_side, buckets)`` for
    :func:`_ball_grid_select`. ``buckets`` a sample defaults to
    :func:`_ball_buckets`; a smaller power of two forces hash collisions (for
    tests)."""
    buckets = _ball_buckets(points.shape[1]) if buckets is None else int(buckets)
    inv_side = _ball_cell_inverse(radii)
    keys, order = torch.sort(_ball_cell_keys_cuda(points, valid, inv_side, buckets).view(-1), stable=True)
    return keys, order, inv_side, buckets


def _ball_grid_select(centers, points, table, radii, nsamples):
    """The grid kernel, step two, over a table of :func:`_ball_grid_table`:
    one launch that finds the bucket starts and selects."""
    keys, order, inv_side, buckets = table
    b, n, _ = points.shape
    ks = [int(k) for k in nsamples]
    centers, points = centers.contiguous(), points.contiguous()
    starts = torch.empty(b * buckets + 1, dtype=torch.int32, device=points.device)
    idx, cnt = _ball_outputs(centers, ks)
    err = _ball_query_library("ball_grid_launch")(
        _ptr(centers), _ptr(points), _ptr(keys), _ptr(order), _ptr(starts), _ptr(idx), _ptr(cnt),
        b, centers.shape[1], n, buckets.bit_length() - 1, inv_side, *_ball_args(radii, ks),
        _device_index(points), _stream(points))
    _raise_on(err, "ball_query (cell grid)")
    KERNEL_LAUNCHES["ball_query"] += 1
    return [(part, cnt[..., j]) for j, part in enumerate(torch.split(idx, ks, dim=-1))]


def _ball_grid_cuda(centers, points, valid, radii, nsamples, buckets: int = None):
    """The grid kernel: its table, then its selection."""
    return _ball_grid_select(centers, points, _ball_grid_table(points, valid, radii, buckets),
                             radii, nsamples)


def _ball_query_cuda(centers, points, valid, radii, nsamples):
    b, n, _ = points.shape
    r_max = math.sqrt(max(_squared_radii(radii)))
    if _ball_query_kernel(b, centers.shape[1], n, r_max) == "grid":
        return _ball_grid_cuda(centers, points, valid, radii, nsamples)
    return _ball_scan_cuda(centers, points, valid, radii, nsamples)


def multi_radius_ball_query(centers, points, valid, radii, nsamples):
    """Ball query at several radii around ``(B, S, 3)`` centres in a
    ``(B, N, 3)`` cloud. Returns ``[(idx (B, S, k) int32, count (B, S)
    int32), …]``, one pair per radius: the first ``k`` valid point indices
    with ``d² < r²`` in index order; open slots repeat the first hit, a row
    without a hit is all 0, the count is clipped to ``k``.

    A CUDA kernel (all radii in one pass; the scan or the cell grid by
    :func:`_ball_query_kernel`) for CUDA tensors,
    :func:`multi_radius_ball_query_dense` for CPU tensors, an error otherwise.
    """
    kind = _device_kind("ball query", points, valid, centers)
    _check_cloud("ball query", points, valid)
    _check_queries("ball query", centers, points, 3)
    if len(radii) != len(nsamples) or not 1 <= len(radii) <= MAX_RADII:
        raise ValueError(
            f"ball query takes 1 to {MAX_RADII} radii with one sample count each, "
            f"got {len(radii)} radii and {len(nsamples)} counts"
        )
    if min(int(k) for k in nsamples) < 1:
        raise ValueError(f"ball query: sample counts must be positive, got {tuple(nsamples)}")
    if kind == "cuda":
        return _ball_query_cuda(centers, points, valid, radii, nsamples)
    return multi_radius_ball_query_dense(centers, points, valid, radii, nsamples)


def ball_query(centers, points, valid, radius: float, nsample: int):
    """Single-radius :func:`multi_radius_ball_query`: ``(idx, count)``."""
    return multi_radius_ball_query(centers, points, valid, (radius,), (nsample,))[0]


def group_points(features, idx):
    """Gather ``(B, N, C)`` features by ``(B, S, K)`` indices → ``(B, S, K, C)``."""
    rows = torch.arange(features.shape[0], device=features.device)[:, None, None]
    return features[rows, idx.long()]


# ----------------------------------------------------------------------- 3-NN


def three_nn_dense(unknown, known, known_valid):
    """Plain version of :func:`three_nn`: the full ``(B, S, M)`` distance
    matrix, invalid known points at infinity, a stable ascending sort (equal
    distances keep the lower index), the first three."""
    m = known.shape[1]
    d2 = _sq_dist(unknown, known)
    d2 = torch.where(known_valid[:, None, :], d2, float("inf"))
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    d2, idx = d2[..., :3], idx[..., :3]
    if m < 3:
        pad = (*d2.shape[:-1], 3 - m)
        d2 = torch.cat([d2, d2.new_full(pad, float("inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
    miss = torch.isinf(d2)
    dists = torch.where(miss, MISS_DISTANCE, torch.sqrt(d2.clamp_min(0.0)))
    return dists, torch.where(miss, m - 1, idx).to(torch.int32)


def _knn_library():
    fn = _build.load_library("knn").knn3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _knn_launch_shape(queries: int, m: int) -> Tuple[int, int]:
    """The split of the 3-NN kernel for ``queries`` query points (all
    clouds together) against clouds of ``m`` known points: ``(Q, P)``, Q
    queries a thread and P threads sharing a query's known cloud. Two queries
    a thread from 32,768 queries on, one below; P from 4, doubled up to 16
    while the launch has fewer than :data:`KNN_WAVE` threads. On an H100 this
    picks the least device time, or one within 6% of it, at the four FP
    shapes of a PointRCNN call (``chip_smoke.py``, phase 10); ``m`` does not
    change the choice there."""
    q = 2 if queries >= 32768 else 1
    p = 4
    while p < 16 and queries // q * p < KNN_WAVE:
        p *= 2
    return q, p


def _three_nn_cuda(unknown, known, known_valid, shape: Tuple[int, int] = None):
    launch = _knn_library()
    b, m, _ = known.shape
    s = unknown.shape[1]
    q, p = _knn_launch_shape(b * s, m) if shape is None else shape
    unknown, known, known_valid = unknown.contiguous(), known.contiguous(), known_valid.contiguous()
    idx = torch.empty((b, s, 3), dtype=torch.int32, device=known.device)
    dists = torch.empty((b, s, 3), dtype=torch.float32, device=known.device)
    err = launch(_ptr(unknown), _ptr(known), _ptr(known_valid), _ptr(idx), _ptr(dists),
                 b, s, m, q, p, _device_index(known), _stream(known))
    _raise_on(err, "knn")
    KERNEL_LAUNCHES["knn"] += 1
    return dists, idx


def three_nn(unknown, known, known_valid):
    """For each of ``(B, S, 3)`` unknown points the 3 nearest valid points of
    ``(B, M, 3)`` known ones: ``(dists (B, S, 3), idx (B, S, 3) int32)``,
    nearest first, the lower index on equal distances. With fewer than 3
    valid known points the open slots hold index ``M − 1`` and distance 1e5
    (the contract of the JAX package's ``knn_fused``).

    The CUDA kernel for CUDA tensors, :func:`three_nn_dense` for CPU tensors,
    an error otherwise.
    """
    kind = _device_kind("three_nn", known, known_valid, unknown)
    _check_cloud("three_nn", known, known_valid)
    _check_queries("three_nn", unknown, known, 3)
    if kind == "cuda":
        return _three_nn_cuda(unknown, known, known_valid)
    return three_nn_dense(unknown, known, known_valid)


def three_interpolate(features, idx, dists, eps: float = 1e-8):
    """Inverse-distance weighted interpolation of ``(B, M, C)`` known
    features at ``(B, S, 3)`` idx/dists → ``(B, S, C)`` float32."""
    w = 1.0 / (dists * dists + eps)
    w = w / w.sum(dim=-1, keepdim=True)
    return (group_points(features, idx).to(w.dtype) * w[..., None]).sum(dim=-2)


# ------------------------------------------------------------------ RoI pool


def _box_params(boxes, extra_width: float):
    """``(B, R, 7)`` ``[x, y, z, w, l, h, yaw]`` (z at the centre) → ``(B, R, 8)``
    float32 ``[cx, cy, cz, hl, hw, hh, cos, sin]`` with half sizes
    ``size/2 + extra_width``, the form of the JAX kernel."""
    half = boxes[..., 3:6] / 2 + extra_width
    yaw = boxes[..., 6]
    return torch.stack([
        boxes[..., 0], boxes[..., 1], boxes[..., 2],
        half[..., 1], half[..., 0], half[..., 2],
        torch.cos(yaw), torch.sin(yaw),
    ], dim=-1)


def _roi_inside_select_dense(params, points, valid, num_sampled: int):
    cx, cy, cz, hl, hw, hh, c, s = (params[..., i, None] for i in range(8))
    dx = points[:, None, :, 0] - cx
    dy = points[:, None, :, 1] - cy
    dz = points[:, None, :, 2] - cz
    lx = c * dx + s * dy
    ly = (-s) * dx + c * dy
    inside = (lx.abs() <= hl) & (ly.abs() <= hw) & (dz.abs() <= hh) & valid[:, None, :]
    return _first_k_true(inside, num_sampled)


def roi_inside_select_dense(points, valid, boxes, num_sampled: int, extra_width: float = 0.0):
    """Plain version of :func:`roi_inside_select`: the ``(B, R, N)`` in-box
    mask, then first-k."""
    return _roi_inside_select_dense(_box_params(boxes, extra_width), points, valid, num_sampled)


def _roi_select_library():
    fn = _build.load_library("roi_select").roi_select_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _roi_launch_shape(boxes: int) -> Tuple[int, int]:
    """The launch shape of the RoI-select kernel for ``boxes`` boxes (all
    samples together): ``(G, T)``, G boxes a block of T threads, one of
    :data:`ROI_SHAPES`. G doubles from 1 (up to 4)
    while the launch keeps at least :data:`ROI_MIN_BLOCKS` blocks; T is 256.
    On an H100 (``chip_smoke.py``, phase 8) this picks the least time queued
    on the card of G = 1, 2, 4 at the PointRCNN call's 4 × 100 boxes over
    16,384 points (G = 2), on a uniform and on a LiDAR-like cloud, and at the
    RCNN training shape's 4 × 512 boxes (G = 4); blocks of 128 threads were
    slower at both (PERF.md §6)."""
    g = 1
    while g < 4 and boxes // (2 * g) >= ROI_MIN_BLOCKS:
        g *= 2
    return g, 256


def _roi_select_cuda(params, points, valid, num_sampled: int, shape: Tuple[int, int] = None):
    launch = _roi_select_library()
    b, n, _ = points.shape
    r = params.shape[1]
    if n > ROI_MAX_POINTS:
        raise ValueError(f"roi_inside_select: the kernel takes at most {ROI_MAX_POINTS} points, got {n}")
    g, threads = _roi_launch_shape(b * r) if shape is None else shape
    if (g, threads) not in ROI_SHAPES:
        raise ValueError(f"roi_inside_select: no kernel of {g} boxes a block of {threads} threads")
    params, points, valid = params.contiguous(), points.contiguous(), valid.contiguous()
    idx = torch.empty((b, r, num_sampled), dtype=torch.int32, device=points.device)
    cnt = torch.empty((b, r), dtype=torch.int32, device=points.device)
    err = launch(_ptr(params), _ptr(points), _ptr(valid), _ptr(idx), _ptr(cnt),
                 b, r, n, num_sampled, g, threads, _device_index(points), _stream(points))
    _raise_on(err, "roi_select")
    KERNEL_LAUNCHES["roi_select"] += 1
    return idx, cnt


def roi_inside_select(points, valid, boxes, num_sampled: int, extra_width: float = 0.0):
    """The first ``num_sampled`` valid points of a ``(B, N, 3)`` cloud inside
    each of ``(B, R, 7)`` rotated boxes enlarged by ``extra_width`` on every
    side (faces included): ``(idx (B, R, k) int32, count (B, R) int32)``.
    Open slots repeat the first member; an empty box is all 0 with count 0.

    The CUDA kernel for CUDA tensors, :func:`roi_inside_select_dense` for CPU
    tensors, an error otherwise.
    """
    kind = _device_kind("roi_inside_select", points, valid, boxes)
    _check_cloud("roi_inside_select", points, valid)
    _check_queries("roi_inside_select", boxes, points, 7)
    if num_sampled < 1:
        raise ValueError(f"roi_inside_select: num_sampled must be positive, got {num_sampled}")
    params = _box_params(boxes, extra_width)
    if kind == "cuda":
        return _roi_select_cuda(params, points, valid, num_sampled)
    return _roi_inside_select_dense(params, points, valid, num_sampled)


def roi_pool3d(points, features, valid, boxes, num_sampled: int = 512,
               extra_width: float = 0.0):
    """Sample up to ``num_sampled`` points inside each ``(B, R, 7)`` box and
    gather their xyz and ``(B, N, C)`` features: ``(pooled (B, R, k, 3 + C)
    float32, count (B, R), empty (B, R))``. Empty boxes are zeroed and
    flagged."""
    idx, count = roi_inside_select(points, valid, boxes, num_sampled, extra_width)
    feats = torch.cat([points, features.to(points.dtype)], dim=-1)
    pooled = group_points(feats, idx) * (count > 0)[..., None, None].to(feats.dtype)
    return pooled, count, count == 0
