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
  ``nvcc`` at first use) or raises. There is no fallback.
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
``grid_multi_radius_ball_query`` exist for the TPU and are not ported: one
path serves every size.
"""

from __future__ import annotations

import ctypes
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


def _fps_library():
    fn = _build.load_library("fps").fps_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _fps_launch_shape(n: int) -> Tuple[int, int]:
    """Threads a block and register slots a thread for a cloud of ``n``
    points: about 8 points a thread, whole warps, at most 1,024 threads."""
    threads = 32
    while threads < 1024 and threads * 8 < n:
        threads *= 2
    slots = 1
    while threads * slots < n:
        slots *= 2
    return threads, slots


def _fps_cuda(points, valid, npoint: int):
    launch = _fps_library()
    b, n, _ = points.shape
    if n > FPS_MAX_POINTS:
        raise ValueError(f"fps: the kernel takes at most {FPS_MAX_POINTS} points, got {n}")
    points, valid = points.contiguous(), valid.contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    threads, slots = _fps_launch_shape(n)
    err = launch(_ptr(points), _ptr(valid), _ptr(out), b, n, npoint, threads, slots,
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


def _ball_query_library():
    fn = _build.load_library("ball_query").ball_query_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _ball_query_cuda(centers, points, valid, radii, nsamples):
    launch = _ball_query_library()
    b, n, _ = points.shape
    s = centers.shape[1]
    ks = [int(k) for k in nsamples]
    centers, points, valid = centers.contiguous(), points.contiguous(), valid.contiguous()
    idx = torch.empty((b, s, sum(ks)), dtype=torch.int32, device=points.device)
    cnt = torch.empty((b, s, len(ks)), dtype=torch.int32, device=points.device)
    r2 = (ctypes.c_float * len(ks))(*_squared_radii(radii))
    k_arr = (ctypes.c_int * len(ks))(*ks)
    err = launch(_ptr(centers), _ptr(points), _ptr(valid), _ptr(idx), _ptr(cnt),
                 b, s, n, len(ks), r2, k_arr, _device_index(points), _stream(points))
    _raise_on(err, "ball_query")
    KERNEL_LAUNCHES["ball_query"] += 1
    return [(part, cnt[..., j]) for j, part in enumerate(torch.split(idx, ks, dim=-1))]


def multi_radius_ball_query(centers, points, valid, radii, nsamples):
    """Ball query at several radii around ``(B, S, 3)`` centres in a
    ``(B, N, 3)`` cloud. Returns ``[(idx (B, S, k) int32, count (B, S)
    int32), …]``, one pair per radius: the first ``k`` valid point indices
    with ``d² < r²`` in index order; open slots repeat the first hit, a row
    without a hit is all 0, the count is clipped to ``k``.

    The CUDA kernel (all radii in one scan) for CUDA tensors,
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _three_nn_cuda(unknown, known, known_valid):
    launch = _knn_library()
    b, m, _ = known.shape
    s = unknown.shape[1]
    unknown, known, known_valid = unknown.contiguous(), known.contiguous(), known_valid.contiguous()
    idx = torch.empty((b, s, 3), dtype=torch.int32, device=known.device)
    dists = torch.empty((b, s, 3), dtype=torch.float32, device=known.device)
    err = launch(_ptr(unknown), _ptr(known), _ptr(known_valid), _ptr(idx), _ptr(dists),
                 b, s, m, _device_index(known), _stream(known))
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _roi_select_cuda(params, points, valid, num_sampled: int):
    launch = _roi_select_library()
    b, n, _ = points.shape
    r = params.shape[1]
    params, points, valid = params.contiguous(), points.contiguous(), valid.contiguous()
    idx = torch.empty((b, r, num_sampled), dtype=torch.int32, device=points.device)
    cnt = torch.empty((b, r), dtype=torch.int32, device=points.device)
    err = launch(_ptr(params), _ptr(points), _ptr(valid), _ptr(idx), _ptr(cnt),
                 b, r, n, num_sampled, _device_index(points), _stream(points))
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
