"""Rotated-rectangle IoU by candidate-vertex intersection (port of
``lyft3d_tpu/ops/rotated_iou.py``).

The intersection of two convex quads is the convex hull of the 16
edge×edge crossings and of the corners of either quad inside the other.
Those 24 candidates are sorted by a diamond pseudo-angle around their
centroid (monotone in ``atan2``, no transcendentals) and integrated with
the shoelace formula. Pairwise functions take ``(N, 5)`` × ``(M, 5)`` or
batched ``(B, N, 5)`` × ``(B, M, 5)`` BEV boxes ``[x, y, w, l, yaw]`` and
choose their path by the device of the boxes alone:

- CUDA tensor: one launch of the hand-written kernel ``csrc/rotated_iou.cu``
  (built by ``nvcc`` at first use) for the whole ``(B, N, M)``, or an error.
  There is no fallback. It skips, exactly, the pairs whose circumscribed
  circles lie apart (``_FAR_GAP``, ``_FAR_GAP_EDGE``).
- CPU tensor: the plain version, :func:`polygon_intersection_area` as
  elementwise tensor math over blocks of rows, so that the (B, rows, M, 24)
  candidates never exist for all rows at once.
- anything else: raises.

The 3D IoU (PointRCNN's training targets) multiplies the BEV overlap by the
vertical one: pairwise (:func:`rotated_iou_3d`) and row by row
(:func:`rotated_iou_3d_paired`, N pairs instead of an N × N matrix, always
the plain version).
"""

from __future__ import annotations

import ctypes

import torch

from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops.box_ops import box_corners_2d
from lyft3d_tpu_torch.utils.profiler import span

__all__ = [
    "polygon_intersection_area",
    "rotated_overlap_bev",
    "rotated_overlap_bev_plain",
    "rotated_iou_bev",
    "rotated_iou_bev_plain",
    "rotated_iou_3d",
    "rotated_iou_3d_paired",
    "standup_iou",
    "KERNEL_LAUNCHES",
]

# Number of times the pairwise functions launched the CUDA kernel in this process.
KERNEL_LAUNCHES = 0

_EPS_IN = 1e-6  # boundary margin for corner containment (metre-scale boxes)
_EPS_DEN = 1e-12
# Pairs per block of rows in the plain pairwise functions.
_PAIRS_PER_BLOCK = 1 << 20
# The kernel's early-out: it writes 0 without the polygon work where the
# centres lie farther apart than the sum of the half-diagonals plus _FAR_GAP
# (metres), so that no edge crosses another, and that gap times the shorter
# edge of the two boxes exceeds _FAR_GAP_EDGE (square metres), so that no
# corner passes the containment test (_EPS_IN on a cross product). The plain
# version is exactly 0 there.
_FAR_GAP = 1e-3
_FAR_GAP_EDGE = 1e-4


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _corners_inside(pts, a, d):
    """``(…, 4)`` bool: each of ``pts`` (…, 4, 2) inside the CCW quad with
    edge origins ``a`` (…, 4, 2) and edge vectors ``d`` (…, 4, 2)."""
    relx = pts[..., :, None, 0] - a[..., None, :, 0]
    rely = pts[..., :, None, 1] - a[..., None, :, 1]
    cr = d[..., None, :, 0] * rely - d[..., None, :, 1] * relx  # (…, 4 pts, 4 edges)
    return (cr >= -_EPS_IN).all(dim=-1)


def polygon_intersection_area(corners1, corners2):
    """Intersection area of convex quads given as ``(…, 4, 2)`` CCW corners
    (leading shapes broadcast)."""
    corners1, corners2 = torch.broadcast_tensors(corners1, corners2)
    a1, a2 = corners1, corners2
    r = torch.roll(corners1, -1, dims=-2) - corners1  # (…, 4, 2) edge vectors
    s = torch.roll(corners2, -1, dims=-2) - corners2

    # 16 segment×segment crossings: p = a1 + t·r, valid iff t, u ∈ [0, 1].
    qpx = a2[..., None, :, 0] - a1[..., :, None, 0]  # (…, 4, 4)
    qpy = a2[..., None, :, 1] - a1[..., :, None, 1]
    rx, ry = r[..., :, None, 0], r[..., :, None, 1]
    sx, sy = s[..., None, :, 0], s[..., None, :, 1]
    denom = _cross2(rx, ry, sx, sy)
    par = denom.abs() < _EPS_DEN
    safe = torch.where(par, torch.ones_like(denom), denom)
    t = _cross2(qpx, qpy, sx, sy) / safe
    u = _cross2(qpx, qpy, rx, ry) / safe
    hit = ~par & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    ix = a1[..., :, None, 0] + t * rx
    iy = a1[..., :, None, 1] + t * ry

    in1 = _corners_inside(corners1, a2, s)  # corners of 1 inside 2
    in2 = _corners_inside(corners2, a1, r)

    lead = ix.shape[:-2]
    px = torch.cat([ix.reshape(*lead, 16), corners1[..., 0], corners2[..., 0]], dim=-1)
    py = torch.cat([iy.reshape(*lead, 16), corners1[..., 1], corners2[..., 1]], dim=-1)
    ok = torch.cat([hit.reshape(*lead, 16), in1, in2], dim=-1)  # (…, 24)

    cnt = ok.sum(dim=-1, keepdim=True)
    okf = ok.to(px.dtype)
    inv_cnt = 1.0 / torch.clamp(cnt.to(px.dtype), min=1.0)
    cx = (px * okf).sum(dim=-1, keepdim=True) * inv_cnt
    cy = (py * okf).sum(dim=-1, keepdim=True) * inv_cnt

    # Diamond pseudo-angle; invalid candidates sort last.
    dx, dy = px - cx, py - cy
    den = dx.abs() + dy.abs()
    tt = dy / torch.where(den < _EPS_DEN, torch.ones_like(den), den)
    pa = torch.where(dx < 0, 2.0 - tt, torch.where(dy < 0, 4.0 + tt, tt))
    pa = torch.where(ok, pa, torch.full_like(pa, float("inf")))
    pa, order = torch.sort(pa, dim=-1, stable=True)
    sx_ = torch.gather(px, -1, order)
    sy_ = torch.gather(py, -1, order)
    sok = torch.gather(ok, -1, order)
    # Invalid tail slots collapse onto the first vertex: duplicates are
    # shoelace-neutral and close the ring.
    sx_ = torch.where(sok, sx_, sx_[..., :1])
    sy_ = torch.where(sok, sy_, sy_[..., :1])
    area = 0.5 * torch.abs(
        (sx_ * torch.roll(sy_, -1, dims=-1) - torch.roll(sx_, -1, dims=-1) * sy_).sum(dim=-1)
    )
    return torch.where(cnt[..., 0] >= 3, area, torch.zeros_like(area))


def _batched(boxes1, boxes2):
    """Both as (B, ·, 5), plus whether the inputs were unbatched."""
    single = boxes1.dim() == 2
    if single:
        boxes1, boxes2 = boxes1[None], boxes2[None]
    return boxes1, boxes2, single


def _check_device(boxes1, boxes2):
    kind = boxes1.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"the rotated IoU runs on cuda or cpu tensors, not {kind!r}")
    if boxes2.device != boxes1.device:
        raise ValueError(f"boxes on {boxes1.device} and {boxes2.device}")
    return kind == "cuda"


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # boxes1, boxes2, out
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch, n, m
    ctypes.c_int, ctypes.c_float, ctypes.c_float,  # mode, gap, gap_edge
    ctypes.c_int, ctypes.c_void_p,  # device, stream
]
# What the kernel writes: the bare intersection area, or its ratio for each
# criterion of rotated_iou_bev.
_MODES = {"overlap": 0, -1: 1, 0: 2, 1: 3}


def _kernel_library():
    fn = _build.load_library("rotated_iou").rotated_iou_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _pairwise_cuda(boxes1, boxes2, mode):
    """Launch ``csrc/rotated_iou.cu`` once on PyTorch's current stream:
    ``(…, N, M)`` intersection areas (``mode`` "overlap") or IoUs (``mode``
    a criterion of :func:`rotated_iou_bev`), in float32, cast to the boxes'
    dtype."""
    global KERNEL_LAUNCHES
    launch = _kernel_library()
    b1, b2, single = _batched(boxes1, boxes2)
    if b1.shape[-1] != 5 or b2.shape[-1] != 5 or b1.dim() != 3 or b2.dim() != 3:
        raise ValueError(f"boxes must be (N, 5) or (B, N, 5), got {tuple(boxes1.shape)} and "
                         f"{tuple(boxes2.shape)}")
    bsz = torch.broadcast_shapes(b1.shape[:1], b2.shape[:1])[0]
    b1 = b1.expand(bsz, -1, -1).float().contiguous()
    b2 = b2.expand(bsz, -1, -1).float().contiguous()
    n, m = b1.shape[1], b2.shape[1]
    out = torch.empty((bsz, n, m), dtype=torch.float32, device=b1.device)
    if out.numel():
        err = launch(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), bsz, n, m, _MODES[mode],
                     _FAR_GAP, _FAR_GAP_EDGE, b1.device.index,
                     torch.cuda.current_stream(b1.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rotated_iou kernel launch failed with CUDA error {err}")
        KERNEL_LAUNCHES += 1
    out = out.to(boxes1.dtype)
    return out[0] if single else out


def rotated_overlap_bev_plain(boxes1, boxes2):
    """Plain version of :func:`rotated_overlap_bev`, on any device:
    :func:`polygon_intersection_area` over blocks of rows."""
    b1, b2, single = _batched(boxes1, boxes2)
    bsz, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
    c1 = box_corners_2d(b1)  # (B, N, 4, 2)
    c2 = box_corners_2d(b2)[:, None]  # (B, 1, M, 4, 2)
    rows = max(1, _PAIRS_PER_BLOCK // max(bsz * m, 1))
    out = [
        polygon_intersection_area(c1[:, i : i + rows, None], c2)
        for i in range(0, n, rows)
    ]
    inter = torch.cat(out, dim=1) if out else c1.new_zeros((bsz, 0, m))
    return inter[0] if single else inter


def rotated_iou_bev_plain(boxes1, boxes2, criterion: int = -1):
    """Plain version of :func:`rotated_iou_bev`, on any device."""
    inter = rotated_overlap_bev_plain(boxes1, boxes2)
    a1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    a2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    if criterion == 0:
        denom = a1 + torch.zeros_like(a2)
    elif criterion == 1:
        denom = a2 + torch.zeros_like(a1)
    else:
        denom = a1 + a2 - inter
    return inter / torch.clamp(denom, min=_EPS_DEN)


def rotated_overlap_bev(boxes1, boxes2):
    """``(…, N, M)`` BEV intersection areas of rotated boxes ``(…, N, 5)`` ×
    ``(…, M, 5)``: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if _check_device(boxes1, boxes2):
        return _pairwise_cuda(boxes1, boxes2, "overlap")
    return rotated_overlap_bev_plain(boxes1, boxes2)


def rotated_iou_bev(boxes1, boxes2, criterion: int = -1):
    """``(…, N, M)`` BEV rotated IoU: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    ``criterion``: −1 → intersection / union; 0 → intersection / area1;
    1 → intersection / area2.
    """
    with span("rotated_iou"):
        if criterion not in (-1, 0, 1):
            raise ValueError(f"criterion must be -1, 0 or 1, got {criterion!r}")
        if _check_device(boxes1, boxes2):
            return _pairwise_cuda(boxes1, boxes2, criterion)
        return rotated_iou_bev_plain(boxes1, boxes2, criterion)


def _bev_of(boxes):
    """``(…, 7)`` ``[x, y, z, w, l, h, yaw]`` → ``(…, 5)`` ``[x, y, w, l, yaw]``."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], dim=-1)


def _iou_3d(inter_bev, boxes1, boxes2):
    """Volume IoU from the BEV overlap of boxes whose fields broadcast
    against it; z is the box centre."""
    zmax1, zmin1 = boxes1[..., 2] + boxes1[..., 5] / 2, boxes1[..., 2] - boxes1[..., 5] / 2
    zmax2, zmin2 = boxes2[..., 2] + boxes2[..., 5] / 2, boxes2[..., 2] - boxes2[..., 5] / 2
    h_overlap = torch.clamp(torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2), min=0.0)
    inter = inter_bev * h_overlap
    vol1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    vol2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return inter / torch.clamp(vol1 + vol2 - inter, min=_EPS_DEN)


def rotated_iou_3d(boxes1, boxes2):
    """``(…, N, M)`` 3D rotated IoU of ``(…, N, 7)`` × ``(…, M, 7)`` boxes
    ``[x, y, z, w, l, h, yaw]``: BEV overlap × vertical overlap over the
    volume union."""
    inter_bev = rotated_overlap_bev(_bev_of(boxes1), _bev_of(boxes2))
    return _iou_3d(inter_bev, boxes1[..., :, None, :], boxes2[..., None, :, :])


def rotated_iou_3d_paired(boxes1, boxes2):
    """``(…)`` 3D rotated IoU of each row of ``boxes1`` with the same row of
    ``boxes2`` (both ``(…, 7)``, broadcast)."""
    boxes1, boxes2 = torch.broadcast_tensors(boxes1, boxes2)
    inter_bev = polygon_intersection_area(box_corners_2d(_bev_of(boxes1)),
                                          box_corners_2d(_bev_of(boxes2)))
    return _iou_3d(inter_bev, boxes1, boxes2)


def standup_iou(boxes1, boxes2):
    """``(…, N, M)`` axis-aligned IoU of ``[xmin, ymin, xmax, ymax]`` boxes."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    a2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    return inter / torch.clamp(a1[..., :, None] + a2[..., None, :] - inter, min=_EPS_DEN)
