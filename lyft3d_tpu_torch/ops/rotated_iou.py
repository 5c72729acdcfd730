"""Rotated-rectangle IoU by candidate-vertex intersection (port of
``lyft3d_tpu/ops/rotated_iou.py``).

The intersection of two convex quads is the convex hull of the 16
edge×edge crossings and of the corners of either quad inside the other.
Those 24 candidates are sorted by a diamond pseudo-angle around their
centroid (monotone in ``atan2``, no transcendentals) and integrated with
the shoelace formula, all as elementwise tensor math over any leading
shape. Pairwise functions take ``(N, 5)`` × ``(M, 5)`` or batched
``(B, N, 5)`` × ``(B, M, 5)`` BEV boxes ``[x, y, w, l, yaw]`` and work on
blocks of rows, so that the (B, rows, M, 24) candidates never exist for
all rows at once. ``rotated_iou_3d`` of the JAX package is not ported: no
path of the port calls it yet (PointRCNN inference needs the BEV IoU only).
"""

from __future__ import annotations

import torch

from lyft3d_tpu_torch.ops.box_ops import box_corners_2d

__all__ = [
    "polygon_intersection_area",
    "rotated_overlap_bev",
    "rotated_iou_bev",
    "standup_iou",
]

_EPS_IN = 1e-6  # boundary margin for corner containment (metre-scale boxes)
_EPS_DEN = 1e-12
# Pairs per block of rows in the pairwise functions.
_PAIRS_PER_BLOCK = 1 << 20


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


def rotated_overlap_bev(boxes1, boxes2):
    """``(…, N, M)`` BEV intersection areas of rotated boxes ``(…, N, 5)`` ×
    ``(…, M, 5)``."""
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


def rotated_iou_bev(boxes1, boxes2, criterion: int = -1):
    """``(…, N, M)`` BEV rotated IoU.

    ``criterion``: −1 → intersection / union; 0 → intersection / area1;
    1 → intersection / area2.
    """
    inter = rotated_overlap_bev(boxes1, boxes2)
    a1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    a2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    if criterion == 0:
        denom = a1 + torch.zeros_like(a2)
    elif criterion == 1:
        denom = a2 + torch.zeros_like(a1)
    else:
        denom = a1 + a2 - inter
    return inter / torch.clamp(denom, min=_EPS_DEN)


def standup_iou(boxes1, boxes2):
    """``(…, N, M)`` axis-aligned IoU of ``[xmin, ymin, xmax, ymax]`` boxes."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    a2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    return inter / torch.clamp(a1[..., :, None] + a2[..., None, :] - inter, min=_EPS_DEN)
