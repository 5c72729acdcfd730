"""Box algebra and rotated-rectangle IoU for the plain reference (frozen
copies of the port's ``ops/box_ops.py`` and ``ops/rotated_iou.py``, plain
PyTorch). Imports nothing of the port.
"""

from __future__ import annotations

import math

import torch

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap ``val`` into ``[-offset·period, (1 − offset)·period)``."""
    p = _const(period, val)
    return val - torch.floor(val / p + offset) * p


def rotate_points_2d(points, angle):
    """Rotate ``(…, N, 2)`` points by ``(…,)`` angles about the origin (+z CCW)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def box_corners_2d(boxes):
    """``(…, 5)`` ``[x, y, w, l, yaw]`` → ``(…, 4, 2)`` corners in CCW order
    (w along the local y axis, l along local x)."""
    x, y, w, l, yaw = boxes.unbind(-1)
    # Halving is exact, as a division or as a multiply by 0.5.
    lx = torch.stack([l, -l, -l, l], dim=-1) / 2.0
    wy = torch.stack([w, w, -w, -w], dim=-1) / 2.0
    rot = rotate_points_2d(torch.stack([lx, wy], dim=-1), yaw)
    return rot + torch.stack([x, y], dim=-1)[..., None, :]


def box_corners_3d(boxes):
    """``(…, 7)`` ``[x, y, z, w, l, h, yaw]`` → ``(…, 8, 3)`` corners: the
    bottom face (CCW) at ``z − h/2``, then the top face at ``z + h/2`` (``z``
    is the box centre)."""
    bev = torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], dim=-1)
    c2 = box_corners_2d(bev)  # (…, 4, 2)
    z, h = boxes[..., 2], boxes[..., 5]
    zb = (z - h / 2.0)[..., None, None].expand(*c2.shape[:-1], 1)
    zt = (z + h / 2.0)[..., None, None].expand(*c2.shape[:-1], 1)
    return torch.cat([torch.cat([c2, zb], dim=-1), torch.cat([c2, zt], dim=-1)], dim=-2)


def corners_to_standup_2d(corners):
    """``(…, 4, 2)`` corners → ``(…, 4)`` axis-aligned [xmin, ymin, xmax, ymax]."""
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def encode_boxes(boxes, anchors, encode_angle_to_vector: bool = False, smooth_dim: bool = False):
    """SECOND residual box encoding: centre deltas over the anchor's BEV
    diagonal (x, y) and height (z), dims as log ratios (ratio − 1 with
    ``smooth_dim``), the angle as a raw delta or a (cos, sin) vector delta.
    ``(…, 7)`` boxes and broadcastable anchors → ``(…, 7)`` or ``(…, 8)``."""
    xg, yg, zg, wg, lg, hg, rg = boxes.unbind(-1)
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    diag = torch.sqrt(wa * wa + la * la)
    xt, yt, zt = (xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha
    if smooth_dim:
        wt, lt, ht = wg / wa - 1.0, lg / la - 1.0, hg / ha - 1.0
    else:
        wt, lt, ht = torch.log(wg / wa), torch.log(lg / la), torch.log(hg / ha)
    if encode_angle_to_vector:
        angle = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
    else:
        angle = [rg - ra]
    return torch.stack([xt, yt, zt, wt, lt, ht, *angle], dim=-1)


def add_sin_difference(boxes1_rot, boxes2_rot):
    """Sin-error angle encoding of the localization loss: the pair
    ``(sin p · cos t, cos p · sin t)``, whose difference is ``sin(p − t)``."""
    return (torch.sin(boxes1_rot) * torch.cos(boxes2_rot),
            torch.cos(boxes1_rot) * torch.sin(boxes2_rot))


def decode_boxes(deltas, anchors, encode_angle_to_vector: bool = False, smooth_dim: bool = False):
    """SECOND residual decoding (inverse of the JAX ``encode_boxes``)."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    diag = torch.sqrt(wa * wa + la * la)
    xt, yt, zt, wt, lt, ht = (deltas[..., i] for i in range(6))
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        wg, lg, hg = (wt + 1.0) * wa, (lt + 1.0) * la, (ht + 1.0) * ha
    else:
        wg, lg, hg = torch.exp(wt) * wa, torch.exp(lt) * la, torch.exp(ht) * ha
    if encode_angle_to_vector:
        rg = torch.atan2(deltas[..., 7] + torch.sin(ra), deltas[..., 6] + torch.cos(ra))
    else:
        rg = deltas[..., 6] + ra
    return torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)


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
