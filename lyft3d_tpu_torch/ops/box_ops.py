"""Box algebra on tensors (port of ``lyft3d_tpu/ops/box_ops.py``).

Boxes keep the JAX layout, a trailing dim of 7: ``[x, y, z, w, l, h, yaw]``
(BEV boxes: 5, ``[x, y, w, l, yaw]``). Any leading batch shape works.
Constants that divide are tensors on the input's device, so the division
is a true IEEE division on every device (PyTorch's CUDA division by a host
scalar multiplies by the reciprocal).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "limit_period",
    "rotate_points_2d",
    "box_corners_2d",
    "box_corners_3d",
    "corners_to_standup_2d",
    "encode_boxes",
    "decode_boxes",
    "add_sin_difference",
]


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
