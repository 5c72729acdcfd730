"""Vectorized numpy rotated-rectangle intersection (host-side eval twin).

The official Lyft mAP metric scores tens of thousands of variable-count
box sets on the host; rather than padding everything onto the device we keep
a numpy twin of the Sutherland–Hodgman clipper in
``lyft3d_tpu_torch.ops.rotated_iou`` (tests assert the two agree). Replaces the
reference's shapely polygon intersection (``eval/detection/
mAP_evaluation.py:185`` ``get_iou``) and the numba ``rotate_iou_gpu_eval``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["box_corners_2d_np", "polygon_intersection_areas", "iou_3d_np", "iou_bev_np"]

_K = 8  # max vertices of a quad clipped by a quad


def box_corners_2d_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) ``[x, y, w, l, yaw]`` → (N, 4, 2) CCW corners."""
    boxes = np.asarray(boxes, dtype=np.float64)
    x, y, w, l, yaw = (boxes[:, i] for i in range(5))
    lx = np.stack([l, -l, -l, l], axis=-1) / 2.0
    wy = np.stack([w, w, -w, -w], axis=-1) / 2.0
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    cx = c * lx - s * wy + x[:, None]
    cy = s * lx + c * wy + y[:, None]
    return np.stack([cx, cy], axis=-1)


def _clip_halfplane(verts, count, a, b):
    """Batched convex-polygon clip by the half-plane left of edge a→b.

    verts: (B, K, 2); count: (B,); a, b: (B, 2).
    """
    bsz, k, _ = verts.shape
    d = b - a
    rel = verts - a[:, None, :]
    side = d[:, None, 0] * rel[:, :, 1] - d[:, None, 1] * rel[:, :, 0]  # (B, K)

    idx = np.broadcast_to(np.arange(k)[None, :], (bsz, k))
    nxt = np.where(idx >= count[:, None] - 1, 0, idx + 1)
    e = np.take_along_axis(verts, nxt[..., None], axis=1)
    e_side = np.take_along_axis(side, nxt, axis=1)
    valid = idx < count[:, None]

    s_in = side >= 0.0
    e_in = e_side >= 0.0
    denom = side - e_side
    t = side / np.where(np.abs(denom) < 1e-12, 1.0, denom)
    inter = verts + (e - verts) * t[..., None]

    cand = np.stack([inter, e], axis=2).reshape(bsz, 2 * k, 2)
    emit = np.stack([valid & (s_in != e_in), valid & e_in], axis=2).reshape(bsz, 2 * k)

    pos = np.cumsum(emit, axis=1) - 1
    out = np.zeros_like(verts)
    bi, ci = np.nonzero(emit)
    out[bi, pos[bi, ci]] = cand[bi, ci]
    return out, emit.sum(axis=1).astype(np.int64)


def _polygon_areas(verts, count):
    bsz, k, _ = verts.shape
    idx = np.broadcast_to(np.arange(k)[None, :], (bsz, k))
    nxt = np.where(idx >= count[:, None] - 1, 0, idx + 1)
    v2 = np.take_along_axis(verts, nxt[..., None], axis=1)
    cross = verts[:, :, 0] * v2[:, :, 1] - verts[:, :, 1] * v2[:, :, 0]
    return 0.5 * np.abs(np.where(idx < count[:, None], cross, 0.0).sum(axis=1))


def polygon_intersection_areas(corners1: np.ndarray, corners2: np.ndarray) -> np.ndarray:
    """Pairwise intersection areas: (N, 4, 2) × (M, 4, 2) → (N, M)."""
    n, m = len(corners1), len(corners2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    subj = np.broadcast_to(corners1[:, None], (n, m, 4, 2)).reshape(n * m, 4, 2)
    clip = np.broadcast_to(corners2[None, :], (n, m, 4, 2)).reshape(n * m, 4, 2)
    verts = np.zeros((n * m, _K, 2))
    verts[:, :4] = subj
    count = np.full(n * m, 4, dtype=np.int64)
    for i in range(4):
        verts, count = _clip_halfplane(verts, count, clip[:, i], clip[:, (i + 1) % 4])
    return _polygon_areas(verts, count).reshape(n, m)


def iou_bev_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 5) × (M, 5) ``[x,y,w,l,yaw]`` → (N, M) BEV IoU."""
    inter = polygon_intersection_areas(box_corners_2d_np(boxes1), box_corners_2d_np(boxes2))
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    return inter / np.maximum(a1 + a2 - inter, 1e-12)


def iou_3d_np(boxes1: np.ndarray, boxes2: np.ndarray, z_center: bool = True) -> np.ndarray:
    """(N, 7) × (M, 7) ``[x,y,z,w,l,h,yaw]`` → (N, M) 3D IoU.

    ``z_center=True`` means z is the box center (detector convention);
    ``False`` means z is the bottom face (the Lyft metric's Box3D uses
    center_z too — keep True for the official metric).
    """
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    bev1 = boxes1[:, [0, 1, 3, 4, 6]]
    bev2 = boxes2[:, [0, 1, 3, 4, 6]]
    inter_bev = polygon_intersection_areas(box_corners_2d_np(bev1), box_corners_2d_np(bev2))

    if z_center:
        zmin1, zmax1 = boxes1[:, 2] - boxes1[:, 5] / 2, boxes1[:, 2] + boxes1[:, 5] / 2
        zmin2, zmax2 = boxes2[:, 2] - boxes2[:, 5] / 2, boxes2[:, 2] + boxes2[:, 5] / 2
    else:
        zmin1, zmax1 = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
        zmin2, zmax2 = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    h_overlap = np.maximum(
        np.minimum(zmax1[:, None], zmax2[None, :]) - np.maximum(zmin1[:, None], zmin2[None, :]),
        0.0,
    )
    inter = inter_bev * h_overlap
    vol1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    vol2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    return inter / np.maximum(vol1 + vol2 - inter, 1e-12)
