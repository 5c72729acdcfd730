"""Anchor generation, anchor masking and target assignment (port of
``lyft3d_tpu/ops/anchors.py``).

Anchors are built with the JAX package's float32 operations in the same
order (``(arange + 0.5) · (x1 − x0) / nx + x0``), with every constant a
float32 tensor on the target device, so they are bit-equal to the JAX
anchors on any device.

The mask and assignment functions take one sample or a batch: ``(…, V, 3)``
coords, ``(…, G, 7)`` ground truth, with the anchors shared. A batch is
walked one sample at a time (the ``vmap`` of the JAX package), which bounds
the ``(A, G)`` similarity temporaries to one sample's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lyft3d_tpu_torch.ops.box_ops import box_corners_2d, corners_to_standup_2d, encode_boxes
from lyft3d_tpu_torch.ops.rotated_iou import rotated_iou_bev, standup_iou

__all__ = [
    "AnchorSpec",
    "create_anchors_3d_range",
    "generate_anchors",
    "bev_occupancy_mask",
    "anchors_area_mask",
    "assign_targets",
    "assign_targets_pruned",
    "tune_match_thresholds",
]


class AnchorSpec(NamedTuple):
    """One class's anchor config (the JAX package's ``AnchorSpec``)."""

    size: Tuple[float, float, float]  # (w, l, h)
    z_center: float
    matched_threshold: float
    unmatched_threshold: float
    rotations: Tuple[float, ...] = (0.0, 1.5707963267948966)
    class_id: int = 1  # 1-based


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def create_anchors_3d_range(
    feature_size: Tuple[int, int],
    point_range: Sequence[float],
    size: Tuple[float, float, float],
    z_center: float,
    rotations: Sequence[float] = (0.0, 1.5707963267948966),
    device=None,
):
    """(ny, nx) grid × rotations of one anchor size → ``(ny·nx·R, 7)`` float32."""
    ny, nx = feature_size
    x0, y0, x1, y1 = point_range[0], point_range[1], point_range[3], point_range[4]

    def centres(n, lo, hi):
        i = torch.arange(n, dtype=torch.float32, device=device)
        return (i + 0.5) * _f32(hi - lo, device) / _f32(n, device) + _f32(lo, device)

    gy, gx = torch.meshgrid(centres(ny, y0, y1), centres(nx, x0, x1), indexing="ij")
    rots = _f32(tuple(rotations), device)
    r = rots.shape[0]
    gx = gx[..., None].expand(ny, nx, r).reshape(-1)
    gy = gy[..., None].expand(ny, nx, r).reshape(-1)
    rot = rots.expand(ny, nx, r).reshape(-1)
    w, l, h = size
    cols = [gx, gy] + [torch.full_like(gx, float(v)) for v in (z_center, w, l, h)] + [rot]
    return torch.stack(cols, dim=-1)


def generate_anchors(
    feature_size: Tuple[int, int],
    point_range: Sequence[float],
    specs: Sequence[AnchorSpec],
    device=None,
):
    """All classes' anchors, position-major ``(ny, nx, spec, rotation)`` as
    the RPN heads flatten.

    Returns ``(anchors (A, 7), matched_thr (A,), unmatched_thr (A,),
    anchor_class (A,) int32)``.
    """
    ny, nx = feature_size
    per_spec, mt, ut, cls = [], [], [], []
    for spec in specs:
        r = len(spec.rotations)
        a = create_anchors_3d_range(
            feature_size, point_range, spec.size, spec.z_center, spec.rotations, device
        )
        per_spec.append(a.reshape(ny, nx, r, 7))
        mt += [spec.matched_threshold] * r
        ut += [spec.unmatched_threshold] * r
        cls += [spec.class_id] * r
    anchors = torch.stack(per_spec, dim=2).reshape(-1, 7)
    n_loc = ny * nx
    return (
        anchors,
        _f32(mt, device).repeat(n_loc),
        _f32(ut, device).repeat(n_loc),
        torch.tensor(cls, dtype=torch.int32, device=device).repeat(n_loc),
    )


def bev_occupancy_mask(coords, voxel_valid, grid_hw: Tuple[int, int]):
    """``(…, V, 3)`` voxel coords → ``(…, ny, nx)`` float32 0/1 occupancy."""
    ny, nx = grid_hw
    flat = torch.where(voxel_valid, coords[..., 1].long() * nx + coords[..., 0].long(), ny * nx)
    occ = torch.zeros((*flat.shape[:-1], ny * nx + 1), dtype=torch.float32, device=coords.device)
    occ.scatter_(-1, flat, 1.0)
    return occ[..., : ny * nx].unflatten(-1, (ny, nx))


def anchors_area_mask(anchors_bev_standup, occupancy, point_range, min_area: float = 1.0):
    """Occupied area under each anchor's standup box from an integral image.

    ``anchors_bev_standup`` ``(A, 4)`` ``[xmin, ymin, xmax, ymax]`` in world
    coordinates, ``occupancy`` ``(…, ny, nx)`` 0/1. Returns ``(…, A)`` bool:
    anchors over at least ``min_area`` occupied cells. The min corner floors
    and the max corner ceils, so a box smaller than a cell still covers one.
    """
    ny, nx = occupancy.shape[-2:]
    x0, y0, x1, y1 = point_range[0], point_range[1], point_range[3], point_range[4]
    integral = torch.nn.functional.pad(occupancy.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    dev = anchors_bev_standup.device

    def to_idx(vals, lo, hi, n, up):
        f = (vals - _f32(lo, dev)) / _f32(hi - lo, dev) * _f32(n, dev)
        return (torch.ceil(f) if up else torch.floor(f)).long().clamp(0, n)

    ix0 = to_idx(anchors_bev_standup[:, 0], x0, x1, nx, False)
    iy0 = to_idx(anchors_bev_standup[:, 1], y0, y1, ny, False)
    ix1 = to_idx(anchors_bev_standup[:, 2], x0, x1, nx, True)
    iy1 = to_idx(anchors_bev_standup[:, 3], y0, y1, ny, True)
    flat = integral.flatten(-2)
    w = nx + 1

    def at(iy, ix):
        return flat[..., iy * w + ix]

    area = at(iy1, ix1) - at(iy0, ix1) - at(iy1, ix0) + at(iy0, ix0)
    return area >= min_area


def _bev(boxes):
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], dim=-1)


def _assign_one(anchors, anchor_class, matched_thr, unmatched_thr, gt_boxes, gt_classes, gt_valid,
                anchor_mask, similarity, encode_angle_to_vector):
    a, g = anchors.shape[0], gt_boxes.shape[0]
    dev = anchors.device
    if similarity == "rotated":
        iou = rotated_iou_bev(_bev(anchors), _bev(gt_boxes))
    else:
        sa = corners_to_standup_2d(box_corners_2d(_bev(anchors)))
        sg = corners_to_standup_2d(box_corners_2d(_bev(gt_boxes)))
        iou = standup_iou(sa, sg)
    # Class-matched pairs only: an anchor of class c matches a GT of class c.
    pair_ok = (anchor_class[:, None] == gt_classes[None, :]) & gt_valid[None, :] & anchor_mask[:, None]
    iou = torch.where(pair_ok, iou, -1.0)
    del pair_ok

    best_iou, best_gt = iou.max(dim=1)  # ties: the first index, as jnp.argmax
    gt_best_iou, best_anchor_per_gt = iou.max(dim=0)
    del iou
    # Force-match: each valid GT claims its single best anchor. Where several
    # GTs claim one anchor, the highest GT index among the real claims wins.
    claims = gt_valid & (gt_best_iou > 0.0)
    gidx = torch.arange(g, device=dev)
    forced_gt = torch.full((a,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, best_anchor_per_gt, torch.where(claims, gidx, -1), "amax")
    force = forced_gt >= 0
    assigned_gt = torch.where(force, forced_gt, best_gt)

    pos = force | (best_iou >= matched_thr)
    neg = (best_iou < unmatched_thr) & ~pos
    labels = torch.where(pos, gt_classes[assigned_gt].to(torch.int32),
                         torch.where(neg, 0, -1).to(torch.int32))
    labels = torch.where(anchor_mask, labels, -1)

    matched_gt = gt_boxes[assigned_gt]
    bbox_targets = encode_boxes(matched_gt, anchors, encode_angle_to_vector)
    bbox_targets = torch.where(pos[:, None], bbox_targets, 0.0)
    # Direction target: the sign of (gt yaw − anchor yaw) over a period of 2π.
    pi = _f32(math.pi, dev)
    dir_targets = torch.remainder(torch.floor((matched_gt[:, 6] - anchors[:, 6]) / pi), 2.0)
    dir_targets = torch.where(pos, dir_targets.to(torch.int64), 0)
    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "reg_weights": pos.to(torch.float32),
        "dir_targets": dir_targets,
        "assigned_gt": assigned_gt,
        "max_iou": best_iou,
    }


def _per_sample(fn, batched_args, lead):
    """``fn`` over the flattened leading dims of ``batched_args``, stacked."""
    if not lead:
        return fn(*batched_args)
    flat = [x.reshape(-1, *x.shape[len(lead):]) for x in batched_args]
    outs = [fn(*(x[i] for x in flat)) for i in range(flat[0].shape[0])]
    return {k: torch.stack([o[k] for o in outs]).unflatten(0, lead) for k in outs[0]}


def assign_targets(anchors, anchor_class, matched_thr, unmatched_thr, gt_boxes, gt_classes, gt_valid,
                   anchor_mask=None, similarity: str = "nearest",
                   encode_angle_to_vector: bool = False):
    """Per-anchor argmax matching with positive/negative thresholds, the best
    anchor of each GT force-matched, class labels and encoded regression
    targets.

    ``anchors`` ``(A, 7)``, ``anchor_class``/``matched_thr``/``unmatched_thr``
    ``(A,)``; ``gt_boxes`` ``(…, G, 7)`` padded, ``gt_classes`` ``(…, G)``
    1-based, ``gt_valid`` ``(…, G)``; ``anchor_mask`` optional ``(…, A)`` bool,
    the anchors to consider at all. ``similarity``: "nearest" (standup IoU of
    the rotated corners) or "rotated".

    Returns a dict: labels ``(…, A)`` int32 (−1 don't-care, 0 background, > 0
    class), bbox_targets ``(…, A, 7 or 8)``, reg_weights ``(…, A)``,
    dir_targets ``(…, A)`` int64, assigned_gt, max_iou.
    """
    lead = tuple(gt_boxes.shape[:-2])
    if anchor_mask is None:
        anchor_mask = torch.ones((*lead, anchors.shape[0]), dtype=torch.bool, device=anchors.device)

    def one(g, c, v, m):
        return _assign_one(anchors, anchor_class, matched_thr, unmatched_thr, g, c, v, m,
                           similarity, encode_angle_to_vector)

    return _per_sample(one, (gt_boxes, gt_classes, gt_valid, anchor_mask), lead)


def _assign_pruned_one(anchors, anchor_class, matched_thr, unmatched_thr, gt_boxes, gt_classes,
                       gt_valid, anchor_mask, max_active, similarity, encode_angle_to_vector):
    a = anchors.shape[0]
    dev = anchors.device
    rank = torch.cumsum(anchor_mask, 0) - 1
    slot = torch.where(anchor_mask & (rank < max_active), rank, max_active)
    # One element longer and cut: slot max_active means "drop".
    sel = torch.zeros(max_active + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(a, device=dev))[:max_active]
    sel_valid = torch.arange(max_active, device=dev) < torch.clamp(anchor_mask.sum(), max=max_active)
    sub = _assign_one(anchors[sel], anchor_class[sel], matched_thr[sel], unmatched_thr[sel],
                      gt_boxes, gt_classes, gt_valid, sel_valid, similarity, encode_angle_to_vector)
    scatter_idx = torch.where(sel_valid, sel, a)

    def back(values, fill):
        out = values.new_full((a + 1, *values.shape[1:]), fill)
        idx = scatter_idx.reshape(-1, *([1] * (values.dim() - 1))).expand_as(values)
        return out.scatter_(0, idx, values)[:a]

    return {
        "labels": back(sub["labels"], -1),
        "bbox_targets": back(sub["bbox_targets"], 0.0),
        "reg_weights": back(sub["reg_weights"], 0.0),
        "dir_targets": back(sub["dir_targets"], 0),
    }


def assign_targets_pruned(anchors, anchor_class, matched_thr, unmatched_thr, gt_boxes, gt_classes,
                          gt_valid, anchor_mask, max_active: int = 4096, similarity: str = "rotated",
                          encode_angle_to_vector: bool = False):
    """:func:`assign_targets` restricted to at most ``max_active`` masked
    anchors, which makes the rotated similarity affordable at the full grid:
    the anchor mask selects candidates (cumsum compaction, fixed capacity),
    assignment runs on the subset and the results scatter back; every other
    anchor is don't-care (−1)."""
    lead = tuple(gt_boxes.shape[:-2])

    def one(g, c, v, m):
        return _assign_pruned_one(anchors, anchor_class, matched_thr, unmatched_thr, g, c, v, m,
                                  max_active, similarity, encode_angle_to_vector)

    return _per_sample(one, (gt_boxes, gt_classes, gt_valid, anchor_mask), lead)


def tune_match_thresholds(anchors, anchor_class, gt_samples, class_ids,
                          candidate_thresholds=(0.3, 0.35, 0.4, 0.45, 0.5, 0.55, 0.6),
                          target_rate: float = 1.0, similarity: str = "nearest"):
    """Per-class matched thresholds from the anchors-per-GT rate: sweep the
    candidates over sample GT sets (a list of ``(gt_boxes (G, 7), gt_classes
    (G,))`` numpy pairs) and keep, per class, the highest threshold whose
    mean matched-anchor count per GT is at least ``target_rate``. Returns
    ``{class_id: threshold}``."""
    abev = _bev(anchors)
    sa = corners_to_standup_2d(box_corners_2d(abev))
    acls = anchor_class.cpu().numpy()
    rates = {cid: {t: [] for t in candidate_thresholds} for cid in class_ids}
    for gt_boxes, gt_classes in gt_samples:
        if len(gt_boxes) == 0:
            continue
        gbev = _bev(torch.as_tensor(np.asarray(gt_boxes), dtype=torch.float32, device=anchors.device))
        if similarity == "rotated":
            iou = rotated_iou_bev(abev, gbev).cpu().numpy()
        else:
            iou = standup_iou(sa, corners_to_standup_2d(box_corners_2d(gbev))).cpu().numpy()
        for cid in class_ids:
            cols = np.flatnonzero(np.asarray(gt_classes) == cid)
            if len(cols) == 0:
                continue
            sub = iou[acls == cid][:, cols]
            for t in candidate_thresholds:
                rates[cid][t].append((sub >= t).sum(axis=0).mean())
    out = {}
    for cid in class_ids:
        best = candidate_thresholds[0]
        for t in candidate_thresholds:
            vals = rates[cid][t]
            if vals and float(np.mean(vals)) >= target_rate:
                best = t
        out[cid] = float(best)
    return out
