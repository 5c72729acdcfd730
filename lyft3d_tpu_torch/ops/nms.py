"""Greedy NMS on tensors (port of ``lyft3d_tpu/ops/nms.py``).

The pairwise IoU matrix is computed once; the greedy pass iterates the
suppression recurrence to its fixpoint with whole-matrix steps. Inputs are
padded and fixed-size, ``(N, …)`` or batched ``(B, N, …)``; invalid rows are
masked with ``valid``. Orders follow ``jnp.argsort`` (stable) and
``jax.lax.top_k`` (ties to the lower index): both become stable sorts.
``standup_nms`` has no caller on a ported path (nor in the JAX package: only
its tests call it).
"""

from __future__ import annotations

import torch

from lyft3d_tpu_torch.ops.box_ops import box_corners_2d, corners_to_standup_2d
from lyft3d_tpu_torch.ops.rotated_iou import rotated_iou_bev, standup_iou
from lyft3d_tpu_torch.utils.profiler import span

__all__ = ["nms_mask_from_iou", "rotated_nms", "standup_nms", "select_top_k"]


def _greedy_keep_sorted(iou_s, valid_s, iou_threshold):
    """Exact greedy NMS over ``(B, N, N)`` IoUs of boxes already in
    descending-score order.

    Iterates ``keep_i = valid_i and not any_{j<i}(keep_j and IoU(j, i) > thr)``
    to its fixpoint. Greedy is the unique solution of this recurrence, so the
    fixpoint is exact; it takes 1 + the longest suppression chain steps,
    bounded by N. Samples that settle early stay at their fixpoint while the
    others iterate.
    """
    with span("nms"):
        n = valid_s.shape[-1]
        rank = torch.arange(n, device=valid_s.device)
        m = (iou_s > iou_threshold) & (rank[:, None] < rank[None, :])
        keep = valid_s
        for _ in range(n):
            with span("nms.step"):
                sup = (keep[..., :, None] & m).any(dim=-2)
                new = valid_s & ~sup
                if torch.equal(new, keep):
                    break
            keep = new
        return keep


def _descending_order(scores, valid):
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    return torch.sort(masked, dim=-1, descending=True, stable=True).indices


def _unsort(keep_sorted, order):
    return torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)


def nms_mask_from_iou(iou, scores, iou_threshold, valid=None, presorted=False):
    """Greedy NMS keep-mask from a precomputed ``(…, N, N)`` IoU matrix.

    ``presorted``: rows are already in descending-score order. Returns the
    ``(…, N)`` bool mask in the original order.
    """
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    if presorted:
        return _greedy_keep_sorted(iou, valid, iou_threshold)
    order = _descending_order(scores, valid)
    iou_s = torch.gather(iou, -2, order[..., :, None].expand(iou.shape))
    iou_s = torch.gather(iou_s, -1, order[..., None, :].expand(iou.shape))
    keep = _greedy_keep_sorted(iou_s, torch.gather(valid, -1, order), iou_threshold)
    return _unsort(keep, order)


def rotated_nms(boxes_bev, scores, iou_threshold, valid=None):
    """Rotated NMS on ``(…, N, 5)`` ``[x, y, w, l, yaw]`` boxes → ``(…, N)``
    keep mask. Boxes are sorted by score before the pairwise IoU."""
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    order = _descending_order(scores, valid)
    boxes_s = torch.gather(boxes_bev, -2, order[..., None].expand(boxes_bev.shape))
    iou_s = rotated_iou_bev(boxes_s, boxes_s)
    keep = _greedy_keep_sorted(iou_s, torch.gather(valid, -1, order), iou_threshold)
    return _unsort(keep, order)


def standup_nms(boxes_bev, scores, iou_threshold, valid=None):
    """Axis-aligned NMS on ``(…, N, 5)`` rotated boxes through their standup
    extents → ``(…, N)`` keep mask (SECOND's NMS with
    ``use_rotate_nms=False``)."""
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    order = _descending_order(scores, valid)
    boxes_s = torch.gather(boxes_bev, -2, order[..., None].expand(boxes_bev.shape))
    standup = corners_to_standup_2d(box_corners_2d(boxes_s))
    keep = _greedy_keep_sorted(standup_iou(standup, standup), torch.gather(valid, -1, order),
                               iou_threshold)
    return _unsort(keep, order)


def select_top_k(keep_mask, scores, k):
    """Compact a keep mask to at most ``k`` score-sorted indices.

    Returns ``(idx, sel_valid)``: ``(…, k)`` int64 indices into the original
    arrays and a bool mask of the real selections (ties, including the
    ``-inf`` padding, go to the lower index as in ``jax.lax.top_k``).
    """
    masked = torch.where(keep_mask, scores, torch.full_like(scores, float("-inf")))
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], top[..., :k] > float("-inf")
