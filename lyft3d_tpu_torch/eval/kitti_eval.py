"""KITTI-style 41-point / R40 interpolated AP over BEV and 3D IoU.

Capability of the reference's numba evaluators
(``second/second/utils/eval.py:479-818`` ``eval_class_v3`` /
``get_official_eval_result`` and the standalone copy
``PointRCNN/tools/kitti_object_eval_python/eval.py``): per-class AP at fixed
IoU thresholds, difficulty buckets (easy/moderate/hard), BEV and 3D IoU
variants — built on the vectorized rotated-IoU clipper instead of
numba-CUDA polygon kernels. AP is interpolated precision averaged over 41
(or 40, R40-style) recall sample points.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from lyft3d_tpu_torch.eval.np_rotated_iou import iou_3d_np, iou_bev_np

__all__ = ["kitti_ap", "evaluate_kitti", "recall_at"]


def _frame_iou(gt: np.ndarray, det: np.ndarray, metric: str) -> np.ndarray:
    if metric == "3d":
        return iou_3d_np(det, gt)
    if metric == "bev":
        return iou_bev_np(det[:, [0, 1, 3, 4, 6]], gt[:, [0, 1, 3, 4, 6]])
    raise ValueError(metric)


def _match_frames(
    gt_frames: Sequence[dict],
    det_frames: Sequence[dict],
    class_name: str,
    iou_threshold: float,
    metric: str,
    difficulty: Optional[int],
):
    """Greedy score-ordered matching across all frames.

    Frame dicts: gt {"boxes" (G,7), "names" (G,), "difficulty" (G,)};
    det {"boxes" (D,7), "names" (D,), "scores" (D,)}.

    GTs of the right class but harder than ``difficulty`` are IGNORED
    (matching them is neither TP nor FP — KITTI semantics).
    """
    scores, tp_flags, ignored_flags = [], [], []
    total_gt = 0
    for gt, det in zip(gt_frames, det_frames):
        g_names = np.asarray(gt["names"])
        g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 7)
        g_diff = np.asarray(gt.get("difficulty", np.zeros(len(g_boxes), np.int64)))
        is_class = g_names == class_name
        if difficulty is None:
            care = is_class
            ignore = np.zeros(len(g_boxes), bool)
        else:
            care = is_class & (g_diff <= difficulty) & (g_diff >= 0)
            ignore = is_class & ~care
        total_gt += int(care.sum())

        d_names = np.asarray(det["names"])
        d_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 7)
        d_scores = np.asarray(det["scores"], np.float64)
        dmask = d_names == class_name
        d_boxes, d_scores = d_boxes[dmask], d_scores[dmask]
        if len(d_boxes) == 0:
            continue
        if len(g_boxes) == 0:
            scores.extend(d_scores.tolist())
            tp_flags.extend([False] * len(d_scores))
            ignored_flags.extend([False] * len(d_scores))
            continue

        iou = _frame_iou(g_boxes, d_boxes, metric)  # (D, G)
        order = np.argsort(-d_scores, kind="stable")
        matched = np.zeros(len(g_boxes), bool)
        for di in order:
            row = iou[di].copy()
            row[matched] = -1.0
            row[~(care | ignore)] = -1.0
            gi = int(np.argmax(row)) if len(row) else -1
            ok = gi >= 0 and row[gi] >= iou_threshold
            scores.append(float(d_scores[di]))
            if ok and care[gi]:
                matched[gi] = True
                tp_flags.append(True)
                ignored_flags.append(False)
            elif ok and ignore[gi]:
                matched[gi] = True
                tp_flags.append(False)
                ignored_flags.append(True)  # neither TP nor FP
            else:
                tp_flags.append(False)
                ignored_flags.append(False)
    return (
        np.asarray(scores),
        np.asarray(tp_flags, bool),
        np.asarray(ignored_flags, bool),
        total_gt,
    )


def kitti_ap(
    gt_frames,
    det_frames,
    class_name: str,
    iou_threshold: float = 0.7,
    metric: str = "3d",
    difficulty: Optional[int] = None,
    n_points: int = 41,
) -> float:
    """Interpolated AP at ``n_points`` recall samples (41 = classic KITTI,
    40 with the first point dropped = R40)."""
    scores, tp, ignored, num_gt = _match_frames(
        gt_frames, det_frames, class_name, iou_threshold, metric, difficulty
    )
    if num_gt == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp, ignored = tp[order], ignored[order]
    keep = ~ignored
    tp = tp[keep]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recalls = tp_cum / num_gt
    precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)

    sample_points = np.linspace(0.0, 1.0, n_points)
    if n_points == 40:
        sample_points = np.linspace(1.0 / 40.0, 1.0, 40)
    ap = 0.0
    for r in sample_points:
        mask = recalls >= r - 1e-12
        ap += float(precisions[mask].max()) if mask.any() else 0.0
    return ap / len(sample_points)


def recall_at(gt_frames, det_frames, class_name, iou_threshold, metric="3d") -> float:
    """Plain recall at an IoU threshold (the recall stats PointRCNN's
    eval_rcnn.py:440-463 prints)."""
    _, tp, ignored, num_gt = _match_frames(
        gt_frames, det_frames, class_name, iou_threshold, metric, None
    )
    if num_gt == 0:
        return 0.0
    return float(tp.sum()) / num_gt


def evaluate_kitti(
    gt_frames,
    det_frames,
    classes: Sequence[str],
    iou_thresholds: Optional[Dict[str, float]] = None,
    difficulties: Sequence[int] = (0, 1, 2),
    metrics: Sequence[str] = ("bev", "3d"),
) -> Dict[str, Dict[str, List[float]]]:
    """Full table: result[class][metric] = [AP@difficulty...] —
    get_official_eval_result capability."""
    iou_thresholds = iou_thresholds or {}
    out: Dict[str, Dict[str, List[float]]] = {}
    for cls in classes:
        thr = iou_thresholds.get(cls, 0.7 if cls.lower() in ("car", "truck", "bus") else 0.5)
        out[cls] = {}
        for metric in metrics:
            out[cls][metric] = [
                kitti_ap(gt_frames, det_frames, cls, thr, metric, d)
                for d in difficulties
            ]
    return out
