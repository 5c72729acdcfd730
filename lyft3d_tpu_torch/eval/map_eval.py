"""Official Lyft competition metric: mean AP over IoU thresholds 0.5:0.05:0.95.

Capability match for the reference SDK evaluator
(``nuscenes-devkit/lyft_dataset_sdk/eval/detection/mAP_evaluation.py``:
``Box3D:50``, ``get_iou:185``, ``recall_precision:268``, ``get_ap:239``,
``get_average_precisions:331``) — but with the shapely polygon math replaced
by the vectorized numpy clipper (one batched IoU matrix per sample instead of
a python loop of polygon objects).

Input records are JSON-compatible dicts, the same schema the reference
consumes::

    {"sample_token": str,
     "translation": [x, y, z],          # box center, world frame
     "size": [w, l, h],
     "rotation": [qw, qx, qy, qz],
     "name": str,
     "score": float}                    # predictions only

IoU definition: ground-plane (bottom-face) polygon intersection × vertical
overlap, over the union volume.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from lyft3d_tpu_torch.core.quaternion import quaternion_yaw
from lyft3d_tpu_torch.eval.np_rotated_iou import iou_3d_np

__all__ = [
    "record_to_array",
    "group_by_sample_class",
    "recall_precision",
    "get_ap",
    "get_average_precisions",
    "get_class_names",
    "evaluate_map",
]


def record_to_array(rec: dict) -> np.ndarray:
    """Annotation dict → (7,) ``[x, y, z, w, l, h, yaw]``."""
    x, y, z = rec["translation"]
    w, l, h = rec["size"]
    yaw = quaternion_yaw(np.asarray(rec["rotation"], dtype=np.float64))
    return np.array([x, y, z, w, l, h, yaw], dtype=np.float64)


def group_by_sample_class(records: Iterable[dict]) -> Dict[Tuple[str, str], List[dict]]:
    out: Dict[Tuple[str, str], List[dict]] = defaultdict(list)
    for rec in records:
        out[(rec["sample_token"], rec["name"])].append(rec)
    return out


def get_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """Area under the precision-recall envelope (VOC-continuous style)."""
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    # Monotone non-increasing envelope from the right.
    precisions = np.maximum.accumulate(precisions[::-1])[::-1]
    idx = np.where(recalls[1:] != recalls[:-1])[0]
    return float(np.sum((recalls[idx + 1] - recalls[idx]) * precisions[idx + 1]))


def recall_precision(
    gt_by_sample: Dict[str, np.ndarray],
    pred_arrays: np.ndarray,
    pred_samples: Sequence[str],
    pred_scores: np.ndarray,
    iou_threshold: float,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Greedy score-ordered matching of one class at one IoU threshold.

    Args:
        gt_by_sample: sample_token → (G, 7) GT boxes of this class.
        pred_arrays: (P, 7) predicted boxes of this class (all samples).
        pred_samples: (P,) sample token per prediction.
        pred_scores: (P,) scores.

    Returns:
        (recalls, precisions, ap).
    """
    num_gt = int(sum(len(v) for v in gt_by_sample.values()))
    if num_gt == 0:
        return np.zeros(0), np.zeros(0), 0.0
    if len(pred_arrays) == 0:
        return np.zeros(0), np.zeros(0), 0.0

    # Precompute per-sample IoU matrices in one vectorized call each.
    iou_cache: Dict[str, np.ndarray] = {}
    pred_idx_in_sample: Dict[str, List[int]] = defaultdict(list)
    for i, tok in enumerate(pred_samples):
        pred_idx_in_sample[tok].append(i)
    local_rank = np.zeros(len(pred_arrays), dtype=np.int64)
    for tok, idxs in pred_idx_in_sample.items():
        if tok in gt_by_sample:
            iou_cache[tok] = iou_3d_np(pred_arrays[idxs], gt_by_sample[tok])
        for r, i in enumerate(idxs):
            local_rank[i] = r

    order = np.argsort(-pred_scores, kind="stable")
    matched: Dict[str, np.ndarray] = {
        tok: np.zeros(len(g), dtype=bool) for tok, g in gt_by_sample.items()
    }
    tp = np.zeros(len(order))
    fp = np.zeros(len(order))
    for rank, i in enumerate(order):
        tok = pred_samples[i]
        ious = iou_cache.get(tok)
        if ious is None or ious.shape[1] == 0:
            fp[rank] = 1
            continue
        row = ious[local_rank[i]].copy()
        row[matched[tok]] = -1.0
        j = int(np.argmax(row))
        if row[j] >= iou_threshold:
            matched[tok][j] = True
            tp[rank] = 1
        else:
            fp[rank] = 1

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recalls = tp_cum / num_gt
    precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    return recalls, precisions, get_ap(recalls, precisions)


def get_class_names(gt: Iterable[dict]) -> List[str]:
    return sorted({rec["name"] for rec in gt})


def get_average_precisions(
    gt: List[dict],
    predictions: List[dict],
    class_names: Sequence[str],
    iou_threshold: float,
) -> np.ndarray:
    """Per-class AP at one IoU threshold (mAP_evaluation.py:331 semantics:
    classes with no GT and no predictions score 0)."""
    gt_grouped = group_by_sample_class(gt)
    pred_grouped = group_by_sample_class(predictions)

    aps = np.zeros(len(class_names))
    for ci, cls in enumerate(class_names):
        gt_by_sample = {
            tok: np.stack([record_to_array(r) for r in recs])
            for (tok, name), recs in gt_grouped.items()
            if name == cls
        }
        preds: List[dict] = []
        for (tok, name), recs in pred_grouped.items():
            if name == cls:
                preds.extend(recs)
        if not gt_by_sample or not preds:
            aps[ci] = 0.0
            continue
        pred_arrays = np.stack([record_to_array(r) for r in preds])
        pred_samples = [r["sample_token"] for r in preds]
        pred_scores = np.array([r["score"] for r in preds])
        _, _, aps[ci] = recall_precision(
            gt_by_sample, pred_arrays, pred_samples, pred_scores, iou_threshold
        )
    return aps


def evaluate_map(
    gt: List[dict],
    predictions: List[dict],
    class_names: Sequence[str] = None,
    iou_thresholds: Sequence[float] = None,
    n_workers: int = 1,
) -> Tuple[float, Dict[str, Dict[float, float]]]:
    """Full Lyft metric: mean over classes and IoU ∈ {0.5, 0.55, …, 0.95}.

    ``n_workers > 1`` evaluates thresholds in parallel processes — the
    reference's per-threshold multiprocessing (``nusc_eval.py:44-109``, one
    Process per IoU threshold).

    Returns ``(overall_map, per_class)`` where ``per_class[name][thr] = AP``.
    """
    if class_names is None:
        class_names = get_class_names(gt)
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    iou_thresholds = [float(t) for t in iou_thresholds]

    if n_workers > 1:
        import multiprocessing

        with multiprocessing.Pool(min(n_workers, len(iou_thresholds))) as pool:
            all_aps = pool.starmap(
                get_average_precisions,
                [(gt, predictions, class_names, t) for t in iou_thresholds],
            )
    else:
        all_aps = [
            get_average_precisions(gt, predictions, class_names, t)
            for t in iou_thresholds
        ]

    per_class: Dict[str, Dict[float, float]] = {c: {} for c in class_names}
    for thr, aps in zip(iou_thresholds, all_aps):
        for c, ap in zip(class_names, aps):
            per_class[c][thr] = float(ap)
    overall = float(np.mean(np.stack(all_aps)))
    return overall, per_class
