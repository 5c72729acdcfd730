"""Kaggle submission CSV IO + world-frame detection records.

Capability of the reference's CSV generation
(``unet-inference-with-map.py:730-757``): one row per sample,
``PredictionString`` = repeated ``score cx cy cz w l h yaw name`` in the
world frame; empty strings for samples with no detections. Also the inverse
parser (capability of ``data_transform/kaggle2nuscenes.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from lyft3d_tpu_torch.core.quaternion import quat_from_yaw

__all__ = ["detection_to_pred_string", "write_submission", "read_submission",
           "records_from_detections"]


def detection_to_pred_string(dets: List[dict]) -> str:
    """List of detection dicts → PredictionString."""
    parts = []
    for d in dets:
        x, y, z = d["translation"]
        w, l, h = d["size"]
        parts.append(
            f"{d['score']:.4f} {x:.4f} {y:.4f} {z:.4f} "
            f"{w:.4f} {l:.4f} {h:.4f} {d['yaw']:.4f} {d['name']}"
        )
    return " ".join(parts)


def write_submission(path, dets_by_sample: Dict[str, List[dict]], sample_tokens=None):
    """Write the Kaggle CSV; ``sample_tokens`` fixes row order/coverage."""
    tokens = list(sample_tokens) if sample_tokens is not None else sorted(dets_by_sample)
    with open(path, "w") as f:
        f.write("Id,PredictionString\n")
        for tok in tokens:
            f.write(f"{tok},{detection_to_pred_string(dets_by_sample.get(tok, []))}\n")
    return Path(path)


def read_submission(path) -> Dict[str, List[dict]]:
    """Parse a submission CSV back into detection dicts (kaggle2nuscenes)."""
    out: Dict[str, List[dict]] = {}
    with open(path) as f:
        header = f.readline()
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            tok, _, pred = line.partition(",")
            dets = []
            fields = pred.split()
            for i in range(0, len(fields) - 8, 9):
                score, x, y, z, w, l, h, yaw = map(float, fields[i : i + 8])
                dets.append(
                    {
                        "sample_token": tok,
                        "score": score,
                        "translation": [x, y, z],
                        "size": [w, l, h],
                        "yaw": yaw,
                        "rotation": list(quat_from_yaw(yaw)),
                        "name": fields[i + 8],
                    }
                )
            out[tok] = dets
    return out


def records_from_detections(dets_by_sample: Dict[str, List[dict]]) -> List[dict]:
    """Flatten per-sample detections into mAP-evaluator records."""
    recs = []
    for tok, dets in dets_by_sample.items():
        for d in dets:
            recs.append(
                {
                    "sample_token": tok,
                    "translation": list(d["translation"]),
                    "size": list(d["size"]),
                    "rotation": list(d.get("rotation", quat_from_yaw(d["yaw"]))),
                    "name": d["name"],
                    "score": float(d["score"]),
                }
            )
    return recs
