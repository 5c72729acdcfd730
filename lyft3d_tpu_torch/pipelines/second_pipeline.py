"""SECOND pipeline, host side: Lyft DB → infos → (augmented) fixed-capacity
samples, and detections → world-frame records (copy of
``lyft3d_tpu/pipelines/second_pipeline.py``; numpy only).

- :func:`create_infos`: per-sample sensor-frame GT boxes and pose matrices;
- :class:`SecondSampleLoader`: multisweep load → fixed arrays;
  ``sample(train=True)`` under ``cfg.augment`` applies database sampling,
  per-object noise, global flip, rotation and scaling
  (:mod:`lyft3d_tpu_torch.data.augment`), in the original's draw order;
- :func:`detections_to_world_records`: sensor-frame detections → the records
  the mAP evaluator and the submission writer take.

Frame convention: boxes and points in the keyframe sensor frame with
standard yaw; evaluation happens in the world frame.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from lyft3d_tpu_torch.core.quaternion import quat_from_yaw
from lyft3d_tpu_torch.data.augment import (
    DataBaseSampler,
    global_rotation,
    global_scaling,
    noise_per_object,
    random_flip,
)
from lyft3d_tpu_torch.data.lyftdb import LyftDB
from lyft3d_tpu_torch.data.pointcloud import LidarPointCloud, load_multisweep

__all__ = ["create_infos", "save_infos", "load_infos", "LoaderConfig", "SecondSampleLoader",
           "detections_to_world_records"]


def create_infos(db: LyftDB, num_sweeps: int = 10, classes: Optional[Sequence[str]] = None):
    """Per-sample training infos: sensor-frame GT boxes + pose matrices."""
    infos = []
    for sample in db.sample:
        tok = sample["token"]
        sd_token = sample["data"]["LIDAR_TOP"]
        boxes = db.get_boxes_in_sensor_frame(sd_token)
        gt, names = [], []
        for b in boxes:
            if classes is not None and b.name not in classes:
                continue
            gt.append(b.as_xyzwlhr())
            names.append(b.name)
        infos.append(
            {
                "token": tok,
                "lidar_token": sd_token,
                "num_sweeps": num_sweeps,
                "gt_boxes": np.stack(gt) if gt else np.zeros((0, 7)),
                "gt_names": np.asarray(names),
                "car_from_sensor": db.sensor_pose_matrix(sd_token),
                "global_from_car": db.ego_pose_matrix(sd_token),
            }
        )
    return infos


def save_infos(infos, path):
    with open(path, "wb") as f:
        pickle.dump(infos, f)


def load_infos(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclass
class LoaderConfig:
    max_points: int = 65536
    max_gt: int = 64
    num_sweeps: int = 10
    augment: bool = True
    flip_prob: float = 0.5
    global_rot: tuple = (-0.3925, 0.3925)
    global_scale: tuple = (0.95, 1.05)
    per_object_noise: bool = True


class SecondSampleLoader:
    """Host-side sample assembly: multisweep load → fixed arrays. Device
    work (voxelize/model) happens elsewhere."""

    def __init__(
        self,
        db: LyftDB,
        infos: List[dict],
        class_names: Sequence[str],
        cfg: LoaderConfig = LoaderConfig(),
        db_sampler: Optional[DataBaseSampler] = None,
        seed: int = 0,
    ):
        self.db = db
        self.infos = {i["token"]: i for i in infos}
        self.class_names = list(class_names)
        self.cfg = cfg
        self.db_sampler = db_sampler
        self.rng = np.random.RandomState(seed)

    def load_points(self, info) -> np.ndarray:
        """(N, 4) [x, y, z, time_lag] in the keyframe sensor frame
        (the reference's ``[:, [0, 1, 2, 4]]`` feature pick,
        nuscenes_dataset.py:203-250)."""
        if self.cfg.num_sweeps > 1:
            pts, lags = load_multisweep(
                self.db, info["lidar_token"], num_sweeps=self.cfg.num_sweeps - 1
            )
        else:
            pc = LidarPointCloud.from_file(
                self.db.get_sample_data_path(info["lidar_token"])
            )
            pts, lags = pc.points, np.zeros(len(pc.points), np.float32)
        return np.column_stack([pts[:, :3], lags]).astype(np.float32)

    def sample(self, token: str, train: bool = True) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        info = self.infos[token]
        points = self.load_points(info)
        boxes = np.asarray(info["gt_boxes"], np.float64).reshape(-1, 7).copy()
        names = np.asarray(info["gt_names"]).copy()

        if train and cfg.augment:
            if self.db_sampler is not None:
                extra = self.db_sampler.sample_all(boxes, names)
                if extra is not None:
                    boxes = np.concatenate([boxes, extra["boxes"]])
                    names = np.concatenate([names, extra["names"]])
                    pasted = extra["points"]
                    pts4 = np.column_stack(
                        [pasted[:, :3], np.zeros(len(pasted), np.float32)]
                    )
                    points = np.concatenate([points, pts4.astype(np.float32)])
            if cfg.per_object_noise and len(boxes):
                points, boxes = noise_per_object(points, boxes, self.rng)
            points, boxes = random_flip(points, boxes, self.rng, cfg.flip_prob)
            points, boxes, _ = global_rotation(points, boxes, self.rng, cfg.global_rot)
            points, boxes, _ = global_scaling(points, boxes, self.rng, cfg.global_scale)

        # Fixed-capacity padding.
        out_pts = np.zeros((cfg.max_points, 4), np.float32)
        n = min(len(points), cfg.max_points)
        if n < len(points):
            keep = self.rng.choice(len(points), n, replace=False)
            points = points[keep]
        out_pts[:n] = points[:n]
        pts_valid = np.zeros(cfg.max_points, bool)
        pts_valid[:n] = True

        gt = np.zeros((cfg.max_gt, 7), np.float32)
        gt_cls = np.zeros(cfg.max_gt, np.int32)
        gt_valid = np.zeros(cfg.max_gt, bool)
        k = 0
        for b, name in zip(boxes, names):
            if name not in self.class_names or k >= cfg.max_gt:
                continue
            gt[k] = b
            gt_cls[k] = self.class_names.index(name) + 1
            gt_valid[k] = True
            k += 1
        return {
            "points": out_pts,
            "points_valid": pts_valid,
            "gt_boxes": gt,
            "gt_classes": gt_cls,
            "gt_valid": gt_valid,
            "token": token,
        }

    def batch(self, tokens: Sequence[str], train: bool = True) -> Dict[str, np.ndarray]:
        samples = [self.sample(t, train) for t in tokens]
        return {
            k: np.stack([s[k] for s in samples])
            for k in ("points", "points_valid", "gt_boxes", "gt_classes", "gt_valid")
        }


def detections_to_world_records(
    info, boxes, scores, classes, valid, class_names
) -> List[dict]:
    """Sensor-frame detections → world-frame mAP/submission records
    (_lidar_nusc_box_to_global capability)."""
    tm = info["global_from_car"] @ info["car_from_sensor"]
    yaw_world_offset = float(np.arctan2(tm[1, 0], tm[0, 0]))
    out = []
    for i in range(len(boxes)):
        if not valid[i]:
            continue
        b = np.asarray(boxes[i], np.float64)
        center = tm[:3, :3] @ b[:3] + tm[:3, 3]
        yaw = float(b[6]) + yaw_world_offset
        cls_idx = int(classes[i]) - 1
        if cls_idx < 0 or cls_idx >= len(class_names):
            continue
        out.append(
            {
                "sample_token": info["token"],
                "translation": center.tolist(),
                "size": [float(b[3]), float(b[4]), float(b[5])],
                "rotation": list(quat_from_yaw(yaw)),
                "yaw": yaw,
                "name": class_names[cls_idx],
                "score": float(scores[i]),
            }
        )
    return out
