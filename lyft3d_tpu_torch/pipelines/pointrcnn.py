"""PointRCNN inference and evaluation over a KITTI-layout dataset (port of
the inference half of ``lyft3d_tpu/pipelines/pointrcnn_train.py``).

The device program is :func:`make_pointrcnn_infer_fn`: the joint net →
refined boxes → ``sigmoid`` of the RCNN class logit, masked by proposal
validity and empty RoIs → final rotated NMS, on a batch. The host side is
:class:`KittiPointRCNNLoader` (lidar load, range filter, near/far-aware
fixed-count subsampling, and for training the database sampler's pasted
objects and the scene augmentation) and :func:`eval_pointrcnn` (KITTI label
files, frames for the AP evaluator, recall by IoU threshold). Training is
in :mod:`lyft3d_tpu_torch.pipelines.pointrcnn_train`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from lyft3d_tpu_torch.data.augment import global_rotation, global_scaling, random_flip
from lyft3d_tpu_torch.data.kitti import (
    Calibration,
    Object3d,
    box_camera_to_lidar,
    box_lidar_to_camera,
    read_label_file,
    write_label_file,
)
from lyft3d_tpu_torch.eval.kitti_eval import recall_at
from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNN, PointRCNNConfig
from lyft3d_tpu_torch.ops.nms import rotated_nms

__all__ = ["make_pointrcnn_infer_fn", "KittiLoaderConfig", "KittiPointRCNNLoader",
           "eval_pointrcnn"]


def make_pointrcnn_infer_fn(model: PointRCNN, cfg: PointRCNNConfig) -> Callable:
    """Batched points → detections program on the model's device.

    ``infer(points (B, N, 3), valid (B, N))`` → ``(boxes (B, P, 7), scores
    (B, P))``: the refined boxes of all ``P = cfg.num_proposals`` proposals
    and their scores, 0 where a proposal is invalid, its RoI empty, or the
    final NMS suppressed it. The model is put in eval mode.
    """
    model.eval()

    @torch.inference_mode()
    def infer(points, valid):
        out = model(points, None, valid)
        refined = out["refined"]
        ok = out["proposals"]["roi_valid"] & ~out["roi_empty"]
        score = torch.where(ok, torch.sigmoid(out["rcnn"]["cls"]), 0.0)
        bev = torch.cat([refined[..., 0:2], refined[..., 3:5], refined[..., 6:7]], dim=-1)
        keep = rotated_nms(bev, score, cfg.final_nms_iou, valid=ok)
        return refined, torch.where(keep, score, 0.0)

    return infer


@dataclass
class KittiLoaderConfig:
    num_points: int = 16384
    near_radius: float = 40.0
    classes: tuple = ("car",)
    range_xyz: tuple = (80.0, 80.0, 5.0)
    max_gt: int = 32
    # Scene-level augmentation (training): flip, rotation, scaling.
    augment: bool = False
    aug_rot_range: float = float(np.pi / 4)
    aug_scale_range: tuple = (0.95, 1.05)


class KittiPointRCNNLoader:
    """KITTI tree (velodyne/, calib/, label_2/) → fixed-size arrays.

    An optional ``db_sampler`` (:class:`~lyft3d_tpu_torch.data.augment.DataBaseSampler`)
    pastes sampled objects into the subsampled cloud; ``cfg.augment`` flips,
    rotates and scales the scene. Both draw from the loader's seeded
    generator in the JAX loader's order, so the two give equal arrays.
    """

    def __init__(self, root, cfg: KittiLoaderConfig = KittiLoaderConfig(), seed: int = 0,
                 db_sampler=None):
        self.root = Path(root)
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.db_sampler = db_sampler
        self.stems = sorted(p.stem for p in (self.root / "velodyne").glob("*.bin"))

    def subsample(self, pts: np.ndarray):
        """Near/far-stratified fixed-count subsampling: keep all far points,
        fill the quota with random near points. Returns the ``(num_points,
        D)`` array (zero-padded when short) and the count of real points."""
        n = self.cfg.num_points
        if len(pts) <= n:
            pad = np.zeros((n - len(pts), pts.shape[1]), pts.dtype)
            return np.concatenate([pts, pad]), len(pts)
        dist = np.linalg.norm(pts[:, :2], axis=1)
        far = dist >= self.cfg.near_radius
        far_idx = np.flatnonzero(far)
        near_idx = np.flatnonzero(~far)
        if len(far_idx) >= n:
            pick = self.rng.choice(far_idx, n, replace=False)
        else:
            extra = self.rng.choice(near_idx, n - len(far_idx), replace=False)
            pick = np.concatenate([far_idx, extra])
        return pts[pick], n

    def sample(self, stem: str) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        raw = np.fromfile(self.root / "velodyne" / f"{stem}.bin", np.float32).reshape(-1, 4)
        rx, ry, rz = cfg.range_xyz
        keep = (np.abs(raw[:, 0]) < rx) & (np.abs(raw[:, 1]) < ry) & (np.abs(raw[:, 2]) < rz)
        pts, count = self.subsample(raw[keep])
        valid = np.zeros(cfg.num_points, bool)
        valid[:count] = True

        calib = Calibration.from_file(self.root / "calib" / f"{stem}.txt")
        objects = [o for o in read_label_file(self.root / "label_2" / f"{stem}.txt")
                   if o.cls_type in cfg.classes]
        boxes = [box_camera_to_lidar(o.pos, (o.h, o.w, o.l), o.ry, calib) for o in objects]
        if self.db_sampler is not None or cfg.augment:
            pts, boxes = self._augment(pts, np.stack(boxes) if boxes else np.zeros((0, 7)),
                                       np.asarray([o.cls_type for o in objects]))
        gt = np.zeros((cfg.max_gt, 7), np.float32)
        gt_valid = np.zeros(cfg.max_gt, bool)
        for k, box in enumerate(boxes[: cfg.max_gt]):
            gt[k] = box
            gt_valid[k] = True
        return {
            "points": pts[:, :3].astype(np.float32),
            "points_valid": valid,
            "gt_boxes": gt,
            "gt_valid": gt_valid,
            "stem": stem,
        }

    def _augment(self, pts: np.ndarray, boxes: np.ndarray, names: np.ndarray):
        """Training augmentation of one scene: the sampler's objects pasted
        into random slots of the subsampled ``pts`` (a quarter of the buffer
        at most), then flip, rotation and scaling of points and boxes.
        Returns the points and boxes."""
        cfg = self.cfg
        if self.db_sampler is not None:
            extra = self.db_sampler.sample_all(boxes, names)
            if extra is not None:
                boxes = np.concatenate([boxes, extra["boxes"]])
                paste = extra["points"][:, :3].astype(np.float32)
                n_paste = min(len(paste), pts.shape[0] // 4)
                if n_paste:
                    slots = self.rng.choice(pts.shape[0], n_paste, replace=False)
                    pts[slots, :3] = paste[:n_paste]
                    pts[slots, 3:] = 0.0
        if cfg.augment:
            boxes = boxes.astype(np.float32)
            pts, boxes = random_flip(pts, boxes, self.rng)
            pts, boxes, _ = global_rotation(pts, boxes, self.rng,
                                            rotation=(-cfg.aug_rot_range, cfg.aug_rot_range))
            pts, boxes, _ = global_scaling(pts, boxes, self.rng, scale=cfg.aug_scale_range)
        return pts, boxes

    def batch(self, stems: Sequence[str]) -> Dict[str, np.ndarray]:
        ss = [self.sample(s) for s in stems]
        return {
            k: np.stack([s[k] for s in ss])
            for k in ("points", "points_valid", "gt_boxes", "gt_valid")
        }


def eval_pointrcnn(
    model: PointRCNN,
    loader: KittiPointRCNNLoader,
    cfg: PointRCNNConfig,
    out_dir: Optional[str] = None,
    class_name: str = "car",
    recall_thresholds: Sequence[float] = (0.1, 0.3, 0.5, 0.7),
    verbose: bool = False,
):
    """Joint eval, one frame at a time: refined boxes scored by the RCNN
    head, final rotated NMS → KITTI label files (with ``out_dir``) and frames
    for the AP evaluator, with recall by IoU threshold. Returns
    ``(gt_frames, det_frames, stats)``. The weights are the model's own (the
    JAX package passes them beside the model)."""
    infer = make_pointrcnn_infer_fn(model, cfg)
    device = next(model.parameters()).device
    gt_frames, det_frames = [], []
    for stem in loader.stems:
        s = loader.sample(stem)
        boxes, scores = infer(torch.from_numpy(s["points"][None]).to(device),
                              torch.from_numpy(s["points_valid"][None]).to(device))
        boxes, scores = boxes[0].cpu().numpy(), scores[0].cpu().numpy()
        det_frames.append({
            "boxes": boxes,
            "names": np.asarray([class_name] * len(boxes)),
            "scores": scores,
        })
        g = s["gt_boxes"][s["gt_valid"]]
        gt_frames.append({
            "boxes": g,
            "names": np.asarray([class_name] * len(g)),
            "difficulty": np.zeros(len(g), np.int64),
        })
        if out_dir is not None:
            calib = Calibration.from_file(loader.root / "calib" / f"{stem}.txt")
            objs = []
            for box, score in zip(boxes, scores):
                if score <= 0.01:
                    continue
                pos, ry = box_lidar_to_camera(np.asarray(box, np.float64), calib)
                objs.append(Object3d(
                    cls_type=class_name.capitalize(), truncation=0.0, occlusion=0,
                    alpha=0.0, box2d=np.array([0.0, 0.0, 50.0, 50.0]),
                    h=float(box[5]), w=float(box[3]), l=float(box[4]),
                    pos=pos, ry=ry, score=float(score),
                ))
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            write_label_file(Path(out_dir) / f"{stem}.txt", objs)

    stats = {
        f"recall@{t}": round(recall_at(gt_frames, det_frames, class_name, t), 4)
        for t in recall_thresholds
    }
    stats["num_frames"] = len(gt_frames)
    stats["num_gt"] = int(sum(len(g["boxes"]) for g in gt_frames))
    if verbose:
        print(f"eval {class_name}: {stats}")
    return gt_frames, det_frames, stats
