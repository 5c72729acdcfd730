"""Offline augmented-scene generation over a KITTI-layout tree.

Capability of ``PointRCNN/tools/generate_aug_scene.py`` (325 LoC): write new
"aug scene" copies of each frame with GT-database objects copy-pasted into
the point cloud and appended to the labels, so later training epochs can
round-robin over pre-augmented variants.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from lyft3d_tpu_torch.data.augment import DataBaseSampler
from lyft3d_tpu_torch.data.kitti import (
    Calibration,
    Object3d,
    box_lidar_to_camera,
    read_label_file,
    write_label_file,
)

__all__ = ["generate_aug_scenes"]


def generate_aug_scenes(
    kitti_root,
    out_root,
    db_sampler: DataBaseSampler,
    copies: int = 1,
    classes: Sequence[str] = ("car",),
    seed: int = 0,
) -> Path:
    """Write ``copies`` augmented variants of every frame.

    Output stems are ``{orig}_{k}`` with velodyne/calib/label_2 mirrors;
    pasted objects get fresh label lines (occlusion 0, score-less).
    """
    from lyft3d_tpu_torch.data.kitti import box_camera_to_lidar

    src = Path(kitti_root)
    out = Path(out_root)
    for sub in ("velodyne", "calib", "label_2"):
        (out / sub).mkdir(parents=True, exist_ok=True)

    rng = np.random.RandomState(seed)
    stems = sorted(p.stem for p in (src / "velodyne").glob("*.bin"))
    for stem in stems:
        raw = np.fromfile(src / "velodyne" / f"{stem}.bin", np.float32).reshape(-1, 4)
        calib = Calibration.from_file(src / "calib" / f"{stem}.txt")
        objects = read_label_file(src / "label_2" / f"{stem}.txt")
        boxes, names = [], []
        for obj in objects:
            if obj.cls_type in classes:
                boxes.append(
                    box_camera_to_lidar(obj.pos, (obj.h, obj.w, obj.l), obj.ry, calib)
                )
                names.append(obj.cls_type)
        boxes_arr = np.stack(boxes) if boxes else np.zeros((0, 7))
        names_arr = np.asarray(names)

        for k in range(copies):
            new_stem = f"{stem}_{k}"
            pts = raw.copy()
            new_objects = list(objects)
            extra = db_sampler.sample_all(boxes_arr, names_arr)
            if extra is not None:
                paste = extra["points"].astype(np.float32)
                if paste.shape[1] < pts.shape[1]:
                    paste = np.concatenate(
                        [paste, np.zeros((len(paste), pts.shape[1] - paste.shape[1]),
                                         np.float32)], axis=1,
                    )
                pts = np.concatenate([pts, paste[:, : pts.shape[1]]])
                for b, name in zip(extra["boxes"], extra["names"]):
                    pos, ry = box_lidar_to_camera(np.asarray(b, np.float64), calib)
                    new_objects.append(
                        Object3d(
                            cls_type=str(name), truncation=0.0, occlusion=0,
                            alpha=0.0, box2d=np.array([0.0, 0.0, 50.0, 50.0]),
                            h=float(b[5]), w=float(b[3]), l=float(b[4]),
                            pos=pos, ry=ry,
                        )
                    )
            pts.astype(np.float32).tofile(out / "velodyne" / f"{new_stem}.bin")
            calib.to_file(out / "calib" / f"{new_stem}.txt")
            write_label_file(out / "label_2" / f"{new_stem}.txt", new_objects)
    return out
