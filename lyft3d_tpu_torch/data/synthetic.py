"""Synthetic Lyft-format dataset generator.

Writes a miniature but schema-complete Lyft dataset (13 JSON tables, lidar
``.bin`` sweeps, a map raster PNG) so that every pipeline stage — table DB,
multi-sweep loading, BEV rasterization, training, inference, the official
mAP metric — can be exercised end-to-end without the 100 GB competition
download. Lidar sweeps contain dense point clusters inside each GT box plus
uniform ground clutter, so detection pipelines have real signal to find.

(The reference has no equivalent; its tests rely on checked-in fixture JSONs.
A generator keeps fixtures out of git and lets tests choose their scale.)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from lyft3d_tpu_torch.core.quaternion import quat_from_yaw

DEFAULT_CLASSES = (
    "car",
    "pedestrian",
    "animal",
    "other_vehicle",
    "bus",
    "motorcycle",
    "truck",
    "emergency_vehicle",
    "bicycle",
)

# Rough real-world box dims per class (w, l, h) used for synthesis.
_CLASS_WLH = {
    "car": (1.93, 4.76, 1.72),
    "pedestrian": (0.77, 0.81, 1.78),
    "animal": (0.36, 0.73, 0.5),
    "other_vehicle": (2.79, 8.20, 3.23),
    "bus": (2.96, 12.34, 3.44),
    "motorcycle": (0.96, 2.35, 1.59),
    "truck": (2.84, 10.24, 3.44),
    "emergency_vehicle": (2.45, 6.52, 2.39),
    "bicycle": (0.63, 1.76, 1.44),
}


def _tok(prefix: str, i: int) -> str:
    return f"{prefix}_{i:06d}"


def make_synthetic_lyft(
    root,
    num_scenes: int = 2,
    samples_per_scene: int = 3,
    points_per_sweep: int = 4096,
    boxes_per_sample: int = 6,
    classes: Optional[List[str]] = None,
    seed: int = 0,
    map_size_px: int = 512,
    map_resolution: float = 0.5,
) -> Path:
    """Create the dataset under ``root``; returns the root path.

    Layout (same shape the SDK expects)::

        root/
          data/  *.json            (the 13 tables)
          lidar/ *.bin             (float32 x5 sweeps)
          maps/  map_raster.png
          train.csv                (sample_token index)
    """
    root = Path(root)
    (root / "data").mkdir(parents=True, exist_ok=True)
    (root / "lidar").mkdir(exist_ok=True)
    (root / "maps").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    classes = list(classes or DEFAULT_CLASSES)

    tables: Dict[str, List[dict]] = {name: [] for name in (
        "category", "attribute", "visibility", "instance", "sensor",
        "calibrated_sensor", "ego_pose", "log", "scene", "sample",
        "sample_data", "sample_annotation", "map",
    )}

    for i, name in enumerate(classes):
        tables["category"].append(
            {"token": _tok("cat", i), "name": name, "description": name}
        )
    cat_token = {c["name"]: c["token"] for c in tables["category"]}

    tables["sensor"].append(
        {"token": "sensor_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}
    )
    # Lidar mounted 1.8 m above the ego origin, no rotation.
    tables["calibrated_sensor"].append(
        {
            "token": "cs_lidar",
            "sensor_token": "sensor_lidar",
            "translation": [0.0, 0.0, 1.8],
            "rotation": [1.0, 0.0, 0.0, 0.0],
            "camera_intrinsic": [],
        }
    )
    # Forward camera (for image_2 KITTI export / projection paths): camera
    # frame z-forward = ego +x, x-right = ego −y, y-down = ego −z — the
    # standard nuScenes/Lyft camera convention, quaternion [.5,-.5,.5,-.5].
    tables["sensor"].append(
        {"token": "sensor_cam", "channel": "CAM_FRONT", "modality": "camera"}
    )
    cam_wh = (64, 48)
    tables["calibrated_sensor"].append(
        {
            "token": "cs_cam",
            "sensor_token": "sensor_cam",
            "translation": [1.5, 0.0, 1.5],
            "rotation": [0.5, -0.5, 0.5, -0.5],
            "camera_intrinsic": [
                [50.0, 0.0, cam_wh[0] / 2.0],
                [0.0, 50.0, cam_wh[1] / 2.0],
                [0.0, 0.0, 1.0],
            ],
        }
    )
    (root / "images").mkdir(exist_ok=True)

    # One shared map: a horizontal road band through the middle.
    map_img = np.zeros((map_size_px, map_size_px), dtype=np.uint8)
    band = slice(map_size_px // 2 - 40, map_size_px // 2 + 40)
    map_img[band, :] = 255
    from PIL import Image

    Image.fromarray(map_img).save(root / "maps" / "map_raster.png")
    tables["map"].append(
        {
            "token": "map_0",
            "filename": "maps/map_raster.png",
            "category": "semantic_prior",
            "log_tokens": [_tok("log", s) for s in range(num_scenes)],
        }
    )

    inst_counter = 0
    sd_counter = 0
    all_sample_tokens = []

    for s in range(num_scenes):
        log_token = _tok("log", s)
        tables["log"].append(
            {"token": log_token, "logfile": f"log{s}", "vehicle": "synth",
             "date_captured": "2026-08-16", "location": "synthetic"}
        )
        sample_tokens = [_tok(f"sample_s{s}", k) for k in range(samples_per_scene)]
        all_sample_tokens.extend(sample_tokens)
        tables["scene"].append(
            {
                "token": _tok("scene", s),
                "log_token": log_token,
                "nbr_samples": samples_per_scene,
                "first_sample_token": sample_tokens[0],
                "last_sample_token": sample_tokens[-1],
                "name": f"scene_{s:03d}",
                "description": "synthetic",
            }
        )

        # Persistent objects for this scene (tracked instances), placed on a
        # jittered grid so boxes never overlap (keeps oracle round-trip tests
        # exact; real data overlap behavior is exercised separately).
        scene_objs = []
        slot_cols = 4
        for b in range(boxes_per_sample):
            name = classes[rng.randint(len(classes))]
            w, l, h = _CLASS_WLH.get(name, (1.0, 2.0, 1.5))
            # 20 m x 14 m slots near the road band (map center ~y=128 m at
            # 0.5 m/px, 512 px → world 0..256).
            sx = 34.0 + 20.0 * (b % slot_cols) + rng.uniform(-2, 2)
            sy = 114.0 + 14.0 * (b // slot_cols) + rng.uniform(-2, 2)
            scene_objs.append(
                {
                    "instance_token": _tok("inst", inst_counter),
                    "name": name,
                    "wlh": (w, l, h),
                    "xy": np.array([sx, sy]),
                    "yaw": rng.uniform(-np.pi, np.pi),
                    "vel": rng.uniform(-1.5, 1.5, size=2),
                }
            )
            tables["instance"].append(
                {
                    "token": _tok("inst", inst_counter),
                    "category_token": cat_token[name],
                    "nbr_annotations": samples_per_scene,
                    "first_annotation_token": "",
                    "last_annotation_token": "",
                }
            )
            inst_counter += 1

        t0 = 1_500_000_000_000_000 + s * 10**9
        prev_sample = ""
        prev_sd = ""
        ann_tokens_by_inst: Dict[str, List[str]] = {o["instance_token"]: [] for o in scene_objs}

        for k, stoken in enumerate(sample_tokens):
            ts = t0 + k * 500_000  # 0.5 s apart (microseconds)
            dt = k * 0.5
            ego_xy = np.array([30.0 + 5.0 * k + 60.0 * s, 128.0])
            ego_yaw = 0.0

            pose_token = _tok(f"pose_s{s}", k)
            tables["ego_pose"].append(
                {
                    "token": pose_token,
                    "timestamp": ts,
                    "translation": [float(ego_xy[0]), float(ego_xy[1]), 0.0],
                    "rotation": list(map(float, quat_from_yaw(ego_yaw))),
                }
            )

            sd_token = _tok("sd", sd_counter)
            sd_counter += 1
            lidar_file = f"lidar/{sd_token}.bin"
            tables["sample_data"].append(
                {
                    "token": sd_token,
                    "sample_token": stoken,
                    "ego_pose_token": pose_token,
                    "calibrated_sensor_token": "cs_lidar",
                    "timestamp": ts,
                    "fileformat": "bin",
                    "is_key_frame": True,
                    "filename": lidar_file,
                    "prev": prev_sd,
                    "next": "",
                }
            )
            if prev_sd:
                tables["sample_data"][-2]["next"] = sd_token
            prev_sd = sd_token

            # Camera frame: a tiny gradient PNG per keyframe.
            cam_sd = _tok("sdcam", sd_counter)
            cam_file = f"images/{cam_sd}.png"
            grad = (
                np.linspace(0, 255, cam_wh[0], dtype=np.float32)[None, :]
                + rng.uniform(0, 32, (cam_wh[1], cam_wh[0]))
            ).clip(0, 255).astype(np.uint8)
            Image.fromarray(grad).save(root / cam_file)
            tables["sample_data"].append(
                {
                    "token": cam_sd,
                    "sample_token": stoken,
                    "ego_pose_token": pose_token,
                    "calibrated_sensor_token": "cs_cam",
                    "timestamp": ts,
                    "fileformat": "png",
                    "is_key_frame": True,
                    "filename": cam_file,
                    "prev": "",
                    "next": "",
                }
            )

            tables["sample"].append(
                {
                    "token": stoken,
                    "timestamp": ts,
                    "scene_token": _tok("scene", s),
                    "prev": prev_sample,
                    "next": "",
                }
            )
            if prev_sample:
                tables["sample"][-2]["next"] = stoken
            prev_sample = stoken

            # Annotations: objects drift at constant velocity.
            boxes_world = []
            for o in scene_objs:
                xy = o["xy"] + o["vel"] * dt
                w, l, h = o["wlh"]
                ann_token = _tok("ann", len(tables["sample_annotation"]))
                tables["sample_annotation"].append(
                    {
                        "token": ann_token,
                        "sample_token": stoken,
                        "instance_token": o["instance_token"],
                        "attribute_tokens": [],
                        "visibility_token": "",
                        "translation": [float(xy[0]), float(xy[1]), float(h / 2)],
                        "size": [float(w), float(l), float(h)],
                        "rotation": list(map(float, quat_from_yaw(o["yaw"]))),
                        "num_lidar_pts": 64,
                        "num_radar_pts": 0,
                        "prev": "",
                        "next": "",
                    }
                )
                ann_tokens_by_inst[o["instance_token"]].append(ann_token)
                boxes_world.append((xy, o["wlh"], o["yaw"]))

            _write_sweep(
                root / lidar_file,
                boxes_world,
                ego_xy,
                ego_yaw,
                sensor_z=1.8,
                n_points=points_per_sweep,
                rng=rng,
            )

        # Link annotation prev/next chains per instance.
        ann_by_token = {r["token"]: r for r in tables["sample_annotation"]}
        for toks in ann_tokens_by_inst.values():
            for i, t in enumerate(toks):
                ann_by_token[t]["prev"] = toks[i - 1] if i > 0 else ""
                ann_by_token[t]["next"] = toks[i + 1] if i < len(toks) - 1 else ""

    tables["attribute"] = []
    tables["visibility"] = []

    for name, recs in tables.items():
        with open(root / "data" / f"{name}.json", "w") as f:
            json.dump(recs, f)

    with open(root / "train.csv", "w") as f:
        f.write("Id,PredictionString\n")
        for tok in all_sample_tokens:
            f.write(f"{tok},\n")
    return root


def _write_sweep(path, boxes_world, ego_xy, ego_yaw, sensor_z, n_points, rng):
    """Write one float32-x5 lidar sweep: clutter + per-box clusters.

    Points are in the SENSOR frame (x forward, y left, z up, origin at the
    lidar). World → sensor: subtract ego, rotate by −yaw, subtract mount z.
    """
    n_bg = n_points // 2
    bg = np.empty((n_bg, 5), dtype=np.float32)
    bg[:, 0] = rng.uniform(-50, 50, n_bg)
    bg[:, 1] = rng.uniform(-50, 50, n_bg)
    bg[:, 2] = rng.uniform(-1.9, -1.5, n_bg)  # ground plane below sensor
    bg[:, 3] = rng.uniform(0, 100, n_bg)
    bg[:, 4] = rng.randint(0, 64, n_bg)

    per_box = (n_points - n_bg) // max(len(boxes_world), 1)
    clusters = []
    c, s = np.cos(-ego_yaw), np.sin(-ego_yaw)
    for xy, (w, l, h), yaw in boxes_world:
        pts = np.empty((per_box, 5), dtype=np.float32)
        local = rng.uniform(-0.5, 0.5, size=(per_box, 3)) * np.array([l, w, h])
        cy, sy = np.cos(yaw), np.sin(yaw)
        wx = cy * local[:, 0] - sy * local[:, 1] + xy[0]
        wy = sy * local[:, 0] + cy * local[:, 1] + xy[1]
        wz = local[:, 2] + h / 2
        # world → ego → sensor
        ex = c * (wx - ego_xy[0]) - s * (wy - ego_xy[1])
        ey = s * (wx - ego_xy[0]) + c * (wy - ego_xy[1])
        pts[:, 0] = ex
        pts[:, 1] = ey
        pts[:, 2] = wz - sensor_z
        pts[:, 3] = rng.uniform(0, 100, per_box)
        pts[:, 4] = rng.randint(0, 64, per_box)
        clusters.append(pts)

    sweep = np.concatenate([bg] + clusters, axis=0) if clusters else bg
    sweep.astype(np.float32).tofile(str(path))
