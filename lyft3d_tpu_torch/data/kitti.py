"""KITTI-format interop: calibration math, label IO, Lyft→KITTI export.

Capability of the reference's KITTI layer:
- ``Calibration`` P2/R0/Tr_velo_to_cam algebra
  (``PointRCNN/lib/utils/calibration.py:24-140``);
- ``Object3d`` label-line parsing with difficulty levels
  (``PointRCNN/lib/utils/object3d.py:10-102``);
- ``KittiDB`` accessors + ``box_nuscenes_to_kitti``
  (``nuscenes-devkit/lyft_dataset_sdk/utils/kitti.py:18-76``);
- the Lyft→KITTI exporter (``nuscenes-devkit/export_kitti.py:56-249``):
  velodyne ``.bin`` rotated into the KITTI lidar frame, ``calib/*.txt`` with
  Tr_velo_to_cam, ``label_2/*.txt``.

KITTI frames: camera x-right / y-down / z-forward; lidar (velodyne)
x-forward / y-left / z-up. Lyft's lidar frame is x-forward/y-left/z-up
already, so the exporter's velo→cam transform is the fixed axis swap
composed with the sensor extrinsics.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Calibration", "Object3d", "read_label_file", "write_label_file",
           "box_lidar_to_camera", "box_camera_to_lidar", "export_kitti"]

# Fixed velo→cam axis swap: x_cam = −y_velo, y_cam = −z_velo, z_cam = x_velo.
VELO_TO_CAM = np.array(
    [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
)


@dataclass
class Calibration:
    """P2 (3x4), R0_rect (3x3), Tr_velo_to_cam (3x4)."""

    p2: np.ndarray
    r0: np.ndarray
    tr_velo_to_cam: np.ndarray

    @classmethod
    def from_file(cls, path) -> "Calibration":
        vals: Dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, _, rest = line.partition(":")
                vals[key.strip()] = np.array([float(x) for x in rest.split()])
        return cls(
            p2=vals["P2"].reshape(3, 4),
            r0=vals["R0_rect"].reshape(3, 3),
            tr_velo_to_cam=vals["Tr_velo_to_cam"].reshape(3, 4),
        )

    def to_file(self, path) -> None:
        zeros34 = " ".join(["0"] * 12)
        with open(path, "w") as f:
            for key in ("P0", "P1"):
                f.write(f"{key}: {zeros34}\n")
            f.write("P2: " + " ".join(f"{v:.12e}" for v in self.p2.reshape(-1)) + "\n")
            f.write(f"P3: {zeros34}\n")
            f.write(
                "R0_rect: " + " ".join(f"{v:.12e}" for v in self.r0.reshape(-1)) + "\n"
            )
            f.write(
                "Tr_velo_to_cam: "
                + " ".join(f"{v:.12e}" for v in self.tr_velo_to_cam.reshape(-1))
                + "\n"
            )
            f.write(f"Tr_imu_to_velo: {zeros34}\n")

    # -- transforms -----------------------------------------------------
    def lidar_to_rect(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) velodyne → rectified camera coords."""
        homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        cam = homo @ self.tr_velo_to_cam.T
        return cam @ self.r0.T

    def rect_to_lidar(self, pts: np.ndarray) -> np.ndarray:
        cam = pts @ np.linalg.inv(self.r0).T
        rot = self.tr_velo_to_cam[:, :3]
        t = self.tr_velo_to_cam[:, 3]
        return (cam - t) @ np.linalg.inv(rot).T

    def rect_to_img(self, pts_rect: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        homo = np.concatenate([pts_rect, np.ones((len(pts_rect), 1))], axis=1)
        uvz = homo @ self.p2.T
        depth = uvz[:, 2]
        return uvz[:, :2] / np.maximum(depth[:, None], 1e-9), depth


@dataclass
class Object3d:
    """One KITTI label line (object3d.py:10-102)."""

    cls_type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray  # (4,) xmin ymin xmax ymax
    h: float
    w: float
    l: float
    pos: np.ndarray  # (3,) camera-frame bottom-center
    ry: float
    score: float = -1.0

    @classmethod
    def from_line(cls, line: str) -> "Object3d":
        f = line.split()
        return cls(
            cls_type=f[0],
            truncation=float(f[1]),
            occlusion=int(float(f[2])),
            alpha=float(f[3]),
            box2d=np.array([float(x) for x in f[4:8]]),
            h=float(f[8]),
            w=float(f[9]),
            l=float(f[10]),
            pos=np.array([float(x) for x in f[11:14]]),
            ry=float(f[14]),
            score=float(f[15]) if len(f) > 15 else -1.0,
        )

    def to_line(self) -> str:
        parts = [
            self.cls_type,
            f"{self.truncation:.2f}",
            str(self.occlusion),
            f"{self.alpha:.2f}",
            *(f"{v:.2f}" for v in self.box2d),
            f"{self.h:.2f}",
            f"{self.w:.2f}",
            f"{self.l:.2f}",
            *(f"{v:.2f}" for v in self.pos),
            f"{self.ry:.2f}",
        ]
        if self.score >= 0:
            parts.append(f"{self.score:.4f}")
        return " ".join(parts)

    @property
    def difficulty(self) -> int:
        """0 easy / 1 moderate / 2 hard / −1 unknown (KITTI rules)."""
        height = float(self.box2d[3] - self.box2d[1])
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return -1


def read_label_file(path) -> List[Object3d]:
    with open(path) as f:
        return [Object3d.from_line(l) for l in f if l.strip()]


def write_label_file(path, objects: Sequence[Object3d]) -> None:
    with open(path, "w") as f:
        for obj in objects:
            f.write(obj.to_line() + "\n")


def box_lidar_to_camera(box7: np.ndarray, calib: Calibration) -> Tuple[np.ndarray, float]:
    """Lidar [x,y,z,w,l,h,yaw] (z center) → (camera bottom-center pos, ry)."""
    center = calib.lidar_to_rect(box7[None, :3])[0]
    center[1] += box7[5] / 2.0  # camera y points down: bottom = center + h/2
    ry = -box7[6] - np.pi / 2.0
    ry = np.mod(ry + np.pi, 2 * np.pi) - np.pi
    return center, float(ry)


def box_camera_to_lidar(pos: np.ndarray, hwl: Tuple[float, float, float], ry: float,
                        calib: Calibration) -> np.ndarray:
    """Inverse of :func:`box_lidar_to_camera` → lidar [x,y,z,w,l,h,yaw]."""
    h, w, l = hwl
    center_cam = np.asarray(pos, np.float64).copy()
    center_cam[1] -= h / 2.0
    center = calib.rect_to_lidar(center_cam[None])[0]
    yaw = -ry - np.pi / 2.0
    yaw = np.mod(yaw + np.pi, 2 * np.pi) - np.pi
    return np.array([center[0], center[1], center[2], w, l, h, yaw])


def default_calibration() -> Calibration:
    """Identity-extrinsics calibration with a nominal camera intrinsic —
    what the Lyft export uses when no real camera projection is needed."""
    p2 = np.zeros((3, 4))
    p2[:3, :3] = np.array([[800.0, 0, 600.0], [0, 800.0, 300.0], [0, 0, 1.0]])
    tr = np.zeros((3, 4))
    tr[:3, :3] = VELO_TO_CAM
    return Calibration(p2=p2, r0=np.eye(3), tr_velo_to_cam=tr)


def camera_calibration(db, sample: dict, cam_channel: str = "CAM_FRONT"
                       ) -> Optional[Calibration]:
    """Real per-sample calibration from the camera's calibrated_sensor:
    P2 = [K|0], Tr_velo_to_cam = T_cam_from_ego · T_ego_from_lidar
    (the extrinsic composition of process_token_to_kitti,
    export_kitti.py:126-249). None when the sample has no camera."""
    from lyft3d_tpu_torch.core.geometry import transform_matrix
    from lyft3d_tpu_torch.core.quaternion import quat_inverse

    if cam_channel not in sample.get("data", {}):
        return None
    cam_sd = db.get("sample_data", sample["data"][cam_channel])
    lid_sd = db.get("sample_data", sample["data"]["LIDAR_TOP"])
    cs_cam = db.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
    cs_lid = db.get("calibrated_sensor", lid_sd["calibrated_sensor_token"])
    if not cs_cam.get("camera_intrinsic"):
        return None
    ego_from_lidar = transform_matrix(cs_lid["translation"], cs_lid["rotation"])
    cam_from_ego = transform_matrix(
        cs_cam["translation"], cs_cam["rotation"], inverse=True
    )
    velo_to_cam = (cam_from_ego @ ego_from_lidar)[:3, :]
    p2 = np.zeros((3, 4))
    p2[:3, :3] = np.asarray(cs_cam["camera_intrinsic"], np.float64)
    return Calibration(p2=p2, r0=np.eye(3), tr_velo_to_cam=velo_to_cam)


def export_kitti(db, out_dir, sample_tokens: Optional[Sequence[str]] = None,
                 classes: Optional[Sequence[str]] = None,
                 cam_channel: str = "CAM_FRONT") -> Path:
    """Write a KITTI-layout tree (velodyne/, calib/, label_2/, and — when
    the dataset has camera data — image_2/ with real P2/Tr_velo_to_cam)
    from a LyftDB (export_kitti.py:56-249 capability)."""
    import cv2

    from lyft3d_tpu_torch.data.pointcloud import LidarPointCloud

    out = Path(out_dir)
    for sub in ("velodyne", "calib", "label_2", "ImageSets"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    default_calib = default_calibration()
    tokens = sample_tokens or [s["token"] for s in db.sample]
    index = []
    for i, tok in enumerate(tokens):
        stem = f"{i:06d}"
        index.append((stem, tok))
        sample = db.get("sample", tok)
        sd_token = sample["data"]["LIDAR_TOP"]
        pc = LidarPointCloud.from_file(db.get_sample_data_path(sd_token))
        pts5 = np.zeros((len(pc), 4), np.float32)
        pts5[:, :4] = pc.points[:, :4]
        pts5.tofile(out / "velodyne" / f"{stem}.bin")

        calib = camera_calibration(db, sample, cam_channel) or default_calib
        calib.to_file(out / "calib" / f"{stem}.txt")
        if cam_channel in sample.get("data", {}):
            img_path = db.get_sample_data_path(sample["data"][cam_channel])
            img = cv2.imread(str(img_path))
            if img is not None:
                (out / "image_2").mkdir(exist_ok=True)
                cv2.imwrite(str(out / "image_2" / f"{stem}.png"), img)

        objects = []
        for box in db.get_boxes_in_sensor_frame(sd_token):
            if classes is not None and box.name not in classes:
                continue
            b7 = box.as_xyzwlhr()
            pos, ry = box_lidar_to_camera(b7, calib)
            objects.append(
                Object3d(
                    cls_type=box.name,
                    truncation=0.0,
                    occlusion=0,
                    alpha=float(-np.arctan2(-b7[1], b7[0]) + ry),
                    box2d=np.array([0.0, 0.0, 100.0, 100.0]),
                    h=float(b7[5]), w=float(b7[3]), l=float(b7[4]),
                    pos=pos, ry=ry,
                )
            )
        write_label_file(out / "label_2" / f"{stem}.txt", objects)
    with open(out / "ImageSets" / "index.txt", "w") as f:
        for stem, tok in index:
            f.write(f"{stem} {tok}\n")
    return out
