"""3D bounding-box value type (host-side numpy).

Capability match for the reference SDK ``Box``
(``lyft_dataset_sdk/utils/data_classes.py:474``): center + wlh size +
quaternion orientation, frame transforms, corner extraction. Axis
convention (same as nuScenes/Lyft): in the box's local frame x points
forward (length ``l``), y left (width ``w``), z up (height ``h``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from lyft3d_tpu_torch.core.quaternion import (
    quat_multiply,
    quat_to_rotation_matrix,
    quaternion_yaw,
)


@dataclass
class Box:
    center: np.ndarray  # (3,) xyz in the current frame
    wlh: np.ndarray  # (3,) width, length, height
    orientation: np.ndarray  # (4,) quaternion [w, x, y, z]
    label: int = -1
    score: float = float("nan")
    velocity: np.ndarray = field(
        default_factory=lambda: np.full(3, np.nan, dtype=np.float64)
    )
    name: Optional[str] = None
    token: Optional[str] = None

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64).reshape(3)
        self.wlh = np.asarray(self.wlh, dtype=np.float64).reshape(3)
        self.orientation = np.asarray(self.orientation, dtype=np.float64).reshape(4)
        self.velocity = np.asarray(self.velocity, dtype=np.float64).reshape(3)

    # -- frame transforms ---------------------------------------------------
    def translate(self, x: np.ndarray) -> "Box":
        self.center = self.center + np.asarray(x, dtype=np.float64)
        return self

    def rotate(self, quaternion: np.ndarray) -> "Box":
        """Rotate the box (center, orientation, velocity) by a quaternion."""
        rot = quat_to_rotation_matrix(quaternion)
        self.center = rot @ self.center
        self.orientation = quat_multiply(quaternion, self.orientation)
        self.velocity = rot @ self.velocity
        return self

    def transform(self, tm: np.ndarray) -> "Box":
        """Apply a 4x4 homogeneous transform (rotation must be a pure rotation)."""
        rot = tm[:3, :3]
        self.center = rot @ self.center + tm[:3, 3]
        # Recover quaternion of the rotation via yaw-free composition: rotate
        # orientation by the matrix's quaternion.
        self.orientation = quat_multiply(_rotmat_to_quat(rot), self.orientation)
        self.velocity = rot @ self.velocity
        return self

    def copy(self) -> "Box":
        return Box(
            center=self.center.copy(),
            wlh=self.wlh.copy(),
            orientation=self.orientation.copy(),
            label=self.label,
            score=self.score,
            velocity=self.velocity.copy(),
            name=self.name,
            token=self.token,
        )

    # -- derived geometry ---------------------------------------------------
    @property
    def yaw(self) -> float:
        return quaternion_yaw(self.orientation)

    @property
    def rotation_matrix(self) -> np.ndarray:
        return quat_to_rotation_matrix(self.orientation)

    def corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        """(3, 8) corners; first four are the +x face, last four the −x face.

        Corner order matches the reference SDK (``data_classes.py:622``):
        indices [2, 3, 7, 6] are the bottom face.
        """
        w, l, h = self.wlh * wlh_factor
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float64)
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float64)
        pts = np.stack([x, y, z])
        return self.rotation_matrix @ pts + self.center.reshape(3, 1)

    def bottom_corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        """(3, 4) corners of the bottom face (z = center_z − h/2)."""
        return self.corners(wlh_factor)[:, [2, 3, 7, 6]]

    def as_xyzwlhr(self) -> np.ndarray:
        """(7,) [x, y, z, w, l, h, yaw] — the flat detector representation."""
        return np.concatenate([self.center, self.wlh, [self.yaw]])


def _rotmat_to_quat(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion [w, x, y, z] (Shepperd's method)."""
    m = np.asarray(rot, dtype=np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    if i == 0:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        )
    if i == 1:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        return np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        )
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    return np.array(
        [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    )


def boxes_to_xyzwlhr(boxes) -> np.ndarray:
    """Stack a list of :class:`Box` into an (N, 7) [x,y,z,w,l,h,yaw] array."""
    if len(boxes) == 0:
        return np.zeros((0, 7), dtype=np.float64)
    return np.stack([b.as_xyzwlhr() for b in boxes])
