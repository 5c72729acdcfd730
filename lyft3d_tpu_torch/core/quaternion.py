"""Minimal quaternion algebra (numpy, host-side).

Quaternions are stored as arrays ``[w, x, y, z]`` (scalar-first), matching the
convention of the Lyft dataset JSON tables. This replaces the reference's
dependency on ``pyquaternion`` (used throughout
``nuscenes-devkit/lyft_dataset_sdk``); we only need the small subset below.

All functions are pure and operate on plain numpy arrays so they can be used
from dataset-preparation code without touching the device.
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q: np.ndarray) -> np.ndarray:
    """Return the unit quaternion along ``q``; identity for a zero quaternion."""
    q = np.asarray(q, dtype=np.float64)
    # Pre-scale by max |component| so the sum of squares never under/overflows
    # (e.g. [0,0,0,2e-161]**2 is a denormal whose sqrt loses ~1e-3 accuracy).
    m = np.max(np.abs(q), axis=-1, keepdims=True)
    safe_m = np.where(m == 0.0, 1.0, m)
    qs = q / safe_m
    n = np.linalg.norm(qs, axis=-1, keepdims=True)  # in [1, 2] when m > 0
    out = qs / np.where(n == 0.0, 1.0, n)
    if np.any(m == 0.0):
        out = np.where(m == 0.0, np.array([1.0, 0.0, 0.0, 0.0]), out)
    return out


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product q1 ⊗ q2 (both scalar-first, broadcastable)."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_inverse(q: np.ndarray) -> np.ndarray:
    """Inverse of a (unit or non-unit) quaternion."""
    q = np.asarray(q, dtype=np.float64)
    conj = q * np.array([1.0, -1.0, -1.0, -1.0])
    return conj / np.sum(q * q, axis=-1, keepdims=True)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) ``v`` (..., 3) by unit quaternion ``q`` (4,)."""
    return (quat_to_rotation_matrix(q) @ np.asarray(v, dtype=np.float64).T).T


def quat_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix of a quaternion (normalized internally)."""
    w, x, y, z = quat_normalize(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Unit quaternion for a rotation of ``angle`` radians about ``axis``."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * float(angle)
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def quat_from_yaw(yaw: float) -> np.ndarray:
    """Unit quaternion for a rotation of ``yaw`` about +z."""
    return quat_from_axis_angle(np.array([0.0, 0.0, 1.0]), yaw)


def quat_slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation between two unit quaternions.

    Used for interpolating box orientations at non-keyframe timestamps
    (capability of pyquaternion's ``Quaternion.slerp`` used by the reference's
    ``LyftDataset.get_boxes``, lyftdataset.py:372).
    """
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:  # take the short arc
        q1 = -q1
        dot = -dot
    if dot > 0.9995:  # nearly parallel: lerp + renormalize
        return quat_normalize(q0 + t * (q1 - q0))
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s0 = np.sin((1.0 - t) * theta) / np.sin(theta)
    s1 = np.sin(t * theta) / np.sin(theta)
    return quat_normalize(s0 * q0 + s1 * q1)


def quaternion_yaw(q: np.ndarray) -> float:
    """Yaw (rotation about +z) encoded in ``q``, in ``[-pi, pi]``.

    Projects the rotated x-axis onto the xy-plane and takes its angle —
    the same definition as the reference SDK
    (``lyft_dataset_sdk/utils/geometry_utils.py:164``), so it is robust to
    quaternions that also contain roll/pitch.
    """
    v = quat_rotate(q, np.array([[1.0, 0.0, 0.0]]))[0]
    return float(np.arctan2(v[1], v[0]))
