"""SE(3) pose math and projection helpers (numpy, host-side).

Covers the capability surface of the reference SDK's
``lyft_dataset_sdk/utils/geometry_utils.py`` (view_points:21,
transform_matrix:95, points_in_box:124, quaternion_yaw:164) with our own
formulation.
"""

from __future__ import annotations

import numpy as np

from lyft3d_tpu_torch.core.quaternion import quat_to_rotation_matrix

__all__ = ["transform_matrix", "view_points", "points_in_box", "points_in_boxes"]


def transform_matrix(
    translation: np.ndarray = (0.0, 0.0, 0.0),
    rotation: np.ndarray = (1.0, 0.0, 0.0, 0.0),
    inverse: bool = False,
) -> np.ndarray:
    """4x4 homogeneous transform from a translation + quaternion pose.

    With ``inverse=False`` the matrix maps local → parent frame
    (``p_parent = R p_local + t``); with ``inverse=True`` it is the exact
    inverse (``p_local = Rᵀ (p_parent − t)``).
    """
    tm = np.eye(4, dtype=np.float64)
    rot = quat_to_rotation_matrix(np.asarray(rotation, dtype=np.float64))
    trans = np.asarray(translation, dtype=np.float64)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ trans
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = trans
    return tm


def view_points(points: np.ndarray, view: np.ndarray, normalize: bool) -> np.ndarray:
    """Apply a (≤4x4) projection/view matrix to (3, N) points.

    If ``normalize`` is set, divides by the homogeneous (depth) coordinate —
    i.e. a perspective camera projection. Mirrors the capability of the
    reference SDK ``view_points`` (geometry_utils.py:21).
    """
    points = np.asarray(points, dtype=np.float64)
    assert points.shape[0] == 3, "points must be (3, N)"
    view = np.asarray(view, dtype=np.float64)
    vp = np.eye(4)
    vp[: view.shape[0], : view.shape[1]] = view

    n = points.shape[1]
    homo = np.concatenate([points, np.ones((1, n))], axis=0)
    out = vp @ homo
    out = out[:3]
    if normalize:
        out = out / out[2:3]
    return out


def points_in_box(box, points: np.ndarray, wlh_factor: float = 1.0) -> np.ndarray:
    """Boolean mask of which (3, N) points fall inside a :class:`Box`.

    Uses the box's local axes (projections onto the three edge directions)
    rather than the reference's corner-dot-product formulation; identical
    semantics to ``geometry_utils.points_in_box`` (:124).
    """
    points = np.asarray(points, dtype=np.float64)
    rot = quat_to_rotation_matrix(box.orientation)
    local = rot.T @ (points - np.asarray(box.center, dtype=np.float64).reshape(3, 1))
    w, l, h = np.asarray(box.wlh, dtype=np.float64) * wlh_factor
    # Local frame: x = forward (length l), y = left (width w), z = up (height h).
    return (
        (np.abs(local[0]) <= l / 2.0)
        & (np.abs(local[1]) <= w / 2.0)
        & (np.abs(local[2]) <= h / 2.0)
    )


def points_in_boxes(
    points: np.ndarray, centers: np.ndarray, wlh: np.ndarray, yaws: np.ndarray
) -> np.ndarray:
    """Vectorized point-in-rotated-box test for yaw-only boxes.

    Args:
        points: (N, 3) xyz.
        centers: (B, 3) box centers.
        wlh: (B, 3) width/length/height.
        yaws: (B,) rotation about +z.

    Returns:
        (B, N) boolean mask.
    """
    points = np.asarray(points, dtype=np.float64)
    centers = np.asarray(centers, dtype=np.float64)
    wlh = np.asarray(wlh, dtype=np.float64)
    yaws = np.asarray(yaws, dtype=np.float64)

    d = points[None, :, :] - centers[:, None, :]  # (B, N, 3)
    c, s = np.cos(yaws), np.sin(yaws)
    # Rotate into box frame: R(-yaw) @ d.
    lx = c[:, None] * d[:, :, 0] + s[:, None] * d[:, :, 1]
    ly = -s[:, None] * d[:, :, 0] + c[:, None] * d[:, :, 1]
    lz = d[:, :, 2]
    half = wlh / 2.0
    return (
        (np.abs(lx) <= half[:, None, 1])
        & (np.abs(ly) <= half[:, None, 0])
        & (np.abs(lz) <= half[:, None, 2])
    )
