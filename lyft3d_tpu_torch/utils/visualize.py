"""BEV + camera debug visualization.

Capability of the reference's debug drawing (``second/second/utils/
simplevis.py`` point-cloud→BEV image with GT/det boxes; ``bbox_plot.py``)
and the SDK explorer's render helpers (``lyftdataset.py:606-934``):
rasterize points to a grayscale BEV image, draw rotated boxes with cv2
polylines, and project lidar points into camera images
(``LyftDatasetExplorer.map_pointcloud_to_image`` ``lyftdataset.py:730``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "points_to_bev_image",
    "draw_boxes_bev",
    "bev_debug_image",
    "map_pointcloud_to_image",
    "render_pointcloud_in_image",
    "draw_box_edges_cv2",
    "render_boxes_in_image",
]

_CLASS_COLORS = [
    (0, 255, 0), (255, 128, 0), (0, 128, 255), (255, 0, 255), (255, 255, 0),
    (128, 255, 128), (0, 0, 255), (255, 0, 0), (128, 0, 255), (0, 255, 255),
]


def points_to_bev_image(
    points: np.ndarray,
    extent: float = 80.0,
    resolution: float = 0.16,
) -> np.ndarray:
    """(N, ≥2) points → (H, W, 3) uint8 intensity image (ego centered)."""
    size = int(round(2 * extent / resolution))
    img = np.zeros((size, size), np.float32)
    col = np.floor(points[:, 0] / resolution + size / 2).astype(np.int64)
    row = np.floor(points[:, 1] / resolution + size / 2).astype(np.int64)
    ok = (col >= 0) & (col < size) & (row >= 0) & (row < size)
    np.add.at(img, (row[ok], col[ok]), 1.0)
    img = np.clip(img / 4.0, 0, 1)
    return np.repeat((img * 255).astype(np.uint8)[..., None], 3, axis=-1)


def draw_boxes_bev(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: Optional[np.ndarray] = None,
    extent: float = 80.0,
    resolution: float = 0.16,
    thickness: int = 1,
) -> np.ndarray:
    """Draw (B, 7) [x,y,z,w,l,h,yaw] boxes onto a BEV image in place."""
    import cv2

    size = image.shape[0]
    for i, b in enumerate(np.asarray(boxes).reshape(-1, 7)):
        x, y, w, l, yaw = b[0], b[1], b[3], b[4], b[6]
        c, s = np.cos(yaw), np.sin(yaw)
        lx = np.array([l, -l, -l, l]) / 2
        wy = np.array([w, w, -w, -w]) / 2
        px = (c * lx - s * wy + x) / resolution + size / 2
        py = (s * lx + c * wy + y) / resolution + size / 2
        poly = np.round(np.stack([px, py], -1)).astype(np.int32)
        ci = int(classes[i]) % len(_CLASS_COLORS) if classes is not None else 0
        cv2.polylines(image, [poly], True, _CLASS_COLORS[ci], thickness)
        # Heading tick from center to the +x face.
        cx, cy = x / resolution + size / 2, y / resolution + size / 2
        hx, hy = (x + c * l / 2) / resolution + size / 2, (y + s * l / 2) / resolution + size / 2
        cv2.line(image, (int(cx), int(cy)), (int(hx), int(hy)), _CLASS_COLORS[ci], thickness)
    return image


def map_pointcloud_to_image(
    db, pointsensor_token: str, camera_token: str, min_dist: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project a lidar sweep into a camera image.

    The SDK explorer's ``map_pointcloud_to_image`` (``lyftdataset.py:730``):
    points go lidar → ego(lidar ts) → global → ego(camera ts) → camera, then
    through the camera intrinsic; points behind or closer than ``min_dist``
    or outside the canvas are dropped.

    Returns (points_2d (2, N), depths (N,), image (H, W, 3) uint8).
    """
    from PIL import Image

    from lyft3d_tpu_torch.core.geometry import view_points
    from lyft3d_tpu_torch.data.pointcloud import LidarPointCloud

    pc = LidarPointCloud.from_file(db.get_sample_data_path(pointsensor_token))
    pts = pc.points[:, :3].T.astype(np.float64)  # (3, N)

    def apply(m, p):
        return m[:3, :3] @ p + m[:3, 3:4]

    pts = apply(db.sensor_pose_matrix(pointsensor_token), pts)
    pts = apply(db.ego_pose_matrix(pointsensor_token), pts)
    pts = apply(db.ego_pose_matrix(camera_token, inverse=True), pts)
    pts = apply(db.sensor_pose_matrix(camera_token, inverse=True), pts)

    cam_sd = db.get("sample_data", camera_token)
    cs = db.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
    intrinsic = np.asarray(cs["camera_intrinsic"], np.float64)

    image = np.asarray(Image.open(db.get_sample_data_path(camera_token)).convert("RGB"))
    h, w = image.shape[:2]

    depths = pts[2]
    uv = view_points(pts, intrinsic, normalize=True)[:2]
    ok = (
        (depths > min_dist)
        & (uv[0] > 1) & (uv[0] < w - 1)
        & (uv[1] > 1) & (uv[1] < h - 1)
    )
    return uv[:, ok], depths[ok], image


def render_pointcloud_in_image(
    db, sample_token: str, camera_channel: str = "CAM_FRONT",
    pointsensor_channel: str = "LIDAR_TOP", dot_radius: int = 2,
) -> np.ndarray:
    """Draw the projected lidar points on the camera image, depth-colored
    (``LyftDatasetExplorer.render_pointcloud_in_image`` capability).
    Returns the annotated (H, W, 3) uint8 image."""
    import cv2

    sample = db.get("sample", sample_token)
    cam_token = sample["data"][camera_channel]
    pts_token = sample["data"][pointsensor_channel]
    uv, depths, image = map_pointcloud_to_image(db, pts_token, cam_token)
    img = image.copy()  # PIL-backed arrays are readonly
    if depths.size:
        lo, hi = float(depths.min()), float(depths.max())
        t = (depths - lo) / max(hi - lo, 1e-6)
        for (u, v), ti in zip(uv.T, t):
            color = (int(255 * (1 - ti)), 64, int(255 * ti))  # near=red → far=blue
            cv2.circle(img, (int(u), int(v)), dot_radius, color, -1)
    return img


def draw_box_edges_cv2(image: np.ndarray, corners2d: np.ndarray,
                       color: Tuple[int, int, int] = (0, 255, 0),
                       thickness: int = 2) -> None:
    """Draw a projected 3D box's 12 edges + front-face cross in place.

    ``corners2d``: (2, 8) pixel coords in ``core.box.Box.corners`` order
    (first four = +x/front face, last four = −x face) — the drawing pattern
    of the SDK's ``Box.render_cv2`` (``utils/data_classes.py:683-720``).
    """
    import cv2

    c = corners2d.T.astype(int)

    def line(a, b):
        cv2.line(image, tuple(c[a]), tuple(c[b]), color, thickness)

    for i in range(4):  # front face, rear face, connecting edges
        line(i, (i + 1) % 4)
        line(i + 4, (i + 1) % 4 + 4)
        line(i, i + 4)
    # Front-face cross marks heading (render_cv2 draws center-line to front).
    line(0, 2)
    line(1, 3)


def render_boxes_in_image(
    db, sample_token: str, camera_channel: str = "CAM_FRONT",
    boxes=None, color: Tuple[int, int, int] = (0, 255, 0), thickness: int = 2,
) -> np.ndarray:
    """Render annotation boxes onto a camera image.

    The explorer's camera branch of ``render_sample_data``
    (``lyftdataset.py:934-1007``: boxes in the camera sensor frame via
    ``get_sample_data``, then ``box.render_cv2`` with the camera
    intrinsic). ``boxes`` overrides the annotation set (e.g. detections as
    camera-frame ``core.box.Box``); boxes with any corner behind the camera
    are skipped (BoxVisibility semantics).

    Returns the annotated (H, W, 3) uint8 image.
    """
    from PIL import Image

    from lyft3d_tpu_torch.core.geometry import view_points

    sample = db.get("sample", sample_token)
    cam_token = sample["data"][camera_channel]
    if boxes is None:
        boxes = db.get_boxes_in_sensor_frame(cam_token)
    cam_sd = db.get("sample_data", cam_token)
    cs = db.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
    intrinsic = np.asarray(cs["camera_intrinsic"], np.float64)
    image = np.asarray(
        Image.open(db.get_sample_data_path(cam_token)).convert("RGB")
    ).copy()
    h, w = image.shape[:2]
    for box in boxes:
        corners = box.corners()  # (3, 8) camera frame
        if (corners[2] <= 0.1).any():  # behind the image plane
            continue
        uv = view_points(corners, intrinsic, normalize=True)[:2]
        if (uv[0] < 0).all() or (uv[0] >= w).all() or (uv[1] < 0).all() or (
            uv[1] >= h
        ).all():
            continue
        draw_box_edges_cv2(image, uv, color, thickness)
    return image


def bev_debug_image(points, gt_boxes=None, det_boxes=None, extent=80.0,
                    resolution=0.16) -> np.ndarray:
    """One-call debug view: points gray, GT green-family, dets red-family."""
    img = points_to_bev_image(points, extent, resolution)
    if gt_boxes is not None and len(gt_boxes):
        draw_boxes_bev(img, gt_boxes, np.zeros(len(gt_boxes), int), extent, resolution)
    if det_boxes is not None and len(det_boxes):
        draw_boxes_bev(img, det_boxes, np.full(len(det_boxes), 7, int), extent, resolution)
    return img
