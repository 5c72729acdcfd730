"""Point-cloud training augmentation + GT-database copy-paste sampling.

Host-side numpy capability of the reference's augmentation stack
(``second/second/core/preprocess.py``: ``noise_per_object_v3_:582`` per-object
rotation/translation perturbation with collision checks, ``random_flip:749``,
``global_rotation_v2:772-781``, ``global_scaling_v2``, ``global_translate_``;
``core/sample_ops.py`` ``DataBaseSamplerV2:14-359`` class-balanced copy-paste
with ``box_collision_test`` (preprocess.py:804); GT-database creation
``second/second/data/all_dataset.py:14-80``). The numba JIT loops become
vectorized numpy — the host only prepares fixed-capacity arrays.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from lyft3d_tpu_torch.core.geometry import points_in_boxes

__all__ = [
    "box_collision_test",
    "random_flip",
    "global_rotation",
    "global_scaling",
    "global_translate",
    "noise_per_object",
    "GTDatabase",
    "create_gt_database",
    "DataBaseSampler",
]


def _corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) [x,y,z,w,l,h,yaw] → (N, 4, 2) BEV corners."""
    x, y, w, l, yaw = boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]
    lx = np.stack([l, -l, -l, l], -1) / 2
    wy = np.stack([w, w, -w, -w], -1) / 2
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    return np.stack([c * lx - s * wy + x[:, None], s * lx + c * wy + y[:, None]], -1)


def box_collision_test(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, M) bool: BEV overlap between rotated boxes (preprocess.py:804).

    Uses the separating-axis theorem over the 4 candidate axes of each pair
    (exact for rectangles) — vectorized instead of numba polygon walking.
    """
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m), bool)
    c1 = _corners_bev(boxes1)  # (N, 4, 2)
    c2 = _corners_bev(boxes2)  # (M, 4, 2)

    def axes(c):
        e = np.roll(c, -1, axis=1) - c  # (K, 4, 2) edges
        ax = np.stack([-e[..., 1], e[..., 0]], -1)  # normals
        return ax / np.maximum(np.linalg.norm(ax, axis=-1, keepdims=True), 1e-9)

    a1 = axes(c1)[:, :2]  # rectangles: 2 unique axes each
    a2 = axes(c2)[:, :2]
    all_axes = np.concatenate(
        [np.broadcast_to(a1[:, None], (n, m, 2, 2)),
         np.broadcast_to(a2[None, :], (n, m, 2, 2))], axis=2
    )  # (N, M, 4, 2)

    # Project corners of both boxes on each axis.
    proj1 = np.einsum("nmxd,nkd->nmxk", all_axes, c1)  # (N, M, 4, 4)
    proj2 = np.einsum("nmxd,mkd->nmxk", all_axes, c2)
    sep = (proj1.max(-1) < proj2.min(-1) - 1e-9) | (proj2.max(-1) < proj1.min(-1) - 1e-9)
    return ~sep.any(-1)


def random_flip(points, boxes, rng, probability: float = 0.5):
    """Flip y (random_flip:749): points/boxes y := −y, yaw := −yaw."""
    if rng.rand() < probability:
        points = points.copy()
        boxes = boxes.copy()
        points[:, 1] = -points[:, 1]
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
    return points, boxes


def global_rotation(points, boxes, rng, rotation=(-np.pi / 4, np.pi / 4)):
    theta = rng.uniform(*rotation)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    points = points.copy()
    boxes = boxes.copy()
    points[:, :2] = points[:, :2] @ rot.T
    boxes[:, :2] = boxes[:, :2] @ rot.T
    boxes[:, 6] += theta
    return points, boxes, theta


def global_scaling(points, boxes, rng, scale=(0.95, 1.05)):
    f = rng.uniform(*scale)
    points = points.copy()
    boxes = boxes.copy()
    points[:, :3] *= f
    boxes[:, :6] *= f
    return points, boxes, f


def global_translate(points, boxes, rng, noise_std=(0.2, 0.2, 0.2)):
    t = rng.normal(scale=noise_std, size=3)
    points = points.copy()
    boxes = boxes.copy()
    points[:, :3] += t
    boxes[:, :3] += t
    return points, boxes, t


def noise_per_object(
    points,
    boxes,
    rng,
    rotation_perturb=(-np.pi / 20, np.pi / 20),
    center_noise_std=(1.0, 1.0, 0.5),
    num_try: int = 20,
):
    """Per-object pose perturbation with collision rejection
    (noise_per_object_v3_:582-680): each box draws ``num_try`` candidate
    (Δxyz, Δyaw); the first candidate not colliding with any *other* current
    box wins; the box's points move rigidly with it.
    """
    points = points.copy()
    boxes = boxes.copy()
    n = len(boxes)
    if n == 0:
        return points, boxes
    membership = points_in_boxes(points[:, :3], boxes[:, :3], boxes[:, 3:6], boxes[:, 6])

    for i in range(n):
        trans = rng.normal(scale=center_noise_std, size=(num_try, 3))
        rots = rng.uniform(rotation_perturb[0], rotation_perturb[1], size=num_try)
        others = np.delete(boxes, i, axis=0)
        chosen = None
        for t in range(num_try):
            cand = boxes[i].copy()
            cand[:3] += trans[t]
            cand[6] += rots[t]
            if not box_collision_test(cand[None], others).any():
                chosen = (trans[t], rots[t])
                break
        if chosen is None:
            continue
        tvec, dyaw = chosen
        mask = membership[i]
        c, s = np.cos(dyaw), np.sin(dyaw)
        rel = points[mask, :2] - boxes[i, :2]
        points[mask, 0] = c * rel[:, 0] - s * rel[:, 1] + boxes[i, 0]
        points[mask, 1] = s * rel[:, 0] + c * rel[:, 1] + boxes[i, 1]
        points[mask, :3] += tvec
        boxes[i, :3] += tvec
        boxes[i, 6] += dyaw
    return points, boxes


class GTDatabase:
    """On-disk per-object point crops, grouped by class.

    Format: ``dbinfos.pkl`` {class: [{"path", "box", "name", "num_points"}]}
    + per-object float32 ``.bin`` crops in object-local frame — the
    capability of ``kitti_dbinfos_train.pkl`` (all_dataset.py:14-80).
    """

    def __init__(self, root):
        self.root = Path(root)
        with open(self.root / "dbinfos.pkl", "rb") as f:
            self.infos: Dict[str, List[dict]] = pickle.load(f)

    def classes(self):
        return sorted(self.infos)


def create_gt_database(root, samples: Sequence[dict], min_points: int = 5):
    """Build a GT database from per-sample dicts
    ``{"points" (N,≥3), "gt_boxes" (G,7), "gt_names" (G,)}``.

    Point crops are stored relative to the box center (rotated into the box
    frame is NOT applied — matching the reference, which stores
    center-relative sensor-frame points).
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    infos: Dict[str, List[dict]] = defaultdict(list)
    obj_id = 0
    for sample in samples:
        pts = np.asarray(sample["points"], np.float32)
        boxes = np.asarray(sample["gt_boxes"], np.float64)
        if len(boxes) == 0:
            continue
        member = points_in_boxes(pts[:, :3], boxes[:, :3], boxes[:, 3:6], boxes[:, 6])
        for g, name in enumerate(sample["gt_names"]):
            crop = pts[member[g]].copy()
            if len(crop) < min_points:
                continue
            crop[:, :3] -= boxes[g, :3]
            path = f"obj_{obj_id:06d}_{name}.bin"
            crop.astype(np.float32).tofile(root / path)
            infos[name].append(
                {
                    "path": path,
                    "box": boxes[g].tolist(),
                    "name": name,
                    "num_points": int(len(crop)),
                }
            )
            obj_id += 1
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(dict(infos), f)
    return GTDatabase(root)


class DataBaseSampler:
    """Class-balanced copy-paste augmentation (DataBaseSamplerV2:14-359).

    ``sample_all`` draws up to ``max_per_class[name]`` extra objects per
    class, rejects candidates colliding with existing or already-placed
    boxes, and pastes their stored point crops at the (original) box poses.
    """

    def __init__(self, db: GTDatabase, max_per_class: Dict[str, int], seed: int = 0):
        self.db = db
        self.max_per_class = max_per_class
        self.rng = np.random.RandomState(seed)
        self._queues: Dict[str, List[int]] = {}

    def _draw(self, name: str) -> dict:
        # Shuffled epoch queue per class (BatchSampler, preprocess.py:17-56).
        q = self._queues.get(name)
        if not q:
            q = list(self.rng.permutation(len(self.db.infos[name])))
            self._queues[name] = q
        return self.db.infos[name][q.pop()]

    def sample_all(self, gt_boxes, gt_names, points=None):
        """Returns dict with sampled boxes/names/points (possibly empty)."""
        existing = np.asarray(gt_boxes, np.float64).reshape(-1, 7)
        placed_boxes: List[np.ndarray] = []
        placed_names: List[str] = []
        placed_points: List[np.ndarray] = []
        for name, max_n in self.max_per_class.items():
            if name not in self.db.infos or not self.db.infos[name]:
                continue
            have = int(np.sum(np.asarray(gt_names) == name)) if len(gt_names) else 0
            want = max_n - have
            for _ in range(max(want, 0)):
                info = self._draw(name)
                cand = np.asarray(info["box"], np.float64)
                obstacles = (
                    np.concatenate([existing] + [b[None] for b in placed_boxes])
                    if placed_boxes
                    else existing
                )
                if box_collision_test(cand[None], obstacles).any():
                    continue
                crop = np.fromfile(self.db.root / info["path"], np.float32).reshape(
                    -1, 4
                )
                crop = crop.copy()
                crop[:, :3] += cand[:3].astype(np.float32)
                placed_boxes.append(cand)
                placed_names.append(name)
                placed_points.append(crop)
        if not placed_boxes:
            return None
        return {
            "boxes": np.stack(placed_boxes),
            "names": np.asarray(placed_names),
            "points": np.concatenate(placed_points),
        }
