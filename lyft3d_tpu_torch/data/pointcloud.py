"""Lidar point-cloud IO and SE(3) transforms (host-side numpy).

Capability match for the reference SDK's ``PointCloud``/``LidarPointCloud``
(``lyft_dataset_sdk/utils/data_classes.py:21-280``): float32 ``.bin`` loading
(x, y, z, intensity, ring), frame transforms, near-ego removal, and
motion-compensated multi-sweep aggregation with per-point time lags — the
"long-context" axis of this workload (SURVEY.md §5): 10 sweeps grow a ~62k
point cloud to ~0.7M points.

Point storage is (N, D) row-major float32 (not the reference's (4, N)) —
row-major points feed the fixed-capacity device buffers directly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from lyft3d_tpu_torch.core.geometry import transform_matrix


class LidarPointCloud:
    """(N, 4) [x, y, z, intensity] float32 point cloud."""

    N_DIMS = 5  # on-disk: x, y, z, intensity, ring index

    def __init__(self, points: np.ndarray):
        points = np.asarray(points, dtype=np.float32)
        assert points.ndim == 2 and points.shape[1] >= 3, points.shape
        self.points = points

    def __len__(self) -> int:
        return self.points.shape[0]

    @property
    def xyz(self) -> np.ndarray:
        return self.points[:, :3]

    @classmethod
    def from_file(cls, path) -> "LidarPointCloud":
        """Load a Lyft ``.bin`` (float32 x5); keep x, y, z, intensity."""
        raw = np.fromfile(str(path), dtype=np.float32)
        n = raw.size // cls.N_DIMS
        return cls(raw[: n * cls.N_DIMS].reshape(n, cls.N_DIMS)[:, :4])

    # -- transforms ---------------------------------------------------------
    def transform(self, tm: np.ndarray) -> "LidarPointCloud":
        """Apply a 4x4 homogeneous transform in place."""
        xyz = self.points[:, :3]
        self.points[:, :3] = xyz @ tm[:3, :3].astype(np.float32).T + tm[:3, 3].astype(
            np.float32
        )
        return self

    def translate(self, t: np.ndarray) -> "LidarPointCloud":
        self.points[:, :3] += np.asarray(t, dtype=np.float32)
        return self

    def rotate(self, rot: np.ndarray) -> "LidarPointCloud":
        self.points[:, :3] = self.points[:, :3] @ np.asarray(rot, dtype=np.float32).T
        return self

    def remove_close(self, radius: float) -> "LidarPointCloud":
        """Drop points within an axis-aligned ``radius`` of the sensor origin
        in x/y (the ego-vehicle self-returns filter, data_classes.py:153)."""
        keep = np.logical_or(
            np.abs(self.points[:, 0]) >= radius, np.abs(self.points[:, 1]) >= radius
        )
        self.points = self.points[keep]
        return self


def load_multisweep(
    db,
    sample_data_token: str,
    num_sweeps: int = 10,
    min_distance: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregate a keyframe sweep with up to ``num_sweeps`` prior sweeps.

    Each prior sweep is motion-compensated into the reference (keyframe)
    sensor frame via the composite transform
    ``ref_sensor ← ref_ego ← global ← sweep_ego ← sweep_sensor`` — the same
    math the reference precomputes as ``sweep2lidar_rotation/translation``
    (``generating-dataset/create_nuscene_train_pkl_for_second.py:106-117``)
    and replays at load time (``second/.../nuscenes_dataset.py:203-224``).

    Returns:
        points: (N, 4) float32 [x, y, z, intensity] in the keyframe sensor
            frame (keyframe points first).
        time_lags: (N,) float32 seconds since each point's sweep (0 for the
            keyframe) — the 4th input feature of the SECOND voxelnet.
    """
    ref_sd = db.get("sample_data", sample_data_token)
    ref_time = 1e-6 * ref_sd["timestamp"]
    car_from_global = db.ego_pose_matrix(sample_data_token, inverse=True)
    sensor_from_car = db.sensor_pose_matrix(sample_data_token, inverse=True)
    ref_from_global = sensor_from_car @ car_from_global

    all_points: List[np.ndarray] = []
    all_times: List[np.ndarray] = []

    pc = LidarPointCloud.from_file(db.get_sample_data_path(sample_data_token))
    all_points.append(pc.points.copy())
    all_times.append(np.zeros(len(pc), dtype=np.float32))

    sd = ref_sd
    for _ in range(num_sweeps):
        if sd.get("prev", "") == "":
            break
        sd = db.get("sample_data", sd["prev"])
        sweep = LidarPointCloud.from_file(db.get_sample_data_path(sd["token"]))
        sweep.remove_close(min_distance)
        global_from_car = db.ego_pose_matrix(sd["token"])
        car_from_sensor = db.sensor_pose_matrix(sd["token"])
        sweep.transform(ref_from_global @ global_from_car @ car_from_sensor)
        all_points.append(sweep.points)
        lag = ref_time - 1e-6 * sd["timestamp"]
        all_times.append(np.full(len(sweep), lag, dtype=np.float32))

    return np.concatenate(all_points, axis=0), np.concatenate(all_times, axis=0)
