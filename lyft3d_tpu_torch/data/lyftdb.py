"""Lyft/nuScenes-style relational JSON-table database.

Capability match for the reference SDK's ``LyftDataset``
(``nuscenes-devkit/lyft_dataset_sdk/lyftdataset.py:34-455``): loads the 13
JSON tables, builds token→index reverse indices, decorates records with
shortcut fields, and exposes constant-time accessors plus box/pose helpers.

Differences from the reference by design:
- annotation tables are optional (one class covers both the train DB and the
  annotation-free test DB that the reference duplicates as ``LyftTestDataset``
  in ``generating-dataset/generating_test_bev.py:35-140``);
- no pyquaternion / cv2 dependency (core.quaternion + PIL);
- table storage is a plain dict so new tables don't need code changes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from lyft3d_tpu_torch.core.box import Box
from lyft3d_tpu_torch.core.geometry import transform_matrix
from lyft3d_tpu_torch.core.quaternion import quat_inverse, quat_slerp

TABLE_NAMES = [
    "category",
    "attribute",
    "visibility",
    "instance",
    "sensor",
    "calibrated_sensor",
    "ego_pose",
    "log",
    "scene",
    "sample",
    "sample_data",
    "sample_annotation",
    "map",
]

# Tables that may be absent (test split ships without annotations).
_OPTIONAL = {"instance", "sample_annotation", "attribute", "visibility"}


class LyftDB:
    """Relational view over the Lyft dataset JSON tables."""

    def __init__(self, data_path, json_path, verbose: bool = False):
        self.data_path = Path(data_path)
        self.json_path = Path(json_path)
        self.tables: Dict[str, List[dict]] = {}
        for name in TABLE_NAMES:
            fp = self.json_path / f"{name}.json"
            if fp.is_file():
                with open(fp) as f:
                    self.tables[name] = json.load(f)
            elif name in _OPTIONAL:
                self.tables[name] = []
            else:
                raise FileNotFoundError(f"required table missing: {fp}")
            if verbose:
                print(f"{len(self.tables[name])} {name}")
        self._token2ind: Dict[str, Dict[str, int]] = {
            name: {rec["token"]: i for i, rec in enumerate(recs)}
            for name, recs in self.tables.items()
        }
        self._decorate()

    # -- construction ---------------------------------------------------
    def _decorate(self) -> None:
        """Add shortcut fields (category_name, channel, sample.data/anns)."""
        for rec in self.tables["sample_annotation"]:
            inst = self.get("instance", rec["instance_token"])
            rec["category_name"] = self.get("category", inst["category_token"])["name"]

        for rec in self.tables["sample_data"]:
            cs = self.get("calibrated_sensor", rec["calibrated_sensor_token"])
            sensor = self.get("sensor", cs["sensor_token"])
            rec["sensor_modality"] = sensor["modality"]
            rec["channel"] = sensor["channel"]

        for rec in self.tables["sample"]:
            rec["data"] = {}
            rec["anns"] = []
        for rec in self.tables["sample_data"]:
            if rec.get("is_key_frame"):
                self.get("sample", rec["sample_token"])["data"][rec["channel"]] = rec["token"]
        for rec in self.tables["sample_annotation"]:
            self.get("sample", rec["sample_token"])["anns"].append(rec["token"])

        # log → map reverse index.
        log_to_map = {}
        for map_rec in self.tables.get("map", []):
            for log_token in map_rec.get("log_tokens", []):
                log_to_map[log_token] = map_rec["token"]
        for log_rec in self.tables["log"]:
            if log_rec["token"] in log_to_map:
                log_rec["map_token"] = log_to_map[log_rec["token"]]

    # -- accessors --------------------------------------------------------
    def get(self, table: str, token: str) -> dict:
        return self.tables[table][self._token2ind[table][token]]

    def getind(self, table: str, token: str) -> int:
        return self._token2ind[table][token]

    def field2token(self, table: str, field: str, query) -> List[str]:
        return [rec["token"] for rec in self.tables[table] if rec.get(field) == query]

    def __getattr__(self, name: str):
        # Table-as-attribute sugar: db.sample, db.scene, ...
        tables = self.__dict__.get("tables")
        if tables is not None and name in tables:
            return tables[name]
        raise AttributeError(name)

    # -- paths ------------------------------------------------------------
    def get_sample_data_path(self, sample_data_token: str) -> Path:
        rec = self.get("sample_data", sample_data_token)
        return self.data_path / rec["filename"]

    # -- poses ------------------------------------------------------------
    def ego_pose_matrix(self, sample_data_token: str, inverse: bool = False) -> np.ndarray:
        """4x4 car→global (or global→car with ``inverse``)."""
        sd = self.get("sample_data", sample_data_token)
        pose = self.get("ego_pose", sd["ego_pose_token"])
        return transform_matrix(pose["translation"], pose["rotation"], inverse=inverse)

    def sensor_pose_matrix(self, sample_data_token: str, inverse: bool = False) -> np.ndarray:
        """4x4 sensor→car (or car→sensor with ``inverse``)."""
        sd = self.get("sample_data", sample_data_token)
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        return transform_matrix(cs["translation"], cs["rotation"], inverse=inverse)

    # -- boxes --------------------------------------------------------------
    def get_box(self, sample_annotation_token: str) -> Box:
        rec = self.get("sample_annotation", sample_annotation_token)
        return Box(
            center=rec["translation"],
            wlh=rec["size"],
            orientation=rec["rotation"],
            name=rec["category_name"],
            token=rec["token"],
        )

    def get_boxes(self, sample_data_token: str) -> List[Box]:
        """All annotation boxes for a sample_data record, world frame.

        For non-keyframe sample_data, box centers/orientations are linearly /
        slerp-interpolated between the bracketing keyframes (semantics of
        ``lyftdataset.py:318-390``).
        """
        sd = self.get("sample_data", sample_data_token)
        sample = self.get("sample", sd["sample_token"])

        if sd.get("is_key_frame") or sample.get("prev", "") == "":
            return [self.get_box(tok) for tok in sample["anns"]]

        prev_sample = self.get("sample", sample["prev"])
        prev_by_inst = {
            self.get("sample_annotation", tok)["instance_token"]: self.get(
                "sample_annotation", tok
            )
            for tok in prev_sample["anns"]
        }
        t0, t1 = prev_sample["timestamp"], sample["timestamp"]
        t = min(max(sd["timestamp"], t0), t1)
        amount = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)

        boxes = []
        for tok in sample["anns"]:
            curr = self.get("sample_annotation", tok)
            prev = prev_by_inst.get(curr["instance_token"])
            if prev is None:
                boxes.append(self.get_box(tok))
                continue
            center = (1 - amount) * np.asarray(prev["translation"]) + amount * np.asarray(
                curr["translation"]
            )
            rot = quat_slerp(np.asarray(prev["rotation"]), np.asarray(curr["rotation"]), amount)
            boxes.append(
                Box(
                    center=center,
                    wlh=curr["size"],
                    orientation=rot,
                    name=curr["category_name"],
                    token=curr["token"],
                )
            )
        return boxes

    def get_boxes_in_sensor_frame(self, sample_data_token: str) -> List[Box]:
        """Boxes transformed world → ego → sensor frame (get_sample_data path)."""
        sd = self.get("sample_data", sample_data_token)
        pose = self.get("ego_pose", sd["ego_pose_token"])
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        boxes = self.get_boxes(sample_data_token)
        for box in boxes:
            box.translate(-np.asarray(pose["translation"]))
            box.rotate(quat_inverse(pose["rotation"]))
            box.translate(-np.asarray(cs["translation"]))
            box.rotate(quat_inverse(cs["rotation"]))
        return boxes

    def box_velocity(self, sample_annotation_token: str, max_time_diff: float = 1.5) -> np.ndarray:
        """Centered-difference velocity estimate in m/s (lyftdataset.py:391)."""
        current = self.get("sample_annotation", sample_annotation_token)
        has_prev = current.get("prev", "") != ""
        has_next = current.get("next", "") != ""
        if not has_prev and not has_next:
            return np.full(3, np.nan)

        first = self.get("sample_annotation", current["prev"]) if has_prev else current
        last = self.get("sample_annotation", current["next"]) if has_next else current

        pos_first = np.asarray(first["translation"], dtype=np.float64)
        pos_last = np.asarray(last["translation"], dtype=np.float64)

        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.full(3, np.nan)
        return (pos_last - pos_first) / dt

    # -- walking ------------------------------------------------------------
    def sample_tokens_of_scene(self, scene_token: str) -> List[str]:
        """Ordered sample tokens of a scene via the next-pointer chain."""
        scene = self.get("scene", scene_token)
        toks = []
        tok = scene["first_sample_token"]
        while tok:
            toks.append(tok)
            tok = self.get("sample", tok).get("next", "")
        return toks

    def map_mask_path(self, sample_token: str) -> Optional[Path]:
        """Filename of the map raster for a sample's log, if present."""
        sample = self.get("sample", sample_token)
        scene = self.get("scene", sample["scene_token"])
        log = self.get("log", scene["log_token"])
        if "map_token" not in log:
            return None
        map_rec = self.get("map", log["map_token"])
        return self.data_path / map_rec["filename"]
