"""BEV segmentation inference: lidar → raster → model → boxes → world → CSV
(port of ``lyft3d_tpu/pipelines/bev.py``).

The device program is :func:`make_infer_fn`: raster kernel → normalize →
map channels → UNet(s) → logit-space extraction, on a batch. The host does
the table lookups and the world-frame affine, with the port's own numpy data
layer (:mod:`lyft3d_tpu_torch.data`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from lyft3d_tpu_torch.core.quaternion import quat_from_yaw
from lyft3d_tpu_torch.data.bev_pipeline import (
    BEV_CLASSES,
    BEVConfig,
    BEVSampleGenerator,
    CLASS_HEIGHTS,
)
from lyft3d_tpu_torch.data.lyftdb import LyftDB
from lyft3d_tpu_torch.ops.bev_raster import bev_rasterize, normalize_bev
from lyft3d_tpu_torch.ops.mask_to_boxes import extract_detections_from_logits
from lyft3d_tpu_torch.utils.profiler import span

__all__ = [
    "make_bev_input",
    "make_infer_fn",
    "to_host",
    "detections_to_world",
    "BEVInferencePipeline",
    "quaternion_yaw_from_matrix",
    "gt_records",
]


def make_bev_input(points, valid, map_channel, cfg: BEVConfig):
    """Padded points ``(B, N, 3)`` + valid ``(B, N)`` + map ``(B, H, W)`` →
    ``(B, H, W, 6)`` normalized model input (also unbatched, without ``B``)."""
    counts = bev_rasterize(points, valid, cfg.shape, cfg.voxel_size, cfg.z_offset)
    lidar = normalize_bev(counts)
    map3 = map_channel[..., None].expand(*map_channel.shape, 3)
    return torch.cat([lidar, map3.to(lidar.dtype)], dim=-1)


def make_infer_fn(
    models: Sequence[nn.Module],
    cfg: BEVConfig,
    max_components: int = 64,
    bg_threshold: float = 80.0 / 255.0,
    class_score_threshold: float = 0.01,
) -> Callable:
    """Batched sample → detections program on the models' device.

    ``models``: modules whose ``forward`` returns ``(logits, aux)``; logits
    are averaged (an ensemble). They are put in eval mode.
    """
    for m in models:
        m.eval()

    @torch.inference_mode()
    def infer(points, valid, map_channel):
        """(B, N, 3) points, (B, N) valid, (B, H, W) map → dict of (B, …) tensors."""
        x = make_bev_input(points, valid, map_channel, cfg)
        logits = None
        for model in models:
            lg, _ = model(x)
            logits = lg if logits is None else logits + lg
        return extract_detections_from_logits(
            logits / len(models),
            bg_threshold=bg_threshold,
            class_score_threshold=class_score_threshold,
            max_components=max_components,
        )

    return infer


def to_host(det: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device→host copy for the whole detection dict: every field is
    packed into one float32 buffer (the integer and bool fields are exact
    in float32) and unpacked on the host."""
    with span("to_host"):
        keys = list(det)
        parts = [det[k].reshape(*det[k].shape[:2], -1).to(torch.float32) for k in keys]
        packed = torch.cat(parts, dim=-1).cpu().numpy()
        out, at = {}, 0
        for k, part in zip(keys, parts):
            width = part.shape[-1]
            arr = packed[..., at : at + width].reshape(det[k].shape)
            out[k] = arr.astype(torch.empty((), dtype=det[k].dtype).numpy().dtype)
            at += width
        return out


def detections_to_world(
    gen: BEVSampleGenerator, sample_token: str, det: Dict[str, np.ndarray]
) -> List[dict]:
    """Pixel-space component boxes → world-frame detection records."""
    cfg = gen.cfg
    h, w, _ = cfg.shape
    car2world = gen.car_to_world_matrix(sample_token)
    ego_yaw = quaternion_yaw_from_matrix(car2world)
    ego_z = float(car2world[2, 3])

    out: List[dict] = []
    boxes = det["boxes_px"]
    for i in range(boxes.shape[0]):
        if not det["box_valid"][i]:
            continue
        cx, cy, bw, bl, ang = (float(v) for v in boxes[i])
        x_car = (cx - w / 2.0) * cfg.voxel_size[0]
        y_car = (cy - h / 2.0) * cfg.voxel_size[1]
        # Undo the 0.8 GT shrink applied at training time.
        w_m = bw * cfg.voxel_size[0] / cfg.box_scale
        l_m = bl * cfg.voxel_size[1] / cfg.box_scale
        cw = car2world[:3, :3] @ np.array([x_car, y_car, 0.0]) + car2world[:3, 3]
        yaw_world = ang + ego_yaw
        for ci, name in enumerate(cfg.classes):
            if not det["detect"][i, ci]:
                continue
            height = CLASS_HEIGHTS.get(name, 1.8)
            out.append(
                {
                    "sample_token": sample_token,
                    "translation": [float(cw[0]), float(cw[1]), ego_z + height / 2.0],
                    "size": [w_m, l_m, height],
                    "rotation": list(quat_from_yaw(yaw_world)),
                    "yaw": yaw_world,
                    "name": name,
                    "score": float(det["scores"][i, ci]),
                }
            )
    return out


class BEVInferencePipeline:
    def __init__(
        self,
        db: LyftDB,
        models: Sequence[nn.Module],
        cfg: BEVConfig = BEVConfig(),
        device: Optional[torch.device] = None,
        **extract_kwargs,
    ):
        """``device``: where the batches go; by default the first model's."""
        self.db = db
        self.cfg = cfg
        self.gen = BEVSampleGenerator(db, cfg)
        self.device = torch.device(device) if device is not None else next(models[0].parameters()).device
        self.infer_fn = make_infer_fn(models, cfg, **extract_kwargs)

    def detect_sample(self, sample_token: str) -> List[dict]:
        return self.detect_all([sample_token])[sample_token]

    def detect_all(
        self, sample_tokens: Sequence[str], batch_size: int = 8
    ) -> Dict[str, List[dict]]:
        """Batched inference in fixed-size batches (the last one padded by
        repeating its final token), one device→host copy per batch."""
        out: Dict[str, List[dict]] = {}
        tokens = list(sample_tokens)
        for i in range(0, len(tokens), batch_size):
            chunk = tokens[i : i + batch_size]
            padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
            arrays = [self.gen.sample_arrays(t) for t in padded]

            def batch(key, fn=lambda a: a):
                return torch.from_numpy(np.stack([fn(a[key]) for a in arrays])).to(self.device)

            det = self.infer_fn(
                batch("points", lambda p: p[:, :3]),
                batch("points_valid"),
                batch("map"),
            )
            det = to_host(det)
            for j, tok in enumerate(chunk):
                out[tok] = detections_to_world(self.gen, tok, {k: v[j] for k, v in det.items()})
        return out


def quaternion_yaw_from_matrix(tm: np.ndarray) -> float:
    """Yaw of the rotation part of a 4x4 (projection of rotated x-axis)."""
    v = tm[:3, :3] @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def gt_records(db: LyftDB, sample_tokens: Sequence[str], classes=BEV_CLASSES) -> List[dict]:
    """Ground-truth records for the mAP evaluator."""
    recs = []
    for tok in sample_tokens:
        sample = db.get("sample", tok)
        for ann_tok in sample["anns"]:
            ann = db.get("sample_annotation", ann_tok)
            if ann["category_name"] not in classes:
                continue
            recs.append(
                {
                    "sample_token": tok,
                    "translation": list(ann["translation"]),
                    "size": list(ann["size"]),
                    "rotation": list(ann["rotation"]),
                    "name": ann["category_name"],
                }
            )
    return recs
