"""Bin-based box decoding for PointRCNN (port of the decode half of
``lyft3d_tpu/ops/bin_coder.py``).

Ground-plane offsets (x, y) are classified into bins over ±``loc_scope`` plus
a within-bin residual; z is a direct residual; heading is classified into
``num_head_bin`` bins over 2π plus a residual; size is a relative residual
against a mean size. The flat channel layout is::

    [x_bin (B) | y_bin (B) | x_res (B) | y_res (B) |
     head_bin (H) | head_res (H) | z_res (1) | size_res (3)]

with B = 2·loc_scope/loc_bin_size bins per axis. Both decoders take any
leading dimensions. ``encode_bin_targets`` and ``bin_reg_loss`` come with the
training port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

__all__ = ["BinCoderConfig", "decode_bin_boxes", "decode_refined_boxes"]


@dataclass(frozen=True)
class BinCoderConfig:
    loc_scope: float = 3.0
    loc_bin_size: float = 0.5
    num_head_bin: int = 12
    mean_size: Tuple[float, float, float] = (1.9, 4.6, 1.7)  # (w, l, h)
    # Per-class mean-size table, one (w, l, h) row per class. When set,
    # decoding indexes it with ``class_ids``; ``mean_size`` serves callers
    # without class information.
    class_mean_sizes: Optional[Tuple[Tuple[float, float, float], ...]] = None

    def means_for(self, like, class_ids=None):
        """``(…, 3)`` mean sizes on the device of ``like``: the table's row
        per anchor, or the global mean (broadcast by the caller)."""
        if self.class_mean_sizes is not None and class_ids is not None:
            table = torch.tensor(self.class_mean_sizes, dtype=like.dtype, device=like.device)
            return table[class_ids.long().clamp(0, table.shape[0] - 1)]
        return torch.tensor(self.mean_size, dtype=like.dtype, device=like.device)

    @property
    def num_loc_bins(self) -> int:
        return int(2 * self.loc_scope / self.loc_bin_size)

    @property
    def channels(self) -> int:
        return 4 * self.num_loc_bins + 2 * self.num_head_bin + 1 + 3

    def slices(self) -> Dict[str, slice]:
        b, h = self.num_loc_bins, self.num_head_bin
        o = 0
        out = {}
        for name, width in (
            ("x_bin", b), ("y_bin", b), ("x_res", b), ("y_res", b),
            ("head_bin", h), ("head_res", h), ("z_res", 1), ("size_res", 3),
        ):
            out[name] = slice(o, o + width)
            o += width
        return out


def _wrap_angle(yaw):
    """Into [−π, π), as ``jnp.mod(yaw + π, 2π) − π``."""
    return torch.remainder(yaw + math.pi, 2 * math.pi) - math.pi


def decode_bin_boxes(anchors_xyz, reg, cfg: BinCoderConfig, class_ids=None):
    """``(…, channels)`` raw head output → ``(…, 7)`` boxes ``[x, y, z, w, l,
    h, yaw]`` at ``(…, 3)`` anchor positions. ``argmax`` takes the first bin
    on equal logits."""
    sl = cfg.slices()

    def from_bin(bin_logits, res_all, d0):
        b = bin_logits.argmax(dim=-1, keepdim=True)
        res = torch.gather(res_all, -1, b)[..., 0]
        pos = (b[..., 0].to(res.dtype) + 0.5) * cfg.loc_bin_size + res * cfg.loc_bin_size
        return pos - cfg.loc_scope + d0

    x = from_bin(reg[..., sl["x_bin"]], reg[..., sl["x_res"]], anchors_xyz[..., 0])
    y = from_bin(reg[..., sl["y_bin"]], reg[..., sl["y_res"]], anchors_xyz[..., 1])
    z = anchors_xyz[..., 2] + reg[..., sl["z_res"]][..., 0]

    angle_per_bin = 2 * math.pi / cfg.num_head_bin
    hb = reg[..., sl["head_bin"]].argmax(dim=-1, keepdim=True)
    hres = torch.gather(reg[..., sl["head_res"]], -1, hb)[..., 0]
    yaw = (hb[..., 0].to(hres.dtype) + 0.5) * angle_per_bin + hres * (angle_per_bin / 2)
    yaw = _wrap_angle(yaw)

    mean = cfg.means_for(reg, class_ids)
    size = reg[..., sl["size_res"]] * mean + mean
    return torch.stack([x, y, z, size[..., 0], size[..., 1], size[..., 2], yaw], dim=-1)


def decode_refined_boxes(rois, rcnn_reg, cfg: BinCoderConfig, class_ids=None):
    """RCNN regression → refined boxes in the lidar frame.

    The RCNN head regresses in each RoI's canonical frame (origin at the RoI
    centre, x along its heading), so decoding at the origin yields a
    canonical-frame box that is rotated by the RoI yaw and translated back.
    """
    canon = decode_bin_boxes(torch.zeros_like(rois[..., :3], dtype=rcnn_reg.dtype),
                             rcnn_reg, cfg, class_ids)
    c, s = torch.cos(rois[..., 6]), torch.sin(rois[..., 6])
    x = c * canon[..., 0] - s * canon[..., 1] + rois[..., 0]
    y = s * canon[..., 0] + c * canon[..., 1] + rois[..., 1]
    z = canon[..., 2] + rois[..., 2]
    yaw = _wrap_angle(canon[..., 6] + rois[..., 6])
    return torch.stack([x, y, z, canon[..., 3], canon[..., 4], canon[..., 5], yaw], dim=-1)
