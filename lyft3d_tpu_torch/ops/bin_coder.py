"""Bin-based box encoding for PointRCNN (port of
``lyft3d_tpu/ops/bin_coder.py``).

Ground-plane offsets (x, y) are classified into bins over ±``loc_scope`` plus
a within-bin residual; z is a direct residual; heading is classified into
``num_head_bin`` bins over 2π plus a residual; size is a relative residual
against a mean size. The flat channel layout is::

    [x_bin (B) | y_bin (B) | x_res (B) | y_res (B) |
     head_bin (H) | head_res (H) | z_res (1) | size_res (3)]

with B = 2·loc_scope/loc_bin_size bins per axis. Every function takes any
leading dimensions; :func:`bin_reg_loss` reduces over the last one (the
anchors of one sample) and keeps the others. Where the encoder divides by
a bin's size, it multiplies by the size's float32 reciprocal, a tensor on
the inputs' device: that is what the JAX package's jitted trainers compute
(XLA rewrites a division by a constant so), and a product rounds alike on
the card and the CPU, so a value on a bin edge gets the JAX package's bin on
both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from lyft3d_tpu_torch.train.losses import smooth_l1

__all__ = ["BinCoderConfig", "encode_bin_targets", "decode_bin_boxes", "decode_refined_boxes",
           "bin_reg_loss"]


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


def encode_bin_targets(anchors_xyz, gt_boxes, cfg: BinCoderConfig, class_ids=None):
    """Targets for points or RoIs at ``(…, 3)`` anchor positions against
    ``(…, 7)`` GT boxes: int32 bin labels and float residuals (normalised),
    as :func:`bin_reg_loss` takes them. ``class_ids`` selects per-class mean
    sizes when the config has a table."""
    dx = gt_boxes[..., 0] - anchors_xyz[..., 0]
    dy = gt_boxes[..., 1] - anchors_xyz[..., 1]
    dz = gt_boxes[..., 2] - anchors_xyz[..., 2]
    nb = cfg.num_loc_bins

    def inverse(value):
        """The float32 reciprocal of a constant, on the inputs' device."""
        return (1.0 / torch.tensor(value, dtype=torch.float32)).to(gt_boxes.device, gt_boxes.dtype)

    per_bin = inverse(cfg.loc_bin_size)

    def to_bin(d):
        shifted = torch.clamp(d + cfg.loc_scope, 0.0, 2 * cfg.loc_scope - 1e-4)
        b = torch.floor(shifted * per_bin).to(torch.int32)
        res = (shifted - (b.to(d.dtype) + 0.5) * cfg.loc_bin_size) * per_bin
        return torch.clamp(b, 0, nb - 1), res

    x_bin, x_res = to_bin(dx)
    y_bin, y_res = to_bin(dy)

    angle_per_bin = 2 * math.pi / cfg.num_head_bin
    heading = torch.remainder(gt_boxes[..., 6], 2 * math.pi)
    h_bin = torch.clamp(torch.floor(heading * inverse(angle_per_bin)).to(torch.int32), 0,
                        cfg.num_head_bin - 1)
    h_res = (heading - (h_bin.to(heading.dtype) + 0.5) * angle_per_bin) * inverse(angle_per_bin / 2)

    mean = cfg.means_for(gt_boxes, class_ids)
    size_res = (gt_boxes[..., 3:6] - mean) / mean
    return {
        "x_bin": x_bin, "x_res": x_res,
        "y_bin": y_bin, "y_res": y_res,
        "head_bin": h_bin, "head_res": h_res,
        "z_res": dz,
        "size_res": size_res,
    }


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


def bin_reg_loss(reg, targets, fg_mask, cfg: BinCoderConfig):
    """Bin cross-entropy + residual smooth-L1 over foreground anchors.
    ``reg (…, N, channels)``, targets of :func:`encode_bin_targets` with
    ``(…, N)`` leading shapes, ``fg_mask (…, N)``; each term is a sum over
    the N anchors over ``max(Σ fg, 1)`` of its own row, so a batch keeps
    every sample's denominator. Returns ``(loss (…), {"loc", "head",
    "size"})``."""
    sl = cfg.slices()
    fg = fg_mask.to(reg.dtype)
    nfg = torch.clamp(fg.sum(dim=-1), min=1.0)

    def pick(values, labels):
        return torch.gather(values, -1, labels.long()[..., None])[..., 0]

    def ce(logits, labels):
        return (-pick(F.log_softmax(logits, dim=-1), labels) * fg).sum(dim=-1) / nfg

    def res_loss(res_all, labels, target):
        return (smooth_l1(pick(res_all, labels) - target) * fg).sum(dim=-1) / nfg

    loss_x = ce(reg[..., sl["x_bin"]], targets["x_bin"]) + res_loss(
        reg[..., sl["x_res"]], targets["x_bin"], targets["x_res"])
    loss_y = ce(reg[..., sl["y_bin"]], targets["y_bin"]) + res_loss(
        reg[..., sl["y_res"]], targets["y_bin"], targets["y_res"])
    loss_h = ce(reg[..., sl["head_bin"]], targets["head_bin"]) + res_loss(
        reg[..., sl["head_res"]], targets["head_bin"], targets["head_res"])
    loss_z = (smooth_l1(reg[..., sl["z_res"]][..., 0] - targets["z_res"]) * fg).sum(dim=-1) / nfg
    loss_size = (smooth_l1(reg[..., sl["size_res"]] - targets["size_res"]).sum(dim=-1)
                 * fg).sum(dim=-1) / nfg
    total = loss_x + loss_y + loss_h + loss_z + loss_size
    return total, {"loc": loss_x + loss_y + loss_z, "head": loss_h, "size": loss_size}
