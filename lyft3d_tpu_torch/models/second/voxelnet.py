"""VoxelNet assembly and predict (port of ``lyft3d_tpu/models/second/voxelnet.py``).

Any encoder (``simple``: :class:`SimpleVoxel`, ``vfe``:
:class:`VoxelFeatureExtractor`, ``pillars``: :class:`PillarFeatureNet`) with
any middle, as in the JAX package, then :class:`RPN` and the batched
:func:`voxelnet_predict`:

- ``middle="scatter"``: :func:`pillar_scatter` (CUDA kernel
  ``csrc/dense_fill.cu`` on the card) of the encoder's rows at their (x, y);
  where the grid has several z cells, the voxels of a column sum;
- ``middle="sparse_units"`` (:class:`SparseMiddleUnits`) and
  ``middle="sparse_columns"`` (:class:`SparseMiddleColumns`): CUDA kernels
  ``csrc/stencil_conv.cu`` and ``csrc/dense_fill.cu``;
- ``middle="sparse"`` (:class:`SparseMiddle`): ``csrc/subm_conv.cu`` and
  ``csrc/dense_fill.cu``.

The middles take the encoder's channels (the point width for ``simple``,
``encoder_features[-1]`` otherwise). As in the JAX package, an encoder name
that is none of the three builds the pillar encoder and a middle name that is
none of the four the scatter.

:func:`voxelnet_loss` is the training objective (focal classification,
sin-error smooth-L1 localization, direction cross-entropy). Only a unit
middle with ``middle_norm="batch"`` behaves differently in ``train()`` mode
(a unit or column middle's BatchNorms; the rest is GroupNorm and LayerNorm),
and every kernel wrapper on its path is differentiable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.layers import materialize
from lyft3d_tpu_torch.models.second.rpn import RPN
from lyft3d_tpu_torch.models.second.middle import SparseMiddle, SparseMiddleColumns, SparseMiddleUnits
from lyft3d_tpu_torch.models.second.voxel_encoder import (
    PillarFeatureNet,
    SimpleVoxel,
    VoxelFeatureExtractor,
    pillar_scatter,
)
from lyft3d_tpu_torch.ops.anchors import AnchorSpec, generate_anchors
from lyft3d_tpu_torch.ops.box_ops import add_sin_difference, decode_boxes, limit_period
from lyft3d_tpu_torch.ops.nms import nms_mask_from_iou, rotated_nms, select_top_k
from lyft3d_tpu_torch.ops.rotated_iou import rotated_iou_bev
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
from lyft3d_tpu_torch.ops.voxelize import VoxelGrid
from lyft3d_tpu_torch.train.losses import sigmoid_focal_loss, weighted_smooth_l1
from lyft3d_tpu_torch.utils.profiler import span

__all__ = ["VoxelNetConfig", "VoxelNet", "voxelnet_loss", "voxelnet_predict"]

_META = torch.device("meta")


@dataclass(frozen=True)
class VoxelNetConfig:
    """The JAX package's ``VoxelNetConfig`` (same names and defaults)."""

    grid: VoxelGrid = VoxelGrid(
        point_cloud_range=(-49.6, -49.6, -5.0, 49.6, 49.6, 3.0),
        voxel_size=(0.25, 0.25, 8.0),
    )
    max_voxels: int = 20000
    max_points_per_voxel: int = 20
    encoder: str = "pillars"  # "simple", "vfe" or "pillars"
    encoder_features: Tuple[int, ...] = (64,)
    # "scatter" (pillars), "sparse_units" (z-slab units of BEV columns, the
    # sparse FHD config's), "sparse_columns" (dense-z BEV columns) or
    # "sparse" (per-voxel gather formulation).
    middle: str = "scatter"
    middle_features: Tuple[int, ...] = (16, 32, 64)
    middle_max_voxels: Tuple[int, ...] = (8192, 4096, 2048)
    # Stage-0 z-slab size of "sparse_units"; divisible by 2**(stages − 1).
    middle_z_slab: int = 8
    # Norm of the unit and column middles' layers: "layer", "batch" (running
    # statistics in eval mode) or "folded" (conv + bias).
    middle_norm: str = "layer"
    anchor_specs: Tuple[AnchorSpec, ...] = (
        AnchorSpec(size=(1.93, 4.76, 1.72), z_center=-1.0,
                   matched_threshold=0.6, unmatched_threshold=0.45),
    )
    rpn_layer_nums: Tuple[int, ...] = (3, 5, 5)
    rpn_strides: Tuple[int, ...] = (2, 2, 2)
    rpn_filters: Tuple[int, ...] = (64, 128, 256)
    rpn_up_strides: Tuple[float, ...] = (1, 2, 4)
    rpn_up_filters: Tuple[int, ...] = (128, 128, 128)
    encode_angle_to_vector: bool = False
    # Anchor-GT matching: "nearest" (standup IoU) or "rotated".
    similarity: str = "nearest"
    # Don't-care anchors over empty BEV area (0 disables), and the cap on
    # mask-selected anchors of the pruned (rotated) assignment.
    anchor_area_threshold: float = 0.0
    max_active_anchors: int = 4096
    num_classes: int = 1
    # loss
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    dir_weight: float = 0.2
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # predict
    nms_pre: int = 1000
    nms_post: int = 300
    nms_iou: float = 0.5
    score_threshold: float = 0.05
    # True = suppress only within each class; False = one NMS across classes.
    per_class_nms: bool = False

    @property
    def is_sparse(self) -> bool:
        return self.middle in ("sparse", "sparse_columns", "sparse_units")

    @property
    def middle_downsample(self) -> int:
        return 2 ** len(self.middle_features) if self.is_sparse else 1

    @property
    def feature_hw(self) -> Tuple[int, int]:
        """The RPN's output grid: each sparse stage's strided conv (k3 p1 s2:
        n → (n − 1)//2 + 1), the SAME-padded block-0 conv of stride s
        (n → ceil(n / s)), then ``int(· × up_strides[0])``."""
        nx, ny, _ = self.grid.grid_size
        h, w = ny, nx
        if self.is_sparse:
            for _ in self.middle_features:
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        s0 = self.rpn_strides[0]
        h, w = -(-h // s0), -(-w // s0)
        return (int(h * self.rpn_up_strides[0]), int(w * self.rpn_up_strides[0]))

    @property
    def anchors_per_loc(self) -> int:
        return sum(len(s.rotations) for s in self.anchor_specs)

    @property
    def box_code_size(self) -> int:
        return 8 if self.encode_angle_to_vector else 7

    def make_anchors(self, device=None):
        return generate_anchors(
            self.feature_hw, self.grid.point_cloud_range, self.anchor_specs, device
        )


class VoxelNet(nn.Module):
    """voxels → per-anchor predictions, batched (leading B).

    ``in_features`` is the point width D of the voxels. ``dtype`` is the
    compute type of the encoder, the middle and the RPN trunk; the three heads stay float32,
    as the flax heads do. Built on ``meta``, then allocated on ``device`` and
    initialised from ``generator`` (load the JAX package's weights with
    :func:`lyft3d_tpu_torch.utils.flax_params.load_flax_params`).
    """

    def __init__(
        self,
        config: VoxelNetConfig,
        in_features: int = 4,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.config = config
        cfg = config
        self.middle = None
        if cfg.encoder == "simple":
            self.encoder = SimpleVoxel(in_features, dtype=dtype)
            enc_features = in_features
        elif cfg.encoder == "vfe":
            self.encoder = VoxelFeatureExtractor(in_features, cfg.encoder_features, device=_META)
            enc_features = cfg.encoder_features[-1]
        else:
            self.encoder = PillarFeatureNet(
                in_features, cfg.encoder_features, cfg.grid.voxel_size[:2],
                cfg.grid.point_cloud_range[:2], device=_META,
            )
            enc_features = cfg.encoder_features[-1]
        if cfg.is_sparse:
            common = dict(stage_features=cfg.middle_features,
                          stage_max_voxels=cfg.middle_max_voxels, device=_META)
            # voxelize emits (y, x, z)-ordered flat ids: no sort needed.
            if cfg.middle == "sparse_units":
                self.middle = SparseMiddleUnits(
                    enc_features, z_slab=cfg.middle_z_slab, norm_type=cfg.middle_norm,
                    assume_sorted_voxels=True, nz=cfg.grid.grid_size[2], **common)
            elif cfg.middle == "sparse_columns":
                self.middle = SparseMiddleColumns(
                    enc_features, norm_type=cfg.middle_norm, assume_sorted_voxels=True, **common)
            else:
                self.middle = SparseMiddle(enc_features, **common)
            nz = cfg.grid.grid_size[2]
            for _ in cfg.middle_features:
                nz = (nz - 1) // 2 + 1
            bev_features = cfg.middle_features[-1] * nz
        else:
            bev_features = enc_features
        self.rpn = RPN(
            bev_features, cfg.rpn_layer_nums, cfg.rpn_strides, cfg.rpn_filters,
            cfg.rpn_up_strides, cfg.rpn_up_filters, cfg.anchors_per_loc, cfg.num_classes,
            cfg.box_code_size, device=_META,
        )
        materialize(self, device, dtype, generator, float32_heads=self.rpn.heads())

    def scatter(self, feats, coords, voxel_valid):
        """``(B, V, C)`` pillar features → ``(B, C, ny, nx)`` BEV map, NHWC in
        memory (``channels_last``), no copy."""
        nx, ny, _ = self.config.grid.grid_size
        # voxelize emits ascending unique flat ids (nz == 1 for pillars).
        canvas = pillar_scatter(feats, coords, voxel_valid, (ny, nx), assume_sorted=True)
        return canvas.permute(0, 3, 1, 2)

    def dense_bev(self, feats, coords, voxel_valid):
        """``(B, V, C)`` voxel features → the ``(B, C', H, W)`` BEV map the RPN
        takes, NHWC in memory: the pillar scatter, or the sparse middle."""
        if self.middle is None:
            return self.scatter(feats, coords, voxel_valid)
        active = ActiveSet(coords=coords, valid=voxel_valid,
                           spatial_shape=self.config.grid.grid_size)
        bev, _ = self.middle(feats, active)
        return bev.permute(0, 3, 1, 2)

    def forward(self, voxels, num_points, coords, voxel_valid) -> Dict[str, torch.Tensor]:
        cfg = self.config
        feats = self.encoder(voxels, num_points, coords)
        preds = self.rpn(self.dense_bev(feats, coords, voxel_valid))
        b = voxels.shape[0]
        return {
            "box": preds["box"].reshape(b, -1, cfg.box_code_size),
            "cls": preds["cls"].reshape(b, -1, cfg.num_classes),
            "dir": preds["dir"].reshape(b, -1, 2),
        }


def voxelnet_loss(preds, targets, cfg: VoxelNetConfig):
    """Focal classification + sin-error smooth-L1 localization + direction
    cross-entropy, each normalised by the sample's positives and averaged
    over the batch. ``targets``: the batched ``(B, A, …)`` dict of
    :func:`lyft3d_tpu_torch.ops.anchors.assign_targets`. Returns
    ``(total, metrics)``."""
    labels = targets["labels"]  # (B, A): −1 don't-care, 0 background, > 0 class
    pos = (labels > 0).float()
    care = (labels >= 0).float()
    num_pos = torch.clamp(pos.sum(dim=1, keepdim=True), min=1.0)

    # Per-class sigmoid focal, background encoded as zeros. num_classes == 1
    # means "objectness of the anchor's own class": every positive is a 1.
    if cfg.num_classes == 1:
        cls_onehot = pos[..., None]
    else:
        cls_onehot = F.one_hot((labels.long() - 1).clamp(min=0), cfg.num_classes).float() * pos[..., None]
    cls_loss = sigmoid_focal_loss(
        preds["cls"], cls_onehot, alpha=cfg.focal_alpha, gamma=cfg.focal_gamma
    ).sum(-1)
    cls_loss = (cls_loss * care / num_pos).sum()

    box_pred, box_tgt = preds["box"], targets["bbox_targets"]
    if not cfg.encode_angle_to_vector:
        sin_p, sin_t = add_sin_difference(box_pred[..., 6], box_tgt[..., 6])
        box_pred = torch.cat([box_pred[..., :6], sin_p[..., None]], dim=-1)
        box_tgt = torch.cat([box_tgt[..., :6], sin_t[..., None]], dim=-1)
    loc_loss = weighted_smooth_l1(box_pred, box_tgt, weights=pos / num_pos).sum()

    dir_logp = F.log_softmax(preds["dir"], dim=-1)
    dir_ll = torch.gather(dir_logp, -1, targets["dir_targets"].long()[..., None])[..., 0]
    dir_loss = (-dir_ll * pos / num_pos).sum()

    b = labels.shape[0]
    total = (cfg.cls_weight * cls_loss + cfg.loc_weight * loc_loss + cfg.dir_weight * dir_loss) / b
    return total, {
        "cls_loss": cls_loss / b,
        "loc_loss": loc_loss / b,
        "dir_loss": dir_loss / b,
        "num_pos": pos.sum() / b,
    }


def _take(x, idx):
    """``x[b, idx[b, k], …]`` for ``(B, A, …)`` x and ``(B, K)`` idx."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


def voxelnet_predict(preds, anchors, anchor_class, cfg: VoxelNetConfig):
    """Decode + score + rotated NMS for a batch.

    ``preds``: box ``(B, A, code)``, cls ``(B, A, classes)``, dir ``(B, A, 2)``;
    ``anchors`` ``(A, 7)`` and ``anchor_class`` ``(A,)`` on the same device.
    Returns fixed-size ``(B, K)`` detections, ``K = min(nms_post, nms_pre, A)``:
    boxes ``(B, K, 7)``, scores, classes (1-based, int32), valid.
    """
    with span("predict"):
        box = preds["box"].float()
        boxes = decode_boxes(box, anchors, cfg.encode_angle_to_vector)
        scores_all = torch.sigmoid(preds["cls"].float())
        scores, cls_idx = scores_all.max(dim=-1)
        if cfg.num_classes == 1:  # the anchor's own class
            pred_class = anchor_class.expand(scores.shape)
        else:
            pred_class = cls_idx.to(torch.int32) + 1

        # Direction fix: flip by π where the direction bit disagrees with the
        # anchor's, then wrap into [-π, π).
        dir_bit = preds["dir"].argmax(dim=-1)
        yaw = boxes[..., 6]
        pi = torch.tensor(math.pi, dtype=yaw.dtype, device=yaw.device)
        anchor_bit = torch.remainder(torch.floor((yaw - anchors[:, 6]) / pi), 2.0)
        yaw = torch.where(dir_bit != anchor_bit.to(dir_bit.dtype), yaw + pi, yaw)
        boxes = torch.cat([boxes[..., :6], limit_period(yaw, 0.5, 2 * math.pi)[..., None]], dim=-1)

        # Top-k prefilter (stable: ties to the lower index, as lax.top_k), then NMS.
        k = min(cfg.nms_pre, scores.shape[-1])
        top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        top_boxes = _take(boxes, top_idx)
        top_class = torch.gather(pred_class, 1, top_idx)
        valid = top_scores >= cfg.score_threshold

        bev = torch.cat([top_boxes[..., 0:2], top_boxes[..., 3:5], top_boxes[..., 6:7]], dim=-1)
        if cfg.per_class_nms:
            # Suppress only same-class overlaps; rows are already score-sorted.
            iou = rotated_iou_bev(bev, bev)
            same = top_class[..., :, None] == top_class[..., None, :]
            keep = nms_mask_from_iou(torch.where(same, iou, torch.zeros_like(iou)), top_scores,
                                     cfg.nms_iou, valid=valid, presorted=True)
        else:
            keep = rotated_nms(bev, top_scores, cfg.nms_iou, valid=valid)
        sel, sel_valid = select_top_k(keep, top_scores, min(cfg.nms_post, k))

        out_boxes = _take(top_boxes, sel)
        r = cfg.grid.point_cloud_range
        inside = (
            (out_boxes[..., 0] >= r[0]) & (out_boxes[..., 0] <= r[3])
            & (out_boxes[..., 1] >= r[1]) & (out_boxes[..., 1] <= r[4])
        )
        return {
            "boxes": out_boxes,
            "scores": torch.gather(top_scores, 1, sel),
            "classes": torch.gather(top_class, 1, sel),
            "valid": sel_valid & inside,
        }
