"""PointRCNN: PointNet++ RPN → proposals → RCNN refinement, and its training
targets and losses (port of ``lyft3d_tpu/models/pointrcnn/net.py``).

- ``PointRCNNBackbone``: 4 MSG set-abstraction stages + 4 feature-propagation
  stages back to per-point features;
- ``PointRCNN_RPN``: per-point foreground logit + bin-based box regression;
- :func:`proposal_layer`: decode → score top-k → rotated NMS → a fixed
  proposal set (optionally split into a near and a far quota);
- ``PointRCNN_RCNN``: RoI points in the box-canonical frame → SA stack →
  class logit + bin regression;
- ``PointRCNN``: the joint net, ending in refined lidar-frame boxes;
- training: :func:`rpn_point_labels` and :func:`rpn_loss` (focal
  foreground/background + bin regression over foreground points),
  :func:`proposal_target_layer` (IoU-based RoI sampling with hard-background
  mining), :func:`aug_rois_with_noise` (IoU-controlled RoI jitter) and
  :func:`rcnn_loss`.

Everything is batched with fixed capacities: xyz ``(B, N, 3)``, valid
``(B, N)``; the RCNN stage folds the RoI axis into the batch (``B·R`` clouds
of ``roi_points`` points), where the JAX package ``vmap``s over samples and
RoIs. The losses return one value a sample, each with its own denominators,
as the JAX package's per-sample functions under ``vmap``; the trainers take
their mean. ``dtype`` is the compute type of the MLP stacks; geometry, the
``cls``/``reg`` heads, decoding and NMS stay float32, as in the flax modules.
The JAX package draws the random numbers of RoI sampling and RoI noise from
``jax.random`` inside the functions; here they are arguments (uniforms of
the JAX draws' shapes and ranges), and :func:`draw_target_priorities` and
:func:`draw_roi_noise` draw them from a ``torch.Generator``. The
grid-bucketed ball query (``grid_bounds``) is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import materialize
from lyft3d_tpu_torch.models.pointrcnn.modules import (
    FPModule,
    SAModuleGlobal,
    SAModuleMSG,
    SharedMLP,
)
from lyft3d_tpu_torch.ops.bin_coder import (
    BinCoderConfig,
    bin_reg_loss,
    decode_bin_boxes,
    decode_refined_boxes,
    encode_bin_targets,
)
from lyft3d_tpu_torch.ops.nms import rotated_nms, select_top_k
from lyft3d_tpu_torch.ops.pointnet2 import roi_pool3d
from lyft3d_tpu_torch.ops.rotated_iou import rotated_iou_3d, rotated_iou_3d_paired
from lyft3d_tpu_torch.train.losses import _stable_bce, sigmoid_focal_loss

__all__ = [
    "PointRCNNConfig",
    "LYFT_CLS_MEAN_SIZES",
    "LYFT_CLASS_NAMES",
    "lyft_pointrcnn_config",
    "PointRCNNBackbone",
    "PointRCNN_RPN",
    "proposal_layer",
    "canonical_transform",
    "PointRCNN_RCNN",
    "PointRCNN",
    "rpn_point_labels",
    "rpn_loss",
    "gather_boxes",
    "draw_target_priorities",
    "proposal_target_layer",
    "draw_roi_noise",
    "aug_rois_with_noise",
    "rcnn_loss",
]

_META = torch.device("meta")


@dataclass(frozen=True)
class PointRCNNConfig:
    # backbone (scaled down by default)
    sa_npoints: Tuple[int, ...] = (1024, 256, 64, 16)
    sa_radii: Tuple[Tuple[float, ...], ...] = ((0.5, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 8.0))
    sa_nsamples: Tuple[Tuple[int, ...], ...] = ((16, 32), (16, 32), (16, 32), (16, 32))
    sa_widths: Tuple[int, ...] = (32, 64, 128, 256)
    fp_width: int = 128
    # RPN head / coder
    rpn_coder: BinCoderConfig = field(default_factory=BinCoderConfig)
    # proposals
    num_proposals: int = 64
    nms_pre: int = 256
    proposal_nms_iou: float = 0.8
    # distance-bucketed NMS: the near bucket (< bucket_radius) gets
    # near_fraction of the proposal quota.
    distance_bucket: bool = False
    bucket_radius: float = 40.0
    near_fraction: float = 0.7
    # RCNN
    rcnn_coder: BinCoderConfig = field(
        default_factory=lambda: BinCoderConfig(loc_scope=1.5, loc_bin_size=0.5)
    )
    roi_points: int = 128
    roi_extra_width: float = 1.0
    rcnn_sa_npoints: Tuple[int, ...] = (64, 16)
    rcnn_widths: Tuple[int, ...] = (128, 256)
    rcnn_sa_radii: Tuple[float, ...] = (1.0, 1.0)
    rcnn_sa_nsamples: Tuple[int, ...] = (16, 16)
    # proposal targets (training)
    fg_iou: float = 0.55
    bg_iou: float = 0.45
    rois_per_image: int = 32
    fg_fraction: float = 0.5
    bg_iou_lo: float = 0.05
    hard_bg_ratio: float = 0.8
    roi_fg_aug_times: int = 10
    # final NMS over refined boxes at eval
    final_nms_iou: float = 0.1
    # Grid-bucketed ball query of the JAX package: not ported, must stay None.
    grid_bounds: Any = None
    grid_plane: Tuple[int, int] = (0, 2)


# Lyft 9-class mean sizes (w, l, h).
LYFT_CLS_MEAN_SIZES = (
    (1.93, 4.76, 1.72),   # car
    (0.96, 2.35, 1.59),   # motorcycle
    (2.96, 12.34, 3.44),  # bus
    (0.63, 1.76, 1.44),   # bicycle
    (2.84, 10.24, 3.44),  # truck
    (0.77, 0.81, 1.78),   # pedestrian
    (2.79, 8.20, 3.23),   # other_vehicle
    (0.36, 0.73, 0.51),   # animal
    (2.45, 6.52, 2.39),   # emergency_vehicle
)

LYFT_CLASS_NAMES = (
    "car", "motorcycle", "bus", "bicycle", "truck", "pedestrian",
    "other_vehicle", "animal", "emergency_vehicle",
)


def lyft_pointrcnn_config(mode: str = "test", class_name: str = "car") -> PointRCNNConfig:
    """Reference-capacity Lyft config: 16,384-point input, SA pyramid
    4096/1024/256/64 with paired-radius MSG groups, FP to 128-channel point
    features, 512 train / 100 test proposals with distance-bucketed NMS (0.85
    train / 0.8 test), 512 RoI points, RCNN SA 128/32 + global.

    ``class_name`` selects the mean size the bin coders regress against (one
    class per run, for all 9 Lyft classes).
    """
    train = mode == "train"
    mean = LYFT_CLS_MEAN_SIZES[LYFT_CLASS_NAMES.index(class_name)]
    return PointRCNNConfig(
        sa_npoints=(4096, 1024, 256, 64),
        sa_radii=((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0)),
        sa_nsamples=((16, 32), (16, 32), (16, 32), (16, 32)),
        sa_widths=(48, 128, 256, 512),  # 2 MSG branches => 96/256/512/1024 channels
        fp_width=128,
        rpn_coder=BinCoderConfig(
            loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12,
            mean_size=mean, class_mean_sizes=LYFT_CLS_MEAN_SIZES,
        ),
        num_proposals=512 if train else 100,
        nms_pre=1024,
        proposal_nms_iou=0.85 if train else 0.8,
        distance_bucket=True,
        bucket_radius=40.0,
        near_fraction=0.7,
        rcnn_coder=BinCoderConfig(
            loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9,
            mean_size=mean, class_mean_sizes=LYFT_CLS_MEAN_SIZES,
        ),
        roi_points=512,
        roi_extra_width=1.0,
        rcnn_sa_npoints=(128, 32),
        rcnn_widths=(128, 256, 512),
        rcnn_sa_radii=(0.2, 0.4),
        rcnn_sa_nsamples=(64, 64),
        fg_iou=0.55,
        bg_iou=0.45,
        rois_per_image=64,
        fg_fraction=0.5,
        final_nms_iou=0.1,
    )


def _check_ported(cfg: PointRCNNConfig):
    if cfg.grid_bounds is not None:
        raise NotImplementedError(
            "grid_bounds: the grid-bucketed ball query is not ported to lyft3d_tpu_torch; "
            "the CUDA ball query serves every size"
        )


def _finish(module: nn.Module, device, dtype: torch.dtype, generator):
    """Allocate and initialise a module built on ``meta`` (see
    :func:`lyft3d_tpu_torch.models.layers.materialize`); a module that is
    itself part of a larger one (``device`` is ``meta``) is left to its owner.
    The heads stay float32 and the RPN's class bias starts at
    ``−log((1 − 0.01) / 0.01)``, as in the flax modules."""
    if device == _META:
        return
    heads = [h for m in module.modules() if isinstance(m, (PointRCNN_RPN, PointRCNN_RCNN))
             for h in (m.cls, m.reg)]
    materialize(module, device, dtype, generator, float32_heads=tuple(heads))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, PointRCNN_RPN):
                m.cls.bias.fill_(-math.log((1 - 0.01) / 0.01))


class PointRCNNBackbone(nn.Module):
    """SA pyramid + FP back to per-point features ``(B, N, fp_width)``.
    ``in_features`` is the width of the input point features."""

    def __init__(self, cfg: PointRCNNConfig, in_features: int = 1, norm: str = "layer",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        widths = [in_features]
        self.sa = nn.ModuleList()
        for npoint, radii, nsamples, w in zip(cfg.sa_npoints, cfg.sa_radii, cfg.sa_nsamples,
                                              cfg.sa_widths):
            sa = SAModuleMSG(widths[-1], npoint, radii, nsamples, [[w, w] for _ in radii],
                             norm=norm, device=_META)
            self.sa.append(sa)
            widths.append(sa.out_features)
        # fp[0] is the coarsest level's: it runs first.
        self.fp = nn.ModuleList()
        up = widths[-1]
        for i in range(len(widths) - 1, 0, -1):
            self.fp.append(FPModule(up + widths[i - 1], [cfg.fp_width, cfg.fp_width], norm=norm,
                                    device=_META))
            up = cfg.fp_width
        self.out_features = up
        _finish(self, device, dtype, generator)

    def forward(self, xyz, features, valid):
        stack = [(xyz, features, valid)]
        for sa in self.sa:
            stack.append(sa(*stack[-1]))
        up_feats = stack[-1][1]
        for fp, i in zip(self.fp, range(len(stack) - 1, 0, -1)):
            ux, uf, _ = stack[i - 1]
            kx, _, kv = stack[i]
            up_feats = fp(ux, uf, kx, up_feats, kv)
        return up_feats


class PointRCNN_RPN(nn.Module):
    """Backbone + per-point heads: ``{"point_features" (B, N, C), "cls"
    (B, N), "reg" (B, N, channels)}``; the heads are float32."""

    def __init__(self, cfg: PointRCNNConfig, in_features: int = 1, norm: str = "layer",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = PointRCNNBackbone(cfg, in_features, norm=norm, device=_META)
        self.mlp = SharedMLP(cfg.fp_width, [cfg.fp_width], norm=norm, device=_META)
        self.cls = nn.Linear(cfg.fp_width, 1, device=_META)
        self.reg = nn.Linear(cfg.fp_width, cfg.rpn_coder.channels, device=_META)
        _finish(self, device, dtype, generator)

    def forward(self, xyz, features, valid) -> Dict[str, torch.Tensor]:
        feats = self.backbone(xyz, features, valid)
        h = self.mlp(feats).float()
        return {"point_features": feats, "cls": self.cls(h)[..., 0], "reg": self.reg(h)}


def _take(x, idx):
    """``x[b, idx[b, k], …]`` for ``(B, N, …)`` x and ``(B, K)`` idx."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


def proposal_layer(xyz, cls_logits, reg, valid, cfg: PointRCNNConfig):
    """Decode per-point boxes → score top-k → rotated NMS → fixed proposals:
    ``{"rois" (B, P, 7), "roi_scores" (B, P), "roi_valid" (B, P)}``. Orders
    are stable, so equal scores (every invalid point scores −1) keep the
    lower index, as ``jnp.argsort`` does."""
    boxes = decode_bin_boxes(xyz, reg.float(), cfg.rpn_coder)
    scores = torch.where(valid, torch.sigmoid(cls_logits.float()), -1.0)

    k = min(cfg.nms_pre, scores.shape[-1])
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = _take(boxes, top_idx)
    bev = torch.cat([top_boxes[..., 0:2], top_boxes[..., 3:5], top_boxes[..., 6:7]], dim=-1)
    keep = rotated_nms(bev, top_scores, cfg.proposal_nms_iou, valid=top_scores > 0)

    if cfg.distance_bucket:
        # Near/far quota split.
        x, y = top_boxes[..., 0], top_boxes[..., 1]
        near = torch.sqrt(x * x + y * y) < cfg.bucket_radius
        n_near = int(round(cfg.num_proposals * cfg.near_fraction))
        sel_n, val_n = select_top_k(keep & near, top_scores, n_near)
        sel_f, val_f = select_top_k(keep & ~near, top_scores, cfg.num_proposals - n_near)
        sel = torch.cat([sel_n, sel_f], dim=-1)
        sel_valid = torch.cat([val_n, val_f], dim=-1)
    else:
        sel, sel_valid = select_top_k(keep, top_scores, cfg.num_proposals)
    return {
        "rois": _take(top_boxes, sel),
        "roi_scores": torch.gather(top_scores, 1, sel),
        "roi_valid": sel_valid,
    }


def draw_target_priorities(shape, generator: Optional[torch.Generator] = None, device=None):
    """The uniforms :func:`proposal_target_layer` takes: priorities in [0, 1)
    of ``shape`` (``(B, R)``) for the fg, hard and easy pools, drawn from
    ``generator`` on its device and moved to ``device``."""
    return tuple(torch.rand(shape, generator=generator).to(device) for _ in range(3))


def _random_subset(priorities, member, n):
    """Keep mask selecting ``min(n, |member|)`` members a row: the members
    ranked by their priorities (a stable sort; non-members rank last), ranks
    below ``n (…)`` kept, the fixed-shape form of ``permutation(count)[:n]``."""
    pri = torch.where(member, priorities, 2.0)
    order = torch.argsort(pri, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(member.shape[-1], device=member.device).expand_as(order))
    return member & (rank < n[..., None])


def gather_boxes(boxes, idx):
    """``boxes[b, idx[b, r]]`` for ``(B, G, 7)`` boxes and ``(B, R)`` idx."""
    return torch.gather(boxes, 1, idx.long()[..., None].expand(*idx.shape, boxes.shape[-1]))


def proposal_target_layer(rois, roi_valid, gt_boxes, gt_valid, cfg: PointRCNNConfig, priorities):
    """Train-time RoI sampling: 3D IoU against the GT boxes, random
    foreground subsampling and hard-background mining.

    ``rois (B, R, 7)``, ``roi_valid (B, R)``, ``gt_boxes (B, G, 7)``,
    ``gt_valid (B, G)``; ``priorities`` the three ``(B, R)`` uniforms of
    :func:`draw_target_priorities` (fg, hard, easy). Foreground is IoU ≥
    ``fg_iou``, subsampled to ``fg_fraction·rois_per_image``; background
    splits into hard (IoU in [``bg_iou_lo``, ``bg_iou``)) and easy (IoU below
    ``bg_iou_lo``), the hard pool taking ``hard_bg_ratio`` of the remaining
    quota (floored in float32, as the JAX package computes it) and each pool
    topping up the other when it runs short. Returns ``{"assigned_gt" (B, R)
    (the first best GT), "fg", "keep" (B, R) bool, "max_iou" (B, R)}``.
    """
    iou = rotated_iou_3d(rois, gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_gt = iou.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    best_iou = torch.where(roi_valid, iou.amax(dim=-1), -1.0)
    fg = best_iou >= cfg.fg_iou
    hard_bg = (best_iou < cfg.bg_iou) & (best_iou >= cfg.bg_iou_lo) & roi_valid
    easy_bg = (best_iou < cfg.bg_iou_lo) & (best_iou >= 0.0) & roi_valid

    p_fg, p_hard, p_easy = priorities
    n_fg_max = int(round(cfg.rois_per_image * cfg.fg_fraction))
    n_fg = torch.clamp(fg.sum(dim=-1), max=n_fg_max)
    keep_fg = _random_subset(p_fg, fg, n_fg)

    n_bg = cfg.rois_per_image - n_fg
    n_hard_avail = hard_bg.sum(dim=-1)
    n_easy_avail = easy_bg.sum(dim=-1)
    ratio = torch.tensor(cfg.hard_bg_ratio, dtype=torch.float32, device=rois.device)
    hard_quota = torch.minimum(torch.floor(n_bg.float() * ratio).long(), n_hard_avail)
    easy_take = torch.minimum(n_bg - hard_quota, n_easy_avail)
    hard_take = torch.minimum(n_bg - easy_take, n_hard_avail)
    keep_bg = _random_subset(p_hard, hard_bg, hard_take) | _random_subset(p_easy, easy_bg, easy_take)
    return {"assigned_gt": best_gt, "fg": keep_fg, "keep": keep_fg | keep_bg, "max_iou": best_iou}


def draw_roi_noise(shape, attempts: int, generator: Optional[torch.Generator] = None, device=None,
                   loc_range: float = 0.5, size_range: float = 0.15,
                   yaw_range: float = math.pi / 12) -> Dict[str, torch.Tensor]:
    """The uniforms :func:`aug_rois_with_noise` takes for RoIs of ``shape``
    (``(B, R)``), with the JAX draws' shapes and ranges: ``keep (B, R, A)`` in
    [0, 1), ``loc (B, R, A, 3)`` in ±``loc_range``, ``size (B, R, A, 3)`` in
    ±``size_range``, ``yaw (B, R, A)`` in ±``yaw_range``; drawn from
    ``generator`` and moved to ``device``."""
    shape = (*shape, attempts)

    def uniform(extra, lo, hi):
        return (lo + (hi - lo) * torch.rand((*shape, *extra), generator=generator)).to(device)

    return {"keep": uniform((), 0.0, 1.0), "loc": uniform((3,), -loc_range, loc_range),
            "size": uniform((3,), -size_range, size_range), "yaw": uniform((), -yaw_range, yaw_range)}


def aug_rois_with_noise(rois, noise: Dict[str, torch.Tensor], gt_of_rois=None, fg=None,
                        pos_iou: float = 0.55, keep_prob: float = 0.2):
    """Train-time RoI perturbation with IoU-controlled resampling.

    For each of ``rois (B, R, 7)``, ``A`` candidates (the attempts of
    ``noise``, :func:`draw_roi_noise`): each keeps the RoI where its ``keep``
    uniform is below ``keep_prob``, else shifts the centre by ``loc``, scales
    the size by ``1 + size`` (at least 0.1) and turns the heading by ``yaw``.
    The first candidate whose 3D IoU with the RoI's assigned GT box
    (``gt_of_rois (B, R, 7)``) reaches ``pos_iou`` wins, else the last one
    allowed; RoIs outside ``fg`` get one attempt. Without ``gt_of_rois`` the
    first candidate is returned.
    """
    attempts = noise["keep"].shape[-1]
    keep = noise["keep"] < keep_prob
    box = rois[..., None, :]
    cand = torch.cat([
        box[..., :3] + noise["loc"],
        torch.clamp(box[..., 3:6] * (1.0 + noise["size"]), min=0.1),
        box[..., 6:7] + noise["yaw"][..., None],
    ], dim=-1).to(rois.dtype)
    cand = torch.where(keep[..., None], box, cand)
    if gt_of_rois is None:
        return cand[..., 0, :]

    iou = rotated_iou_3d_paired(cand, gt_of_rois[..., None, :])
    if fg is None:
        att = torch.full(rois.shape[:-1], attempts, dtype=torch.long, device=rois.device)
    else:
        att = torch.where(fg, attempts, 1)
    allowed = torch.arange(attempts, device=rois.device) < att[..., None]
    ok = (iou >= pos_iou) & allowed
    first = ok.to(torch.uint8).argmax(dim=-1)  # the first True, as jnp.argmax on booleans
    chosen = torch.where(ok.any(dim=-1), first, att - 1)
    return torch.gather(cand, -2, chosen[..., None, None].expand(*chosen.shape, 1, 7))[..., 0, :]


def canonical_transform(pooled_xyz, rois):
    """Rotate ``(B, R, P, 3)`` RoI point samples into the box-canonical
    frame: subtract the centre, rotate by −yaw."""
    rel = pooled_xyz - rois[:, :, None, :3]
    c = torch.cos(-rois[..., 6])[..., None]
    s = torch.sin(-rois[..., 6])[..., None]
    x = c * rel[..., 0] - s * rel[..., 1]
    y = s * rel[..., 0] + c * rel[..., 1]
    return torch.stack([x, y, rel[..., 2]], dim=-1)


class _RoIEncoder(nn.Module):
    """One set of weights over every RoI cloud: ``(M, P, 3 + C)`` points and
    ``(M,)`` counts → ``(M, C')``."""

    def __init__(self, cfg: PointRCNNConfig, in_features: int, norm: str, device=None):
        super().__init__()
        self.lift = SharedMLP(in_features, [cfg.rcnn_widths[0]], norm=norm, device=device)
        self.sa = nn.ModuleList()
        width = cfg.rcnn_widths[0]
        for npoint, w, r, ns in zip(cfg.rcnn_sa_npoints, cfg.rcnn_widths, cfg.rcnn_sa_radii,
                                    cfg.rcnn_sa_nsamples):
            sa = SAModuleMSG(width, npoint, (r,), (ns,), [[w, w]], norm=norm, device=device)
            self.sa.append(sa)
            width = sa.out_features
        self.pool = SAModuleGlobal(width, [cfg.rcnn_widths[-1]], norm=norm, device=device)
        self.out_features = self.pool.out_features

    def forward(self, pts, count):
        xyz = pts[..., :3].contiguous()
        feats = self.lift(pts)
        valid = torch.arange(pts.shape[1], device=pts.device) < count.clamp(min=1)[:, None]
        for sa in self.sa:
            xyz, feats, valid = sa(xyz, feats, valid)
        return self.pool(xyz, feats, valid)


class PointRCNN_RCNN(nn.Module):
    """Refinement head over canonical RoI point sets: ``roi_points (B, R, P,
    3 + C)`` and ``roi_counts (B, R)`` → ``{"cls" (B, R), "reg" (B, R,
    channels)}``. ``in_features`` is 3 + C."""

    def __init__(self, cfg: PointRCNNConfig, in_features: int, norm: str = "layer",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        self.encoder = _RoIEncoder(cfg, in_features, norm, device=_META)
        self.fc = nn.Linear(self.encoder.out_features, cfg.rcnn_widths[-1], device=_META)
        self.cls = nn.Linear(cfg.rcnn_widths[-1], 1, device=_META)
        self.reg = nn.Linear(cfg.rcnn_widths[-1], cfg.rcnn_coder.channels, device=_META)
        _finish(self, device, dtype, generator)

    def forward(self, roi_points, roi_counts) -> Dict[str, torch.Tensor]:
        b, r = roi_counts.shape
        g = self.encoder(roi_points.flatten(0, 1), roi_counts.flatten())
        h = torch.relu(self.fc(g)).float().unflatten(0, (b, r))
        return {"cls": self.cls(h)[..., 0], "reg": self.reg(h)}


class PointRCNN(nn.Module):
    """Joint two-stage net: RPN → proposals → RoI pool + canonical transform
    → RCNN heads → refined boxes.

    ``forward(xyz (B, N, 3), features (B, N, C) or None, valid (B, N))``;
    without features a single zero channel stands in, as in the flax module.
    Built on ``meta``, then allocated on ``device`` and initialised from
    ``generator`` (load the JAX package's weights with
    :func:`lyft3d_tpu_torch.utils.flax_params.load_flax_params`).
    """

    def __init__(self, cfg: PointRCNNConfig, in_features: int = 1, norm: str = "layer",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.rpn = PointRCNN_RPN(cfg, in_features, norm=norm, device=_META)
        self.rcnn = PointRCNN_RCNN(cfg, 3 + cfg.fp_width, norm=norm, device=_META)
        _finish(self, device, dtype, generator)

    def forward(self, xyz, features, valid):
        c = self.cfg
        if features is None:
            features = xyz.new_zeros((*xyz.shape[:2], 1))
        rpn_out = self.rpn(xyz, features, valid)
        props = proposal_layer(xyz, rpn_out["cls"], rpn_out["reg"], valid, c)
        rois = props["rois"]
        pooled, counts, empty = roi_pool3d(
            xyz, rpn_out["point_features"], valid, rois,
            num_sampled=c.roi_points, extra_width=c.roi_extra_width,
        )
        canon = canonical_transform(pooled[..., :3], rois)
        roi_pts = torch.cat([canon, pooled[..., 3:]], dim=-1)
        rcnn_out = self.rcnn(roi_pts, counts)
        refined = decode_refined_boxes(rois, rcnn_out["reg"], c.rcnn_coder)
        return {
            "rpn": rpn_out,
            "proposals": props,
            "rcnn": rcnn_out,
            "refined": refined,
            "roi_empty": empty,
        }


def rpn_point_labels(xyz, gt_boxes, gt_valid, extra_width: float = 0.2):
    """Per-point segmentation labels and assigned GT boxes: 1 inside a GT
    box, −1 (ignored) in its margin of ``extra_width``, 0 elsewhere.
    ``xyz (B, N, 3)``, ``gt_boxes (B, G, 7)``, ``gt_valid (B, G)`` →
    ``(labels (B, N) int32, assigned (B, N) int32)``, ``assigned`` the first
    GT box that holds the point (0 for none)."""
    d = xyz[:, None, :, :] - gt_boxes[:, :, None, :3]  # (B, G, N, 3)
    c = torch.cos(gt_boxes[..., 6])[..., None]
    s = torch.sin(gt_boxes[..., 6])[..., None]
    lx = c * d[..., 0] + s * d[..., 1]
    ly = -s * d[..., 0] + c * d[..., 1]

    def member(extra):
        return ((lx.abs() <= (gt_boxes[..., 4] / 2 + extra)[..., None])
                & (ly.abs() <= (gt_boxes[..., 3] / 2 + extra)[..., None])
                & (d[..., 2].abs() <= (gt_boxes[..., 5] / 2 + extra)[..., None])
                & gt_valid[..., None])

    inside = member(0.0)
    fg = inside.any(dim=1)
    ignore = member(extra_width).any(dim=1) & ~fg
    labels = torch.where(fg, 1, torch.where(ignore, -1, 0)).to(torch.int32)
    assigned = inside.to(torch.uint8).argmax(dim=1).to(torch.int32)  # first True, as jnp.argmax
    return labels, assigned


def rpn_loss(rpn_out, xyz, labels, assigned, gt_boxes, cfg: PointRCNNConfig,
             focal_alpha: float = 0.25, focal_gamma: float = 2.0):
    """Per-point focal foreground loss over the cared-for points plus the
    bin regression over the foreground ones, a value per sample:
    ``(total (B,), {"rpn_cls", "rpn_reg", "loc", "head", "size"} (B,))``.
    The denominators ``max(Σ care, 1)`` and ``max(Σ fg, 1)`` are each
    sample's own."""
    care = (labels >= 0).float()
    fg = (labels == 1).float()
    cls_loss = sigmoid_focal_loss(rpn_out["cls"], fg, alpha=focal_alpha, gamma=focal_gamma)
    cls_loss = (cls_loss * care).sum(dim=-1) / torch.clamp(care.sum(dim=-1), min=1.0)
    tgt = encode_bin_targets(xyz, gather_boxes(gt_boxes, assigned), cfg.rpn_coder)
    reg_loss, comps = bin_reg_loss(rpn_out["reg"], tgt, fg, cfg.rpn_coder)
    return cls_loss + reg_loss, {"rpn_cls": cls_loss, "rpn_reg": reg_loss, **comps}


def rcnn_loss(rcnn_out, rois, roi_targets, gt_boxes, cfg: PointRCNNConfig):
    """RCNN binary cross-entropy (foreground target, over the kept RoIs,
    logits floored at −20) plus the bin regression of the assigned GT box in
    each RoI's canonical frame over the sampled foreground, a value per
    sample: ``(total (B,), {"rcnn_cls", "rcnn_reg"} (B,))``."""
    keep = roi_targets["keep"].float()
    fg = roi_targets["fg"].float()
    cls_raw = torch.maximum(rcnn_out["cls"], torch.tensor(-20.0, device=keep.device))
    per = _stable_bce(cls_raw, fg)
    cls_loss = (per * keep).sum(dim=-1) / torch.clamp(keep.sum(dim=-1), min=1.0)

    # Canonical-frame targets: the GT box in each RoI's frame.
    gts = gather_boxes(gt_boxes, roi_targets["assigned_gt"])
    rel = gts[..., :3] - rois[..., :3]
    c, s = torch.cos(-rois[..., 6]), torch.sin(-rois[..., 6])
    canon_gt = torch.cat([
        torch.stack([c * rel[..., 0] - s * rel[..., 1], s * rel[..., 0] + c * rel[..., 1],
                     rel[..., 2]], dim=-1),
        gts[..., 3:6],
        (gts[..., 6] - rois[..., 6])[..., None],
    ], dim=-1)
    tgt = encode_bin_targets(torch.zeros_like(rois[..., :3]), canon_gt, cfg.rcnn_coder)
    reg_loss, _ = bin_reg_loss(rcnn_out["reg"], tgt, fg, cfg.rcnn_coder)
    return cls_loss + reg_loss, {"rcnn_cls": cls_loss, "rcnn_reg": reg_loss}
