"""Plain float32 reference of SECOND / VoxelNet as the two Lyft configurations
run it: voxelize → pillar or mean encoder → pillar scatter or z-slab unit
middle → RPN → heads, the training targets and loss, the ``adam_onecycle``
optimizer, and predict (decode, direction fix, top-k, rotated IoU, greedy
NMS).

It follows the published description as the port implements it (flax's
one-pass LayerNorm and GroupNorm statistics, torch-style symmetric conv
padding, antialiased bilinear resizes, the unit middle's caps), in float32
with no kernel, cache or batching rule of the port's, and imports nothing of
the port. Weights are a dict ``name → tensor`` under the port's parameter
names, made by the benchmark and handed to both sides.

``quant`` (identity by default) rounds the operands of every convolution and
linear layer of the trunk, and ``head_quant`` those of the heads: with
:func:`fake_fp8` and :func:`fake_bf16` the reference becomes the control, one
precision step below the configuration's bfloat16 trunk and float32 heads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.boxes import (
    add_sin_difference,
    box_corners_2d,
    corners_to_standup_2d,
    decode_boxes,
    encode_boxes,
    limit_period,
    rotated_iou_bev,
    standup_iou,
)
from h100bench.reference.units import (
    ActiveSet,
    downsample_units,
    fill_rows_plain,
    strided_conv_units_batched,
    subm_conv_units_batched,
    units_from_voxels,
    units_to_dense_bev,
)
from h100bench.reference.voxelize import VoxelGrid, voxelize

Quant = Callable[[torch.Tensor], torch.Tensor]
FP8_MAX = 448.0  # largest float8_e4m3fn value


def identity(x):
    return x


def _straight_through(x, rounded):
    return x + (rounded - x).detach()


def fake_fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude onto the format's largest value), back in float32; the
    gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return _straight_through(x, (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale)


def fake_bf16(x):
    """``x`` rounded to bfloat16, back in float32 (straight-through gradient)."""
    return _straight_through(x, x.detach().to(torch.bfloat16).float())


@dataclass(frozen=True)
class Anchor:
    size: Tuple[float, float, float]
    z_center: float
    matched_threshold: float
    unmatched_threshold: float
    class_id: int
    rotations: Tuple[float, ...] = (0.0, 1.5707963267948966)


@dataclass(frozen=True)
class SecondConfig:
    grid: VoxelGrid
    max_voxels: int
    max_points_per_voxel: int
    encoder: str  # "pillars" or "simple"
    middle: str  # "scatter" or "sparse_units"
    anchors: Tuple[Anchor, ...]
    rpn_up_strides: Tuple[float, ...]
    encoder_features: Tuple[int, ...] = (64,)
    middle_features: Tuple[int, ...] = (16, 32, 64)
    middle_max_voxels: Tuple[int, ...] = (8192, 4096, 2048)
    middle_z_slab: int = 8
    rpn_layer_nums: Tuple[int, ...] = (3, 5, 5)
    rpn_strides: Tuple[int, ...] = (2, 2, 2)
    rpn_filters: Tuple[int, ...] = (64, 128, 256)
    rpn_up_filters: Tuple[int, ...] = (128, 128, 128)
    num_classes: int = 1
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    dir_weight: float = 0.2
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    nms_pre: int = 1000
    nms_post: int = 300
    nms_iou: float = 0.5
    score_threshold: float = 0.05

    @property
    def sparse(self) -> bool:
        return self.middle == "sparse_units"

    @property
    def feature_hw(self) -> Tuple[int, int]:
        nx, ny, _ = self.grid.grid_size
        h, w = ny, nx
        if self.sparse:
            for _ in self.middle_features:
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        s0 = self.rpn_strides[0]
        h, w = (h + 2 - 3) // s0 + 1, (w + 2 - 3) // s0 + 1
        return int(h * self.rpn_up_strides[0]), int(w * self.rpn_up_strides[0])

    @property
    def anchors_per_loc(self) -> int:
        return sum(len(a.rotations) for a in self.anchors)

    @property
    def final_nz(self) -> int:
        nz = self.grid.grid_size[2]
        for _ in self.middle_features:
            nz = (nz + 2 - 3) // 2 + 1
        return nz


def config_from_experiment(exp: dict) -> SecondConfig:
    """The reference's configuration from the experiment keys of a
    configuration file (the yaml's names)."""
    grid = VoxelGrid(
        point_cloud_range=tuple(exp["point_cloud_range"]), voxel_size=tuple(exp["voxel_size"]),
        block_filtering=exp.get("block_filtering", False), block_factor=exp.get("block_factor", 1),
        block_size=exp.get("block_size", 8), height_threshold=exp.get("height_threshold", 0.2))
    anchors = tuple(
        Anchor(tuple(a["size"]), a["z_center"], a["matched_threshold"], a["unmatched_threshold"], i + 1)
        for i, a in enumerate(exp["anchors"]))
    extra = {k: tuple(exp[k]) for k in ("middle_features", "middle_max_voxels", "encoder_features",
                                        "rpn_layer_nums", "rpn_strides", "rpn_filters", "rpn_up_filters")
             if k in exp}
    return SecondConfig(
        grid=grid, max_voxels=exp["max_voxels"], max_points_per_voxel=exp["max_points_per_voxel"],
        encoder=exp["encoder"], middle=exp.get("middle", "scatter"), anchors=anchors,
        rpn_up_strides=tuple(exp["rpn_up_strides"]), middle_z_slab=exp.get("middle_z_slab", 8), **extra)


# ----------------------------------------------------------------- anchors


def make_anchors(cfg: SecondConfig, device):
    """``(anchors (A, 7), matched (A,), unmatched (A,), class (A,) int32)``,
    position-major ``(y, x, class, rotation)`` as the heads flatten."""
    ny, nx = cfg.feature_hw
    r = cfg.grid.point_cloud_range
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731

    def centres(n, lo, hi):
        i = torch.arange(n, dtype=torch.float32, device=device)
        return (i + 0.5) * f32(hi - lo) / f32(n) + f32(lo)

    gy, gx = torch.meshgrid(centres(ny, r[1], r[4]), centres(nx, r[0], r[3]), indexing="ij")
    per, mt, ut, cls = [], [], [], []
    for a in cfg.anchors:
        rots = f32(tuple(a.rotations))
        k = rots.shape[0]
        cols = [gx[..., None].expand(ny, nx, k), gy[..., None].expand(ny, nx, k)]
        cols += [torch.full((ny, nx, k), float(v), device=device) for v in (a.z_center, *a.size)]
        cols.append(rots.expand(ny, nx, k))
        per.append(torch.stack(cols, dim=-1))
        mt += [a.matched_threshold] * k
        ut += [a.unmatched_threshold] * k
        cls += [a.class_id] * k
    n_loc = ny * nx
    return (torch.stack(per, dim=2).reshape(-1, 7), f32(mt).repeat(n_loc), f32(ut).repeat(n_loc),
            torch.tensor(cls, dtype=torch.int32, device=device).repeat(n_loc))


# ------------------------------------------------------------------- model


def layer_norm(x, weight, bias, eps=1e-6):
    """Over the last dim, flax's one-pass statistics."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def group_norm(x, weight, bias, groups: int, eps=1e-6):
    """NCHW, flax's one-pass statistics."""
    n, c = x.shape[:2]
    xg = x.unflatten(1, (groups, c // groups))
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg * xg).mean(dim=(2, 3, 4), keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xg - mean) * (torch.rsqrt(var + eps) * weight.view(groups, c // groups, 1, 1))
    return (y + bias.view(groups, c // groups, 1, 1)).flatten(1, 2)


def _groups(features: int) -> int:
    for g in (32, 16, 8, 4, 2, 1):
        if features % g == 0:
            return g
    return 1


def resize_to(x, hw):
    """Bilinear, half-pixel centres, antialiased when it shrinks."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    shrink = hw[0] < h or hw[1] < w
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False, antialias=shrink)


def _point_mask(voxels, num_points):
    t = voxels.shape[-2]
    return (torch.arange(t, device=voxels.device) < num_points[..., None]).to(voxels.dtype)


def _voxel_mean(voxels, num_points):
    s = (voxels * _point_mask(voxels, num_points)[..., None]).sum(dim=-2)
    return s / torch.clamp(num_points[..., None], min=1).to(voxels.dtype)


def encode(cfg: SecondConfig, w, voxels, num_points, coords, quant: Quant = identity):
    """``(…, V, C)`` encoder features."""
    voxels = voxels.float()
    if cfg.encoder == "simple":
        return _voxel_mean(voxels, num_points)
    mask = _point_mask(voxels, num_points)
    mean = _voxel_mean(voxels[..., :3], num_points)
    vs, r = cfg.grid.voxel_size, cfg.grid.point_cloud_range
    px = (coords[..., 0].float() + 0.5) * vs[0] + r[0]
    py = (coords[..., 1].float() + 0.5) * vs[1] + r[1]
    pillar_rel = torch.stack([voxels[..., 0] - px[..., None], voxels[..., 1] - py[..., None]], dim=-1)
    x = torch.cat([voxels, voxels[..., :3] - mean[..., None, :], pillar_rel], dim=-1)
    m = mask[..., None]
    for i in range(len(cfg.encoder_features)):
        x = quant(x) @ quant(w[f"encoder.linears.{i}.weight"]).t()
        x = torch.relu(layer_norm(x, w[f"encoder.norms.{i}.weight"], w[f"encoder.norms.{i}.bias"])) * m
    return x.amax(dim=-2)


def _norm_act(w, prefix, out, mask):
    out = layer_norm(out, w[prefix + ".norm.weight"], w[prefix + ".norm.bias"])
    return torch.relu(out) * mask[..., None].to(out.dtype)


def unit_middle(cfg: SecondConfig, w, feats, coords, voxel_valid, quant: Quant = identity,
                record: Optional[list] = None):
    """The z-slab unit middle → ``(B, ny', nx', nz'·C)`` dense BEV.
    ``record`` collects ``(kind, input units, output units, cin, cout)`` for
    every convolution, for the operation counts."""
    nz = cfg.grid.grid_size[2]
    ncs = -(-nz // cfg.middle_z_slab)
    active = ActiveSet(coords=coords, valid=voxel_valid, spatial_shape=cfg.grid.grid_size)
    cols, x = units_from_voxels(feats, active, cfg.middle_z_slab, assume_sorted=True)
    k = 0
    for i, (f, cap) in enumerate(zip(cfg.middle_features, cfg.middle_max_voxels)):
        for _ in range(2):
            kern = w[f"middle.subm.{k}.kernel"]
            out = subm_conv_units_batched(quant(x), cols, quant(kern), ncs)
            x = _norm_act(w, f"middle.subm.{k}", out, cols.mask)
            if record is not None:
                record.append(("subm", cols, cols, kern.shape[1], kern.shape[2]))
            k += 1
        kern = w[f"middle.strided.{i}.kernel"]
        out_cols = downsample_units(cols, ncs, cap)
        out, omask = strided_conv_units_batched(quant(x), cols, out_cols, quant(kern), ncs)
        out_cols = out_cols.replace(mask=omask)
        if record is not None:
            record.append(("strided", cols, out_cols, kern.shape[1], kern.shape[2]))
        x, cols = _norm_act(w, f"middle.strided.{i}", out, omask), out_cols
    return units_to_dense_bev(x, cols, ncs, cfg.final_nz)


def rpn(cfg: SecondConfig, w, x, quant: Quant = identity, head_quant: Quant = identity):
    """NCHW BEV map → heads ``(B, H·W·A, code)`` box, cls, dir."""
    outs, out_hw = [], None
    for i, (n_layers, stride) in enumerate(zip(cfg.rpn_layer_nums, cfg.rpn_strides)):
        for j in range(n_layers + 1):
            p = f"rpn.blocks.{i}.{j}"
            x = F.conv2d(quant(x), quant(w[p + ".conv.weight"]), stride=stride if j == 0 else 1, padding=1)
            x = torch.relu(group_norm(x, w[p + ".norm.weight"], w[p + ".norm.bias"], _groups(x.shape[1])))
        if out_hw is None:
            out_hw = (int(x.shape[-2] * cfg.rpn_up_strides[0]), int(x.shape[-1] * cfg.rpn_up_strides[0]))
        p = f"rpn.ups.{i}"
        u = F.conv2d(quant(x), quant(w[p + ".conv.weight"]))
        u = torch.relu(group_norm(u, w[p + ".norm.weight"], w[p + ".norm.bias"], _groups(u.shape[1])))
        outs.append(resize_to(u, out_hw))
    x = torch.cat(outs, dim=1)
    b = x.shape[0]
    preds = {}
    for name, code in (("box", 7), ("cls", cfg.num_classes), ("dir", 2)):
        h = F.conv2d(head_quant(x), head_quant(w[f"rpn.{name}.weight"]), w[f"rpn.{name}.bias"])
        preds[name] = h.permute(0, 2, 3, 1).reshape(b, -1, code)
    return preds


def forward(cfg: SecondConfig, w, vox, quant: Quant = identity, head_quant: Quant = identity,
            record: Optional[list] = None):
    """The voxelized batch (the dict :func:`voxelize` returns) → heads."""
    feats = encode(cfg, w, vox["voxels"], vox["num_points"], vox["coords"], quant)
    nx, ny, _ = cfg.grid.grid_size
    if cfg.sparse:
        bev = unit_middle(cfg, w, feats, vox["coords"], vox["voxel_valid"], quant, record)
    else:
        flat = vox["coords"][..., 1].long() * nx + vox["coords"][..., 0].long()
        bev = fill_rows_plain(feats, flat, vox["voxel_valid"], ny * nx).unflatten(-2, (ny, nx))
    return rpn(cfg, w, bev.permute(0, 3, 1, 2), quant, head_quant)


def voxelize_batch(cfg: SecondConfig, points, valid):
    return voxelize(points, valid, cfg.grid, cfg.max_voxels, cfg.max_points_per_voxel)


# ------------------------------------------------------- targets and loss


def assign_targets(cfg: SecondConfig, anchors, gt_boxes, gt_classes, gt_valid):
    """Per-anchor targets of one sample ("nearest": standup IoU of the rotated
    corners; class-matched pairs; each GT's best anchor force-matched)."""
    anchors, mt, ut, acls = anchors
    bev = lambda b: torch.cat([b[..., 0:2], b[..., 3:5], b[..., 6:7]], dim=-1)  # noqa: E731
    iou = standup_iou(corners_to_standup_2d(box_corners_2d(bev(anchors))),
                      corners_to_standup_2d(box_corners_2d(bev(gt_boxes))))
    ok = (acls[:, None] == gt_classes[None, :]) & gt_valid[None, :]
    iou = torch.where(ok, iou, -1.0)
    best_iou, best_gt = iou.max(dim=1)
    gt_best_iou, best_anchor = iou.max(dim=0)
    claims = gt_valid & (gt_best_iou > 0.0)
    g = gt_boxes.shape[0]
    forced = torch.full((anchors.shape[0],), -1, dtype=torch.int64, device=anchors.device).scatter_reduce_(
        0, best_anchor, torch.where(claims, torch.arange(g, device=anchors.device), -1), "amax")
    assigned = torch.where(forced >= 0, forced, best_gt)
    pos = (forced >= 0) | (best_iou >= mt)
    neg = (best_iou < ut) & ~pos
    labels = torch.where(pos, gt_classes[assigned].to(torch.int32), torch.where(neg, 0, -1).to(torch.int32))
    matched = gt_boxes[assigned]
    bbox = torch.where(pos[:, None], encode_boxes(matched, anchors), 0.0)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=anchors.device)
    dir_t = torch.remainder(torch.floor((matched[:, 6] - anchors[:, 6]) / pi), 2.0)
    return {"labels": labels, "bbox_targets": bbox, "dir_targets": torch.where(pos, dir_t.long(), 0)}


def _stable_bce(logits, targets):
    abs_x = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, logits.new_zeros(())) - logits * targets + torch.log1p(torch.exp(-abs_x))


def sample_loss(cfg: SecondConfig, preds, tgt):
    """One sample's ``loss = cls + 2·loc + 0.2·dir`` and its terms, each over
    its positives (``num_classes == 1``: the objectness of the anchor's own
    class)."""
    labels = tgt["labels"]
    pos = (labels > 0).float()
    care = (labels >= 0).float()
    num_pos = torch.clamp(pos.sum(), min=1.0)
    logits = preds["cls"][..., 0]
    p = torch.sigmoid(logits)
    t = pos
    p_t = p * t + (1 - p) * (1 - t)
    a_t = cfg.focal_alpha * t + (1 - cfg.focal_alpha) * (1 - t)
    cls = (a_t * torch.pow(1.0 - p_t, cfg.focal_gamma) * _stable_bce(logits, t) * care / num_pos).sum()
    box, bt = preds["box"], tgt["bbox_targets"]
    sp, st = add_sin_difference(box[..., 6], bt[..., 6])
    diff = torch.cat([box[..., :6], sp[..., None]], -1) - torch.cat([bt[..., :6], st[..., None]], -1)
    s2 = 9.0
    ad = diff.abs()
    sl1 = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2).sum(-1)
    loc = (sl1 * pos / num_pos).sum()
    logp = F.log_softmax(preds["dir"], dim=-1)
    ll = torch.gather(logp, -1, tgt["dir_targets"][..., None])[..., 0]
    d = (-ll * pos / num_pos).sum()
    return {"loss": cfg.cls_weight * cls + cfg.loc_weight * loc + cfg.dir_weight * d,
            "cls_loss": cls, "loc_loss": loc, "dir_loss": d}


def batch_loss_and_grads(cfg: SecondConfig, w, batch, anchors, quant: Quant = identity,
                         head_quant: Quant = identity, heads: Optional[list] = None):
    """The batch's mean loss terms (``loss``, ``cls_loss``, ``loc_loss``,
    ``dir_loss``) and the gradient of ``loss`` with respect to every tensor
    of ``w``, one sample at a time (the loss is a mean of per-sample terms
    and no layer mixes samples). Returns ``(terms, grads)``; ``heads``, where
    given, collects each sample's heads."""
    b = batch["points"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    terms: Dict[str, float] = {}
    for i in range(b):
        with torch.no_grad():
            vox = voxelize_batch(cfg, batch["points"][i : i + 1], batch["points_valid"][i : i + 1])
            tgt = assign_targets(cfg, anchors, batch["gt_boxes"][i].float(),
                                 batch["gt_classes"][i].to(torch.int32), batch["gt_valid"][i])
        preds = forward(cfg, leaves, vox, quant, head_quant)
        parts = sample_loss(cfg, {k: v[0] for k, v in preds.items()}, tgt)
        if heads is not None:
            heads.append({k: v[0].detach() for k, v in preds.items()})
        got = torch.autograd.grad(parts["loss"] / b, list(leaves.values()), allow_unused=True)
        for (k, _), g in zip(leaves.items(), got):
            if g is not None:
                grads[k] += g
        for k, v in parts.items():
            terms[k] = terms.get(k, 0.0) + float(v.detach()) / b
    return terms, grads


def batch_loss_of_heads(cfg: SecondConfig, heads: Sequence[dict], batch, anchors) -> float:
    """The batch's mean ``loss`` that the reference's targets (from the batch's
    boxes) and loss give for heads it is handed, one ``{box, cls, dir}`` dict
    a sample: how the reference judges the loss a program reports for its
    own heads."""
    b = batch["points"].shape[0]
    total = 0.0
    for i in range(b):
        with torch.no_grad():
            tgt = assign_targets(cfg, anchors, batch["gt_boxes"][i].float(),
                                 batch["gt_classes"][i].to(torch.int32), batch["gt_valid"][i])
            total += float(sample_loss(cfg, {k: v.float() for k, v in heads[i].items()}, tgt)["loss"]) / b
    return total


# ---------------------------------------------------------------- optimizer


def _cosine_decay(init_value, decay_steps, alpha=0.0):
    def schedule(step):
        count = min(step, decay_steps)
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps)) + alpha)
    return schedule


def one_cycle_lr(lr_max, total_steps, pct_start=0.4, div_factor=10.0, final_div=1e4):
    init = lr_max / div_factor
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = (init, lr_max, lr_max / (div_factor * final_div))

    def schedule(step):
        if step >= bounds[-1]:
            return values[-1]
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= step < hi:
                return (1.0 - math.cos(math.pi * (step - lo) / (hi - lo))) / 2.0 * (end - start) + start
        return 0.0
    return schedule


def one_cycle_b1(total_steps, pct_start=0.4, moms=(0.95, 0.85)):
    up, down = moms
    turn = int(total_steps * pct_start)
    warm = _cosine_decay(up, max(turn, 1), alpha=down / up)
    anneal = _cosine_decay(down, max(total_steps - turn, 1), alpha=up / down)
    return lambda step: warm(step) if step < turn else anneal(step - turn)


class AdamOneCycle:
    """``adam_onecycle``: the weight decay as an L2 term added to the gradient,
    Adam (b2 0.99, eps 1e-8 outside the bias-corrected root), the one-cycle
    learning rate and first moment; no clip (the trainer's configuration
    does not pass one to this optimizer)."""

    def __init__(self, lr_max: float, total_steps: int, weight_decay: float):
        self.lr = one_cycle_lr(lr_max, total_steps)
        self.b1 = one_cycle_b1(total_steps)
        self.b2, self.eps, self.wd = 0.99, 1e-8, weight_decay
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        lr, b1 = self.lr(self.count), self.b1(self.count)
        self.count += 1
        for k, p in w.items():
            g = grads[k] + self.wd * p
            mu = self.mu.setdefault(k, torch.zeros_like(p)).mul_(b1).add_(g, alpha=1.0 - b1)
            nu = self.nu.setdefault(k, torch.zeros_like(p)).mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / (1.0 - b1 ** self.count)) / (torch.sqrt(nu / (1.0 - self.b2 ** self.count)) + self.eps)
            p.add_(-lr * upd)


# ------------------------------------------------------------------ predict


def decode_candidates(cfg: SecondConfig, preds, anchors):
    """One sample's heads → the ``nms_pre`` best candidates in descending score
    (stable): ``(boxes (K, 7), scores (K,), classes (K,))``."""
    boxes = decode_boxes(preds["box"].float(), anchors[0])
    scores = torch.sigmoid(preds["cls"].float()).max(dim=-1).values
    pred_class = anchors[3]
    dir_bit = preds["dir"].argmax(dim=-1)
    yaw = boxes[..., 6]
    pi = torch.tensor(math.pi, dtype=yaw.dtype, device=yaw.device)
    anchor_bit = torch.remainder(torch.floor((yaw - anchors[0][:, 6]) / pi), 2.0)
    yaw = torch.where(dir_bit != anchor_bit.to(dir_bit.dtype), yaw + pi, yaw)
    boxes = torch.cat([boxes[..., :6], limit_period(yaw, 0.5, 2 * math.pi)[..., None]], dim=-1)
    k = min(cfg.nms_pre, scores.shape[-1])
    top, idx = torch.sort(scores, descending=True, stable=True)
    return boxes[idx[:k]], top[:k], pred_class[idx[:k]]


NMS_TIE = 1e-4  # IoUs this close to the threshold may fall either way (a rotated-IoU kernel's tolerance)


def greedy_nms(iou: np.ndarray, valid: np.ndarray, thr: float, tie: float, prefer=None):
    """Greedy NMS over candidates in descending score: keep ``i`` unless a kept
    ``j < i`` overlaps it by more than ``thr``. A decision that an IoU within
    ``tie`` of the threshold settles takes ``prefer[i]`` where it is not
    ``None`` (the program's own decision). Returns ``(keep, near_ties)``."""
    n = len(valid)
    keep = np.zeros(n, bool)
    near_ties = 0
    for i in range(n):
        if not valid[i]:
            continue
        over = iou[keep, i]
        sup = bool((over > thr).any())
        if bool((over > thr + tie).any()) != bool((over > thr - tie).any()):
            near_ties += 1
            if prefer is not None and prefer[i] is not None:
                sup = not prefer[i]
        keep[i] = not sup
    return keep, near_ties


def _program_decisions(cfg: SecondConfig, det, boxes, scores):
    """What the program's detections say of each candidate: kept (a valid
    slot), not kept (an invalid slot centred inside the range), or nothing."""
    prefer = [None] * len(scores)
    cand_s, cand_b = scores.cpu().numpy(), boxes.cpu().numpy()
    r = cfg.grid.point_cloud_range
    for b, s, v in zip(det["boxes"], det["scores"], det["valid"]):
        near = np.flatnonzero((np.abs(cand_s - s) <= 1e-6)
                              & (np.abs(cand_b - b) <= 1e-4 * (1 + np.abs(b))).all(-1))
        inside = r[0] <= b[0] <= r[3] and r[1] <= b[1] <= r[4]
        if len(near) == 1 and (v or inside):
            prefer[near[0]] = bool(v)
    return prefer


def predict_one(cfg: SecondConfig, preds, anchors, tie: float = NMS_TIE, program=None):
    """One sample's heads → the detections ``voxelnet_predict`` defines
    (``nms_post`` slots: the kept candidates in score order, then the others,
    ``valid`` = kept and centred inside the range), and how many decisions
    fell within ``tie`` of the threshold. ``program``: the program's
    detections of the sample, whose decisions settle those."""
    boxes, scores, classes = decode_candidates(cfg, preds, anchors)
    valid = (scores >= cfg.score_threshold).cpu().numpy()
    bev = torch.cat([boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6:7]], dim=-1)
    iou = rotated_iou_bev(bev, bev).cpu().numpy()
    prefer = _program_decisions(cfg, program, boxes, scores) if program is not None else None
    keep, near_ties = greedy_nms(iou, valid, cfg.nms_iou, tie, prefer)
    order = np.concatenate([np.flatnonzero(keep), np.flatnonzero(~keep)])[: min(cfg.nms_post, len(keep))]
    sel = torch.from_numpy(order).to(boxes.device)
    out_boxes = boxes[sel]
    r = cfg.grid.point_cloud_range
    inside = ((out_boxes[:, 0] >= r[0]) & (out_boxes[:, 0] <= r[3])
              & (out_boxes[:, 1] >= r[1]) & (out_boxes[:, 1] <= r[4])).cpu().numpy()
    return {"boxes": out_boxes.cpu().numpy(), "scores": scores[sel].cpu().numpy(),
            "classes": classes[sel].cpu().numpy(), "valid": keep[order] & inside}, near_ties


def detection_mismatches(got: dict, want: dict, box_tol: float = 1e-4, score_tol: float = 1e-6) -> int:
    """Slots where two detection lists of one sample disagree: in ``valid``, or,
    where both are valid, in class, score or box."""
    valid_g, valid_w = np.asarray(got["valid"], bool), np.asarray(want["valid"], bool)
    both = valid_g & valid_w
    box_bad = (np.abs(got["boxes"] - want["boxes"]) > box_tol * (1.0 + np.abs(want["boxes"]))).any(-1)
    bad = ((valid_g != valid_w)
           | (both & (np.asarray(got["classes"]) != np.asarray(want["classes"])))
           | (both & (np.abs(got["scores"] - want["scores"]) > score_tol))
           | (both & box_bad))
    return int(bad.sum())


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keys: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's ``|got − want| / max(want, median of want)`` over
    ``keys``, and its name."""
    med = float(np.median([want[k] for k in keys])) if keys else 0.0
    worst, name = 0.0, ""
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, name = gap, k
    return worst, name


def rms_gap(got, want) -> float:
    """``rms(got − want) / std(want)``."""
    want = want.float()
    return float(torch.sqrt(((got.float() - want) ** 2).mean()) / want.std().clamp(min=1e-30))


__all__: List[str] = [
    "SecondConfig", "config_from_experiment", "make_anchors", "forward", "voxelize_batch",
    "assign_targets", "sample_loss", "batch_loss_and_grads", "batch_loss_of_heads", "AdamOneCycle", "predict_one",
    "detection_mismatches", "leaf_gap", "rms_gap", "fake_fp8", "fake_bf16", "identity",
]
