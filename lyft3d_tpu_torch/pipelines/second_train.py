"""SECOND / VoxelNet training loop (port of the training half of
``lyft3d_tpu/pipelines/second_train.py``): config → model, optimizer and
trainer → step loop with resilient checkpointing. One step runs the
voxelization, the anchor masks, the target assignment, the network and the
loss on the model's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from lyft3d_tpu_torch.config import SecondExperiment, snapshot_config
from lyft3d_tpu_torch.data.prefetch import MappedPrefetcher
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig, voxelnet_loss
from lyft3d_tpu_torch.ops.anchors import (
    anchors_area_mask,
    assign_targets,
    assign_targets_pruned,
    bev_occupancy_mask,
)
from lyft3d_tpu_torch.ops.box_ops import box_corners_2d, corners_to_standup_2d
from lyft3d_tpu_torch.ops.voxelize import voxelize
from lyft3d_tpu_torch.pipelines.second import evaluate_second, voxelnet_config_from_experiment
from lyft3d_tpu_torch.pipelines.second_pipeline import SecondSampleLoader
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "voxelnet_config_from_experiment",
    "make_second_targets_fn",
    "make_second_loss_fn",
    "train_second",
    "evaluate_second",
]


def _training_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device found (pass device='cpu' to run on the CPU)")
    return device


def make_second_targets_fn(vcfg: VoxelNetConfig, device="cuda") -> Callable:
    """``targets(batch) -> (vox, targets)`` on ``device``: the voxelized batch
    and the per-anchor targets, under ``torch.no_grad()`` (neither carries a
    gradient). ``batch``: points ``(B, N, D)``, points_valid ``(B, N)``,
    gt_boxes ``(B, G, 7)``, gt_classes ``(B, G)``, gt_valid ``(B, G)``.
    ``device`` defaults to the card; pass ``"cpu"`` to run without one."""
    device = _training_device(device, "make_second_targets_fn")
    anchors, mt, ut, acls = vcfg.make_anchors(device)
    abev = torch.cat([anchors[:, 0:2], anchors[:, 3:5], anchors[:, 6:7]], dim=-1)
    anchor_standup = corners_to_standup_2d(box_corners_2d(abev))
    nx, ny, _ = vcfg.grid.grid_size

    @torch.no_grad()
    def targets_fn(batch):
        vox = voxelize(batch["points"], batch["points_valid"], vcfg.grid, vcfg.max_voxels,
                       vcfg.max_points_per_voxel)
        amask = None
        if vcfg.anchor_area_threshold > 0:
            # Don't-care anchors over empty BEV area.
            amask = anchors_area_mask(
                anchor_standup, bev_occupancy_mask(vox["coords"], vox["voxel_valid"], (ny, nx)),
                vcfg.grid.point_cloud_range, min_area=vcfg.anchor_area_threshold)
        gt = (batch["gt_boxes"].float(), batch["gt_classes"].to(torch.int32), batch["gt_valid"])
        if vcfg.similarity == "rotated" and vcfg.anchor_area_threshold > 0:
            # Rotated IoU is affordable only on the mask-pruned anchor subset.
            tgts = assign_targets_pruned(anchors, acls, mt, ut, *gt, amask,
                                         max_active=vcfg.max_active_anchors, similarity="rotated")
        else:
            tgts = assign_targets(anchors, acls, mt, ut, *gt, anchor_mask=amask,
                                  similarity=vcfg.similarity)
        return vox, tgts

    return targets_fn


def make_second_loss_fn(vcfg: VoxelNetConfig, device="cuda") -> Callable:
    """``loss_fn(model, batch, generator) -> (loss, metrics)`` for the
    :class:`~lyft3d_tpu_torch.train.trainer.Trainer`; ``device`` is where the
    anchors live (the model's): the card by default, ``"cpu"`` to run without
    one. The generator is not used (no dropout)."""
    targets_fn = make_second_targets_fn(vcfg, _training_device(device, "make_second_loss_fn"))

    def loss_fn(model, batch, generator=None):
        vox, tgts = targets_fn(batch)
        preds = model(vox["voxels"], vox["num_points"], vox["coords"], vox["voxel_valid"])
        return voxelnet_loss(preds, tgts, vcfg)

    return loss_fn


def train_second(exp: SecondExperiment, loader: SecondSampleLoader, train_tokens: Sequence[str],
                 vcfg: Optional[VoxelNetConfig] = None, log_every: int = 50, num_workers: int = 4,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Train SECOND on ``train_tokens``; returns ``(state, model, vcfg)``.
    ``device`` defaults to the card; pass ``"cpu"`` (with float32) to run
    without one."""
    device = _training_device(device, "train_second")
    vcfg = vcfg or voxelnet_config_from_experiment(exp)
    sample0 = loader.batch(list(train_tokens)[: exp.batch_size])
    model = VoxelNet(vcfg, in_features=sample0["points"].shape[-1], dtype=dtype, device=device,
                     generator=torch.Generator().manual_seed(0))

    opt = exp.optimizer
    tcfg = TrainerConfig(
        model_dir=exp.model_dir, total_steps=opt.total_steps, log_every=log_every,
        eval_every=0, ckpt_every=max(opt.total_steps // 4, 1),
    )
    snapshot_config(exp, exp.model_dir)
    trainer = Trainer(
        model,
        lambda params: build_optimizer(
            params, opt.name, opt.lr, total_steps=opt.total_steps, weight_decay=opt.weight_decay,
            clip_norm=opt.clip_norm, grad_accum=opt.grad_accum),
        make_second_loss_fn(vcfg, device), tcfg,
    )
    state = trainer.init_or_resume()

    def token_chunks():
        rng = np.random.RandomState(exp.data.seed)
        toks = list(train_tokens)
        while True:
            rng.shuffle(toks)
            for i in range(0, len(toks) - exp.batch_size + 1, exp.batch_size):
                yield toks[i : i + exp.batch_size]

    def assemble(chunk):
        b = loader.batch(chunk, train=True)
        return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}

    # Work items are cheap token chunks; the heavy sample assembly (multi-sweep
    # load and augmentation) runs on parallel workers.
    state = trainer.fit(
        state, iter(MappedPrefetcher(token_chunks, assemble, num_workers=num_workers, depth=4)))
    return state, model, vcfg
