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
from torch import nn

from lyft3d_tpu_torch.config import SecondExperiment, snapshot_config
from lyft3d_tpu_torch.data.prefetch import MappedPrefetcher
from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig, voxelnet_loss
from lyft3d_tpu_torch.ops.anchors import (
    anchors_area_mask,
    assign_targets,
    assign_targets_pruned,
    bev_occupancy_mask,
)
from lyft3d_tpu_torch.ops.box_ops import box_corners_2d, corners_to_standup_2d
from lyft3d_tpu_torch.ops.voxelize import voxelize
from lyft3d_tpu_torch.parallel.mesh import (
    DataGroup,
    make_data_group,
    rank_placement,
    reseed_for_rank,
    shard_batch,
    spawn,
)
from lyft3d_tpu_torch.pipelines.second import evaluate_second, voxelnet_config_from_experiment
from lyft3d_tpu_torch.pipelines.second_pipeline import SecondSampleLoader
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig
from lyft3d_tpu_torch.utils.profiler import span

__all__ = [
    "voxelnet_config_from_experiment",
    "batch_stats_as_parameters",
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


@torch.no_grad()
def batch_stats_as_parameters(model: nn.Module) -> nn.Module:
    """Make every BatchNorm of ``model`` train as the JAX SECOND trainer trains
    a ``middle_norm="batch"`` middle; returns ``model``, changed in place.

    The JAX trainer applies the model to its whole variable tree with no
    mutable collection and differentiates that tree: each BatchNorm
    normalises with its running statistics in the training step too, and
    the optimizer updates those statistics from their gradients as it updates
    the parameters (ROADMAP §C). So here the running statistics become
    float32 parameters (same names, same state-dict keys) and the modules
    keep to them in train mode (``use_running_average``). Call it before the
    :class:`~lyft3d_tpu_torch.train.trainer.Trainer` collects the parameters."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.use_running_average = True
            for name in ("running_mean", "running_var"):
                setattr(m, name, nn.Parameter(getattr(m, name).detach().float()))
    return model


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
        with span("targets"):
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
        with span("forward"):
            preds = model(vox["voxels"], vox["num_points"], vox["coords"], vox["voxel_valid"])
        with span("loss"):
            return voxelnet_loss(preds, tgts, vcfg)

    return loss_fn


def _second_trainer(exp: SecondExperiment, vcfg: VoxelNetConfig, in_features: int, log_every: int,
                    dtype: torch.dtype, device, group: Optional[DataGroup] = None) -> Trainer:
    model = VoxelNet(vcfg, in_features=in_features, dtype=dtype, device=device,
                     generator=torch.Generator().manual_seed(0))
    batch_stats_as_parameters(model)  # a "batch" unit middle's; no other norm is a BatchNorm
    opt = exp.optimizer
    tcfg = TrainerConfig(
        model_dir=exp.model_dir, total_steps=opt.total_steps, log_every=log_every,
        eval_every=0, ckpt_every=max(opt.total_steps // 4, 1),
    )
    return Trainer(
        model,
        lambda params: build_optimizer(
            params, opt.name, opt.lr, total_steps=opt.total_steps, weight_decay=opt.weight_decay,
            clip_norm=opt.clip_norm, grad_accum=opt.grad_accum),
        make_second_loss_fn(vcfg, device), tcfg, group=group,
    )


def _fit_second(group: Optional[DataGroup], exp: SecondExperiment, loader: SecondSampleLoader,
                train_tokens: Sequence[str], vcfg: VoxelNetConfig, in_features: int, log_every: int,
                num_workers: int, dtype: torch.dtype, device=None):
    """The step loop of :func:`train_second` on one rank (``group``) or alone
    (``group=None``, on ``device``); returns ``(state, model)``."""
    device = group.device if group is not None else device
    loader = reseed_for_rank(loader, group)
    if group is None or group.rank == 0:
        snapshot_config(exp, exp.model_dir)
    trainer = _second_trainer(exp, vcfg, in_features, log_every, dtype, device, group)
    state = trainer.init_or_resume()

    def token_chunks():
        rng = np.random.RandomState(exp.data.seed)
        toks = list(train_tokens)
        while True:
            rng.shuffle(toks)
            for i in range(0, len(toks) - exp.batch_size + 1, exp.batch_size):
                yield toks[i : i + exp.batch_size]

    def assemble(chunk):
        # Every rank walks the same schedule of global batches and loads its
        # own slice of each.
        b = loader.batch(shard_batch(group, chunk), train=True)
        return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}

    # Work items are cheap token chunks; the heavy sample assembly (multi-sweep
    # load and augmentation) runs on parallel workers.
    state = trainer.fit(
        state, iter(MappedPrefetcher(token_chunks, assemble, num_workers=num_workers, depth=4)))
    return state, trainer.model


def _second_rank(group: DataGroup, *args):
    _fit_second(group, *args)


def train_second(exp: SecondExperiment, loader: SecondSampleLoader, train_tokens: Sequence[str],
                 vcfg: Optional[VoxelNetConfig] = None, n_devices: Optional[int] = None,
                 log_every: int = 50, num_workers: int = 4, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", backend: Optional[str] = None):
    """Train SECOND on ``train_tokens``; returns ``(state, model, vcfg)``.
    ``device`` defaults to the card; pass ``"cpu"`` (with float32) to run
    without one.

    ``n_devices``: data parallelism as the JAX trainer's, over
    :func:`~lyft3d_tpu_torch.parallel.mesh.make_data_group`'s rank count
    (``None``: every card, one rank on the CPU; the largest divisor of the
    batch size up to it). More than one rank spawns a process a rank, each
    loading its slice of every global batch; rank 0 writes the checkpoints,
    and the state returned here is restored from the last of them.
    ``backend="gloo"`` runs the ranks on one card, the one ``device`` names
    (:func:`~lyft3d_tpu_torch.parallel.mesh.rank_placement`)."""
    device = _training_device(device, "train_second")
    vcfg = vcfg or voxelnet_config_from_experiment(exp)
    sample0 = loader.batch(list(train_tokens)[: exp.batch_size])
    args = (exp, loader, list(train_tokens), vcfg, sample0["points"].shape[-1], log_every, num_workers,
            dtype)
    n = make_data_group(exp.batch_size, n_devices, device, backend)
    if n == 1:
        state, model = _fit_second(None, *args, device=device)
        return state, model, vcfg
    spawn(_second_rank, n, args=args, **rank_placement(device, backend))
    trainer = _second_trainer(exp, vcfg, args[4], log_every, dtype, device)
    return trainer.init_or_resume(), trainer.model, vcfg
