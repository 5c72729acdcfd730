"""SECOND / VoxelNet inference (pillars and sparse middles): points → voxelize → VoxelNet →
decode + NMS → world records (port of the inference half of
``lyft3d_tpu/pipelines/second_train.py``).

The device program is :func:`make_second_infer_fn`. The host side is the
port's numpy ``SecondSampleLoader`` and ``detections_to_world_records``
(:mod:`lyft3d_tpu_torch.pipelines.second_pipeline`). Training comes with its
own port.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from lyft3d_tpu_torch.pipelines.second_pipeline import SecondSampleLoader, detections_to_world_records
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig, voxelnet_predict
from lyft3d_tpu_torch.ops.anchors import AnchorSpec
from lyft3d_tpu_torch.ops.voxelize import VoxelGrid, voxelize
from lyft3d_tpu_torch.pipelines.bev import to_host
from lyft3d_tpu_torch.utils.profiler import SectionTimers

__all__ = ["voxelnet_config_from_experiment", "make_second_infer_fn", "evaluate_second"]


def voxelnet_config_from_experiment(exp, **overrides) -> VoxelNetConfig:
    """``VoxelNetConfig`` from a ``SecondExperiment`` (read by field name, so
    no yaml-backed config module is needed here)."""
    grid = VoxelGrid(
        point_cloud_range=tuple(exp.point_cloud_range),
        voxel_size=tuple(exp.voxel_size),
        block_filtering=exp.block_filtering,
        block_factor=exp.block_factor,
        block_size=exp.block_size,
        height_threshold=exp.height_threshold,
    )
    specs = tuple(
        AnchorSpec(
            size=tuple(a.size),
            z_center=a.z_center,
            matched_threshold=a.matched_threshold,
            unmatched_threshold=a.unmatched_threshold,
            class_id=i + 1,
        )
        for i, a in enumerate(exp.anchors)
    )
    kwargs = dict(
        grid=grid,
        max_voxels=exp.max_voxels,
        max_points_per_voxel=exp.max_points_per_voxel,
        encoder=exp.encoder,
        middle=exp.middle,
        middle_features=tuple(exp.middle_features),
        middle_max_voxels=tuple(exp.middle_max_voxels),
        middle_norm=exp.middle_norm,
        middle_z_slab=exp.middle_z_slab,
        similarity=exp.similarity,
        anchor_specs=specs,
        rpn_layer_nums=tuple(exp.rpn_layer_nums),
        rpn_strides=tuple(exp.rpn_strides),
        rpn_filters=tuple(exp.rpn_filters),
        rpn_up_strides=tuple(exp.rpn_up_strides),
        rpn_up_filters=tuple(exp.rpn_up_filters),
    )
    kwargs.update(overrides)
    return VoxelNetConfig(**kwargs)


def make_second_infer_fn(model: VoxelNet, vcfg: VoxelNetConfig) -> Callable:
    """Batched points → detections program on the model's device.

    ``infer(points (B, N, D), valid (B, N))`` → dict of ``(B, K, …)``
    detections (see :func:`voxelnet_predict`). The model is put in eval mode.
    """
    model.eval()
    device = next(model.parameters()).device
    anchors, _, _, anchor_class = vcfg.make_anchors(device)

    @torch.inference_mode()
    def infer(points, valid):
        vox = voxelize(points, valid, vcfg.grid, vcfg.max_voxels, vcfg.max_points_per_voxel)
        preds = model(vox["voxels"], vox["num_points"], vox["coords"], vox["voxel_valid"])
        return voxelnet_predict(preds, anchors, anchor_class, vcfg)

    return infer


def evaluate_second(
    model: VoxelNet,
    vcfg: VoxelNetConfig,
    loader: SecondSampleLoader,
    tokens: Sequence[str],
    class_names: Sequence[str],
    measure_time: bool = False,
    batch_size: int = 4,
) -> List[dict]:
    """Predict over ``tokens`` → world-frame detection records, in
    fixed-size batches (the last one padded by repeating its final token)
    with one device→host copy per batch. With ``measure_time`` prints the
    seconds an example and each section's average ms (``prep``, ``infer``
    up to the card's finish, ``postprocess``), the reference's ``evaluate
    --measure_time=True`` mode."""
    infer = make_second_infer_fn(model, vcfg)
    device = next(model.parameters()).device
    timers = SectionTimers(enabled=measure_time)
    records: List[dict] = []
    toks = list(tokens)
    for i in range(0, len(toks), batch_size):
        chunk = toks[i : i + batch_size]
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        with timers.section("prep"):
            samples = [loader.sample(t, train=False) for t in padded]
            pts, valid = (torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
                          for k in ("points", "points_valid"))
        with timers.section("infer") as t:
            det = infer(pts, valid)
            t.set_sentinel(det["scores"])
        with timers.section("postprocess"):
            det = to_host(det)
            for j, tok in enumerate(chunk):
                records.extend(
                    detections_to_world_records(
                        loader.infos[tok], det["boxes"][j], det["scores"][j],
                        det["classes"][j], det["valid"][j], class_names,
                    )
                )
    if measure_time:
        total = sum(timers.totals.values())
        print(f"sec_per_example: {total / max(len(toks), 1):.4f} ({timers.report()})")
    return records
