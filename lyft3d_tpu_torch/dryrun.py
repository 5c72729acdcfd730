"""The port's counterpart of the JAX package's ``__graft_entry__.py``:
:func:`entry`, the flagship's forward on the card,
and :func:`dryrun_multichip`, one training step of each model family over
ranks, each held to the same step in one process.

``dryrun_multichip(n)`` runs the JAX dry run's six stages at its shapes and
configurations, on inputs drawn from ``np.random.RandomState(0)`` in its
order:

1. ``unet DP``: ``unet_reference`` (``wf=3``, ``depth=2``, 10 classes) on
   one 32 x 32 x 6 image a rank, ``ranger`` (lr 1e-3, weight decay 1e-4,
   clip 5.0) on ``bev_segmentation_loss``;
2. ``conv TP`` (n ≥ 4 and even): the ``TPConvStack`` (128, 128, 10
   features) with its 128-wide kernels sharded over a model axis of 2,
   Adam 1e-3, on a ``(n/2) x 2`` layout;
3. ``voxelnet pillars DP``: a pillars ``VoxelNet`` on 512 points a rank;
4. ``voxelnet unit-sparse DP``: the z-slab unit middle (``max_voxels=128``,
   ``middle_z_slab=2``, ``middle_features=(4, 8)``) on 256 points a rank;
5. ``pointrcnn rpn DP``: the PointRCNN RPN (``sa_npoints=(16, 8)``) on 64
   points a rank;
6. ``pointrcnn rcnn DP``: the RCNN on 4 RoIs of 16 points a rank, targets
   from ``proposal_target_layer``.

Stages 3-6 take Adam 1e-3. All six run in one :func:`~lyft3d_tpu_torch.parallel.mesh.spawn`:
NCCL with a card a rank where there are n cards, else n gloo ranks sharing
``cuda:0``; with ``device="cpu"``, n gloo ranks on the CPU. Rank 0 runs
each stage's step again alone on the global batch and holds the ranks to
it (in float32 with TF32 off, on both sides): the loss within 1e-5 relative, the averaged gradients within
:data:`GRAD_NORM_TOL` in the 2-norm, and every rank's weights bit-equal to
rank 0's. A stage that fails raises.

    python -m lyft3d_tpu_torch.dryrun 4             # four ranks on the cards
    python -m lyft3d_tpu_torch.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["entry", "dryrun_multichip", "STAGES", "stage_model", "stage_step", "launch_counts",
           "tp_conv_stack", "tp_stack_loss"]

STAGES = ("unet", "tp", "pillars", "sparse", "rpn", "rcnn")
NAMES = {"unet": "unet DP", "tp": "conv TP", "pillars": "voxelnet pillars DP",
         "sparse": "voxelnet unit-sparse DP", "rpn": "pointrcnn rpn DP", "rcnn": "pointrcnn rcnn DP"}
# The head of each stage's line, as the JAX dry run prints it.
HEADS = {"unet": "unet", "pillars": "voxelnet", "sparse": "voxelnet unit-sparse", "rpn": "pointrcnn rpn",
         "rcnn": "pointrcnn rcnn"}
UNET_HW, N_CLASSES = 32, 10
TP_MODEL_PARALLEL, TP_MIN_FEATURES = 2, 128
PILLAR_POINTS, SPARSE_POINTS, RPN_POINTS = 512, 256, 64
ROIS, ROI_POINTS = 4, 16
LR = 1e-3
# The averaged gradients against one process's, in the 2-norm (the bound of
# the card-vs-CPU gradient checks of chip_smoke.py, where ReLU inputs within
# rounding of 0 flip with the order of a float32 sum).
GRAD_NORM_TOL = 0.15
LOSS_TOL = 1e-5
KERNELS = ("bev_raster", "dense_fill", "dense_fill_bwd", "stencil_conv", "stencil_dgrad", "stencil_wgrad",
           "subm_conv", "subm_dgrad", "subm_wgrad", "fps", "ball_query", "knn", "roi_select")


def entry(device=None):
    """``(fn, (model, x))``: the forward of ``unet_seresnext101`` (10
    classes, seeded weights) on a ``1 x 336 x 336 x 6`` zero input, on the
    card unless ``device`` says otherwise; ``fn(model, x)`` gives the logits."""
    from lyft3d_tpu_torch.models import build_model

    device = _device(device, "entry")
    model = build_model("unet_seresnext101", n_classes=N_CLASSES, device=device,
                        generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(1, 336, 336, 6, device=device)

    def fn(model, x):
        with torch.no_grad():
            return model(x)[0]

    return fn, (model, x)


def _device(device, what) -> torch.device:
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device found (pass device='cpu' to run on the CPU)")
    return device


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Every kernel launch count of the port (:data:`KERNELS`); ``reset``
    sets them to 0 first."""
    from lyft3d_tpu_torch.ops import bev_raster, dense_fill, pointnet2, subm_conv_kernel
    from lyft3d_tpu_torch.ops import column_sparse as cs

    modules = {"bev_raster": (bev_raster, "KERNEL_LAUNCHES"), "dense_fill": (dense_fill, "KERNEL_LAUNCHES"),
               "dense_fill_bwd": (dense_fill, "BWD_KERNEL_LAUNCHES"), "stencil_conv": (cs, "KERNEL_LAUNCHES"),
               "stencil_dgrad": (cs, "DGRAD_KERNEL_LAUNCHES"), "stencil_wgrad": (cs, "WGRAD_KERNEL_LAUNCHES"),
               "subm_conv": (subm_conv_kernel, "KERNEL_LAUNCHES"),
               "subm_dgrad": (subm_conv_kernel, "DGRAD_KERNEL_LAUNCHES"),
               "subm_wgrad": (subm_conv_kernel, "WGRAD_KERNEL_LAUNCHES")}
    if reset:
        for module, attr in modules.values():
            setattr(module, attr, 0)
        for name in pointnet2.KERNEL_LAUNCHES:
            pointnet2.KERNEL_LAUNCHES[name] = 0
    return {**{k: getattr(m, a) for k, (m, a) in modules.items()}, **pointnet2.KERNEL_LAUNCHES}


# ------------------------------------------------------------------ models


def tp_conv_stack(device=None, dtype=None, generator=None) -> nn.Module:
    """The dry run's ``TPConvStack``: two 3x3 convs of 128 features with
    ReLU, then a 1x1 conv to 10 classes (flax ``"SAME"`` pads, biases), NCHW
    on 6 channels."""
    from lyft3d_tpu_torch.models.layers import init_params

    fk = dict(device=device, dtype=dtype)
    model = nn.Sequential(nn.Conv2d(6, 128, 3, padding=1, **fk), nn.ReLU(),
                          nn.Conv2d(128, 128, 3, padding=1, **fk), nn.ReLU(), nn.Conv2d(128, 10, 1, **fk))
    if generator is not None:
        init_params(model, generator)
    return model


def tp_stack_loss(model, batch):
    """The dry run's TP loss: the mean over pixels of the one-hot cross-entropy
    of ``model(image)`` (``image`` NHWC, ``label`` (B, H, W))."""
    logp = F.log_softmax(model(batch["image"].permute(0, 3, 1, 2)), dim=1)
    return -logp.gather(1, batch["label"][:, None].long()).mean()


def _anchor():
    from lyft3d_tpu_torch.ops.anchors import AnchorSpec

    return (AnchorSpec(size=(2.0, 4.0, 1.6), z_center=0.0, matched_threshold=0.5, unmatched_threshold=0.35),)


def pillars_config():
    """Stage 3's pillars ``VoxelNetConfig`` (``__graft_entry__.py:194-203``)."""
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNetConfig
    from lyft3d_tpu_torch.ops.voxelize import VoxelGrid

    return VoxelNetConfig(
        grid=VoxelGrid(point_cloud_range=(-16, -16, -3, 16, 16, 5), voxel_size=(1.0, 1.0, 8.0)),
        max_voxels=256, max_points_per_voxel=4, encoder="pillars", encoder_features=(16,),
        rpn_layer_nums=(1, 1), rpn_strides=(2, 2), rpn_filters=(16, 32), rpn_up_strides=(1, 2),
        rpn_up_filters=(16, 16), anchor_specs=_anchor())


def sparse_config():
    """Stage 4's unit-sparse ``VoxelNetConfig`` (``__graft_entry__.py:262-273``)."""
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNetConfig
    from lyft3d_tpu_torch.ops.voxelize import VoxelGrid

    return VoxelNetConfig(
        grid=VoxelGrid(point_cloud_range=(-8, -8, -2, 8, 8, 2), voxel_size=(0.5, 0.5, 1.0)),
        max_voxels=128, max_points_per_voxel=1, encoder="simple", middle="sparse_units", middle_z_slab=2,
        middle_features=(4, 8), middle_max_voxels=(128, 64), rpn_layer_nums=(1,), rpn_strides=(1,),
        rpn_filters=(16,), rpn_up_strides=(1,), rpn_up_filters=(16,), anchor_specs=_anchor())


def rpn_config():
    """Stage 5's ``PointRCNNConfig`` (``__graft_entry__.py:341-344``)."""
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNNConfig

    return PointRCNNConfig(sa_npoints=(16, 8), sa_radii=((2.0,), (4.0,)), sa_nsamples=((8,), (8,)),
                           sa_widths=(8, 16), fp_width=8)


def rcnn_config():
    """Stage 6's ``PointRCNNConfig`` (``__graft_entry__.py:399-402``)."""
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNNConfig

    return PointRCNNConfig(rcnn_sa_npoints=(8, 4), rcnn_widths=(8, 16), rcnn_sa_radii=(2.0, 4.0),
                           rcnn_sa_nsamples=(4, 4), roi_points=ROI_POINTS)


def stage_model(stage: str, device="cpu", seed: int = 0) -> nn.Module:
    """The float32 model of ``stage`` on ``device``, weights from a generator
    seeded ``seed``."""
    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNN_RCNN, PointRCNN_RPN
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet

    kw = dict(device=device, generator=torch.Generator().manual_seed(seed))
    if stage == "unet":
        return build_model("unet_reference", n_classes=N_CLASSES, wf=3, depth=2, dtype=torch.float32, **kw)
    if stage == "tp":
        return tp_conv_stack(**kw)
    if stage in ("pillars", "sparse"):
        return VoxelNet(pillars_config() if stage == "pillars" else sparse_config(), in_features=4, **kw)
    if stage == "rpn":
        return PointRCNN_RPN(rpn_config(), in_features=1, **kw)
    if stage == "rcnn":
        return PointRCNN_RCNN(rcnn_config(), in_features=5, **kw)
    raise KeyError(stage)


def _optimizer(stage, params):
    from lyft3d_tpu_torch.train.optim import build_optimizer

    if stage == "unet":
        return build_optimizer(params, "ranger", LR, total_steps=10, weight_decay=1e-4, clip_norm=5.0)
    return build_optimizer(params, "adam", LR)


def _loss_fn(stage, model, device, group):
    """``loss(batch)``: the stage's loss on a batch (this rank's shard under
    ``group``), a value whose mean over the ranks is the global batch's."""
    from lyft3d_tpu_torch.models.pointrcnn.net import rcnn_loss, rpn_loss, rpn_point_labels
    from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn
    from lyft3d_tpu_torch.train.losses import bev_segmentation_loss

    if stage == "unet":
        return lambda b: bev_segmentation_loss(*model(b["image"]), b["label"], group=group)[0]
    if stage == "tp":
        return lambda b: tp_stack_loss(model, b)
    if stage in ("pillars", "sparse"):
        second = make_second_loss_fn(pillars_config() if stage == "pillars" else sparse_config(), device)
        return lambda b: second(model, b)[0]
    if stage == "rpn":
        cfg = rpn_config()

        def rpn(b):
            xyz, gt = b["points"], b["gt_boxes"]
            labels, assigned = rpn_point_labels(xyz, gt, b["gt_valid"])
            out = model(xyz, xyz.new_zeros((*xyz.shape[:2], 1)), b["points_valid"])
            return rpn_loss(out, xyz, labels, assigned, gt, cfg)[0].mean()
        return rpn
    cfg = rcnn_config()
    return lambda b: rcnn_loss(model(b["roi_pts"], b["counts"]), b["rois"], b["tgts"], b["gt"], cfg)[0].mean()


def _to(batch, device):
    if isinstance(batch, dict):
        return {k: _to(v, device) for k, v in batch.items()}
    return batch.to(device)


def stage_step(stage: str, weights: Dict[str, torch.Tensor], batch, device, group=None) -> dict:
    """One training step of ``stage`` from ``weights`` (a state dict) on
    ``batch`` (the global batch, CPU tensors), on ``device``: this rank's
    shard under ``group`` (for ``"tp"``, a group with a model axis: its
    kernels are sharded over it), the whole batch without one. Returns the
    loss (averaged over the ranks), the model after the step, its averaged
    gradients by parameter name (whole where sharded, on the CPU) and the
    kernel launches of the step."""
    from lyft3d_tpu_torch.parallel import tensor as tp
    from lyft3d_tpu_torch.parallel.mesh import make_train_step_dp, shard_batch

    device = torch.device(device)
    model = stage_model(stage, device)
    model.load_state_dict(weights)
    model.train()
    if stage == "tp":
        tp.tensor_parallel_params(group, model, min_features=TP_MIN_FEATURES)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    step = make_train_step_dp(_loss_fn(stage, model, device, group), _optimizer(stage, [p for _, p in named]),
                              group)
    shard = _to(shard_batch(group, batch), device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launch_counts(reset=True)
    loss = float(step(shard))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = launch_counts()
    grads = {n: tp.unshard(p.grad, p).cpu() if p.grad is not None else torch.zeros(p.shape) for n, p in named}
    return {"loss": loss, "model": model, "grads": grads, "launches": {k: v for k, v in launches.items() if v}}


# ------------------------------------------------------------------ inputs


def dryrun_inputs(n_devices: int, model_parallel: int) -> Dict[str, dict]:
    """Each stage's global batch (CPU tensors), drawn from
    ``np.random.RandomState(0)`` in the JAX dry run's order (the TP batch only
    where the TP stage runs)."""
    from lyft3d_tpu_torch.models.pointrcnn.net import draw_target_priorities, proposal_target_layer

    rng = np.random.RandomState(0)
    b = n_devices
    t = torch.from_numpy
    out = {"unet": {"image": t(rng.rand(b, UNET_HW, UNET_HW, 6).astype(np.float32)),
                    "label": t((rng.rand(b, UNET_HW, UNET_HW) * N_CLASSES).astype(np.int32))}}
    if model_parallel > 1:
        dp = n_devices // model_parallel
        out["tp"] = {"image": t(rng.rand(2 * dp, 16, 16, 6).astype(np.float32)),
                     "label": t((rng.rand(2 * dp, 16, 16) * 10).astype(np.int32))}

    def second(n, spread, box):
        return {"points": t(rng.uniform(-spread, spread, (b, n, 4)).astype(np.float32)),
                "points_valid": torch.ones(b, n, dtype=torch.bool),
                "gt_boxes": t(np.tile(np.array([box], np.float32), (b, 1, 1))),
                "gt_classes": torch.ones(b, 1, dtype=torch.int32), "gt_valid": torch.ones(b, 1, dtype=torch.bool)}

    out["pillars"] = second(PILLAR_POINTS, 14, [2, 3, 0, 2, 4, 1.6, 0.3])
    out["sparse"] = second(SPARSE_POINTS, 7, [1, 2, 0, 2, 4, 1.6, 0.3])
    box = np.array([[0, 0, 0, 2, 4, 1.6, 0.3]], np.float32)
    out["rpn"] = {"points": t(rng.uniform(-10, 10, (b, RPN_POINTS, 3)).astype(np.float32)),
                  "points_valid": torch.ones(b, RPN_POINTS, dtype=torch.bool),
                  "gt_boxes": t(np.tile(box, (b, 2, 1))), "gt_valid": torch.ones(b, 2, dtype=torch.bool)}
    rois = t(np.concatenate([rng.uniform(-8, 8, (b, ROIS, 2)), rng.uniform(-1, 1, (b, ROIS, 1)),
                             rng.uniform(2, 6, (b, ROIS, 3)), rng.uniform(-np.pi, np.pi, (b, ROIS, 1))],
                            axis=-1).astype(np.float32))
    gt = t(np.tile(box, (b, 2, 1)))
    # The same draw for every frame, as the dry run samples each from PRNGKey(0).
    priorities = tuple(p.expand(b, -1) for p in draw_target_priorities((1, ROIS), torch.Generator().manual_seed(0)))
    tgts = proposal_target_layer(rois, torch.ones(b, ROIS, dtype=torch.bool), gt,
                                 torch.ones(b, 2, dtype=torch.bool), rcnn_config(), priorities)
    out["rcnn"] = {"roi_pts": t(rng.randn(b, ROIS, ROI_POINTS, 5).astype(np.float32)),
                   "counts": torch.full((b, ROIS), ROI_POINTS, dtype=torch.int32), "rois": rois, "gt": gt,
                   "tgts": {k: v.contiguous() for k, v in tgts.items()}}
    return out


# ------------------------------------------------------------------- ranks


def _flat_group(group):
    """The data-parallel group over every rank of a run with a model axis
    (the default process group)."""
    return dataclasses.replace(group, size=group.size * group.model_size, rank=group.world_rank, model_size=1,
                               model_rank=0, data_group=None, model_group=None)


def _norm_rel(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    num = math.sqrt(sum(float((got[k] - w).double().square().sum()) for k, w in want.items()))
    den = math.sqrt(sum(float(w.double().square().sum()) for w in want.values()))
    return num / max(den, 1e-30)


def _rank(group, stages: List[str], weights, inputs):
    """Every stage on this rank, then (rank 0) alone on the global batch; rank
    0 returns each stage's numbers with every rank's launches."""
    from lyft3d_tpu_torch.parallel.mesh import ranks_agree

    # cuDNN picks a convolution's algorithm by its batch, and with TF32 the
    # rounding then depends on the batch a sample runs in: the stages run in
    # float32 without it, so that the hold reads the ranks, not the algorithm.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flat = _flat_group(group) if group.model_size > 1 else group
    out, mine = [], []
    for stage in stages:
        g = group if stage == "tp" else flat
        ran = stage_step(stage, weights[stage], inputs[stage], group.device, g)
        agree = ranks_agree(g, ran["model"])
        mine.append(ran["launches"])
        if group.world_rank == 0:
            alone = stage_step(stage, weights[stage], inputs[stage], group.device)
            out.append(dict(stage=stage, loss=ran["loss"], alone_loss=alone["loss"],
                            loss_err=abs(ran["loss"] - alone["loss"]) / max(abs(alone["loss"]), 1e-30),
                            grad_err=_norm_rel(ran["grads"], alone["grads"]), agree=agree,
                            data=g.size, model=g.model_size))
        del ran
    every = [None] * (group.size * group.model_size)
    dist.all_gather_object(every, mine)
    if group.world_rank != 0:
        return None
    for i, o in enumerate(out):
        o["launches"] = [r[i] for r in every]
    return out


def dryrun_multichip(n_devices: int, device=None) -> List[dict]:
    """The six stages (five where ``n_devices`` is odd or under 4) over
    ``n_devices`` ranks, each held to one process (see the module
    docstring). Prints the JAX dry run's lines and its last ``stages ok``
    line; returns each stage's numbers (its loss, the loss and gradient
    errors against one process, and each rank's kernel launches)."""
    from lyft3d_tpu_torch.parallel.mesh import spawn

    dev = _device(device, "dryrun_multichip")
    model_parallel = TP_MODEL_PARALLEL if (n_devices >= 4 and n_devices % 2 == 0) else 1
    stages = [s for s in STAGES if s != "tp" or model_parallel > 1]
    weights = {s: {k: v.cpu() for k, v in stage_model(s, "cpu", seed=i).state_dict().items()}
               for i, s in enumerate(STAGES) if s in stages}
    inputs = dryrun_inputs(n_devices, model_parallel)
    if dev.type == "cpu":
        kw, where = dict(device="cpu"), f"{n_devices} gloo ranks on the CPU"
    elif torch.cuda.device_count() >= n_devices:
        kw, where = dict(device="cuda"), f"{n_devices} NCCL ranks, a card each"
    else:
        kw, where = dict(backend="gloo", device="cuda:0"), f"{n_devices} gloo ranks sharing cuda:0"
    results = spawn(_rank, n_devices, args=(stages, weights, inputs), model_parallel=model_parallel, **kw)
    failed = []
    for r in results:
        name = NAMES[r["stage"]]
        if r["stage"] == "tp":
            head = f"conv TP mesh=(data={r['data']}, model={r['model']})"
        else:
            head = f"{HEADS[r['stage']]} DP({n_devices})"
        ok = (np.isfinite(r["loss"]) and r["loss_err"] <= LOSS_TOL and r["grad_err"] <= GRAD_NORM_TOL
              and r["agree"])
        print(f"dryrun_multichip {'ok' if ok else 'FAILED'}: {head} loss={r['loss']:.4f} (one process "
              f"{r['alone_loss']:.4f}, rel {r['loss_err']:.2g}; gradients {r['grad_err']:.2g} in the 2-norm; ranks "
              f"bit-equal: {r['agree']}; {where})", flush=True)
        if not ok:
            failed.append(f"{name}: loss {r['loss']} against {r['alone_loss']} alone, gradients off by "
                          f"{r['grad_err']} (2-norm), ranks agree: {r['agree']}")
    if failed:
        raise AssertionError("dryrun_multichip: " + "; ".join(failed))
    print(f"dryrun_multichip stages ok ({n_devices} devices): {[NAMES[s] for s in stages]}", flush=True)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
