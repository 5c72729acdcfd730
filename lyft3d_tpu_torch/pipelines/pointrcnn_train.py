"""PointRCNN training (port of the training half of
``lyft3d_tpu/pipelines/pointrcnn_train.py``): the three modes of
``train-pointrcnn``.

- RPN: :func:`make_rpn_step` (point labels → RPN → per-sample loss, mean
  over the batch → backward → optimizer) and :func:`train_pointrcnn_rpn`,
  the 4-part round-robin over the frames (:func:`rpn_schedule`) with
  ``adam_onecycle``;
- RCNN online: :func:`train_rcnn_online`, the frozen RPN run every step
  (:func:`make_rcnn_stage1`: proposals → RoI sampling → RoI noise → RoI
  pool in the canonical frame) and the RCNN trained on its output;
- RCNN offline: :func:`cache_rcnn_samples` (the frozen RPN's proposals and
  point features a frame) and :func:`train_rcnn_offline` on the cache;
- :func:`assemble_joint_params`: separately trained stages into the joint
  :class:`~lyft3d_tpu_torch.models.pointrcnn.net.PointRCNN`.

Steps run on the device of the model, batched where the JAX package
``vmap``s over frames; the RCNN runs on all ``num_proposals`` RoIs with the
loss masked by the sampled ``keep``. The trainers build float32 models, as
the JAX trainers do, on the card unless given ``device="cpu"``, and raise
without one. They take a ``model`` to start from (for example the JAX
package's initialisation carried over by
:func:`~lyft3d_tpu_torch.utils.flax_params.load_flax_params`) and the RCNN
trainers a ``draws`` function for the uniforms of RoI sampling and noise
(by default drawn from a ``torch.Generator``), and return ``(model,
losses)``: the weights are the model's own.

``n_devices`` (default one rank) trains data-parallel as the JAX trainers
do: a process a rank (:func:`~lyft3d_tpu_torch.parallel.mesh.spawn`), each
loading its slice of every global batch and taking its slice of the global
batch's RoI draws, the float32 gradients averaged over the ranks. The losses
need no normaliser of their own: each frame's loss is normalised within the
frame (the JAX trainers ``vmap`` ``rpn_loss`` and ``rcnn_loss`` a frame at a
time) and the batch's loss is the mean over frames, which equal shards
average to the global value. The trained weights come back from rank 0 into
the caller's model, after a check that every rank holds them bit for bit.
``backend="gloo"`` runs the ranks on one card, the one ``device`` names
(:func:`~lyft3d_tpu_torch.parallel.mesh.rank_placement`).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from lyft3d_tpu_torch.data.prefetch import MappedPrefetcher
from lyft3d_tpu_torch.data.splits import split_parts
from lyft3d_tpu_torch.models.pointrcnn.net import (
    PointRCNN,
    PointRCNN_RCNN,
    PointRCNN_RPN,
    PointRCNNConfig,
    aug_rois_with_noise,
    canonical_transform,
    draw_roi_noise,
    draw_target_priorities,
    gather_boxes,
    proposal_layer,
    proposal_target_layer,
    rcnn_loss,
    rpn_loss,
    rpn_point_labels,
)
from lyft3d_tpu_torch.ops.pointnet2 import roi_pool3d
from lyft3d_tpu_torch.parallel.mesh import (
    DataGroup,
    all_reduce_gradients,
    average_metrics,
    make_data_group,
    rank_placement,
    ranks_agree,
    replicate,
    reseed_for_rank,
    shard_batch,
    spawn,
    sync_batch_norms,
)
from lyft3d_tpu_torch.pipelines.pointrcnn import KittiPointRCNNLoader
from lyft3d_tpu_torch.pipelines.second_train import _training_device
from lyft3d_tpu_torch.train.optim import build_optimizer

__all__ = [
    "make_rpn_step",
    "rpn_schedule",
    "train_pointrcnn_rpn",
    "rcnn_inputs",
    "make_rcnn_stage1",
    "rcnn_step",
    "cache_rcnn_samples",
    "train_rcnn_offline",
    "train_rcnn_online",
    "assemble_joint_params",
]

CACHE_KEYS = ("xyz", "point_features", "points_valid", "rois", "roi_valid", "gt_boxes", "gt_valid")


def _on(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in arrays.items()}


def _zero_features(xyz):
    """The RPN's input features: one zero channel a point."""
    return xyz.new_zeros((*xyz.shape[:2], 1))


def _params(optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def make_rpn_step(model: PointRCNN_RPN, cfg: PointRCNNConfig, optimizer,
                  group: Optional[DataGroup] = None) -> Callable:
    """``step(batch) -> (loss, metrics)``: one RPN training step on a batch
    on the model's device (points ``(B, N, 3)``, points_valid ``(B, N)``,
    gt_boxes ``(B, G, 7)``, gt_valid ``(B, G)``): point labels, forward, the
    mean over the batch of the per-sample losses (and of each metric),
    backward, ``optimizer.step()``. Loss and metrics come back detached.
    Under a data-parallel ``group`` the batch is this rank's shard, and the
    gradients, loss and metrics are averaged over the ranks."""

    def step(batch):
        xyz, gt = batch["points"], batch["gt_boxes"]
        labels, assigned = rpn_point_labels(xyz, gt, batch["gt_valid"])
        optimizer.zero_grad(set_to_none=True)
        out = model(xyz, _zero_features(xyz), batch["points_valid"])
        losses, metrics = rpn_loss(out, xyz, labels, assigned, gt, cfg)
        loss = losses.mean()
        loss.backward()
        all_reduce_gradients(group, _params(optimizer))
        optimizer.step()
        metrics = average_metrics(group, {"loss": loss.detach(),
                                          **{k: v.detach().mean() for k, v in metrics.items()}})
        return metrics.pop("loss"), metrics

    return step


def rpn_schedule(stems: Sequence[str], steps: int, batch_size: int, num_parts: int = 4,
                 seed: int = 0) -> List[List[str]]:
    """The frames of each of ``steps`` RPN steps: the round-robin over
    ``num_parts`` parts of ``stems`` (:func:`split_parts`), each part
    shuffled by ``np.random.RandomState(seed)`` on every visit and cut into
    batches, as the JAX trainer picks them."""
    parts = split_parts(stems, num_parts)
    if not any(parts):
        raise ValueError("rpn_schedule: no frames")
    rng = np.random.RandomState(seed)
    schedule: List[List[str]] = []
    while len(schedule) < steps:
        for part in parts:
            frames = list(part)
            if not frames:  # fewer frames than parts
                continue
            rng.shuffle(frames)
            for j in range(0, max(len(frames) - batch_size + 1, 1), batch_size):
                if len(schedule) >= steps:
                    break
                schedule.append(frames[j: j + batch_size] or frames[:1])
    return schedule


def _ranks(batch_size: int, n_devices: Optional[int], device, backend: Optional[str]) -> int:
    """The rank count of a PointRCNN trainer: one unless ``n_devices`` asks
    for more (the JAX trainers' default), then ``make_data_group``'s."""
    return 1 if not n_devices or n_devices == 1 else make_data_group(batch_size, n_devices, device, backend)


def _on_rank(group: Optional[DataGroup], model):
    """The model a rank trains: on its card, rank 0's weights, BatchNorm
    statistics over the global batch."""
    if group is None:
        return model
    model = model.to(group.device)
    replicate(group, model)
    return sync_batch_norms(model, group)


def _to_caller(model, trained):
    """Rank 0's trained weights (a CPU state dict) into the caller's model."""
    model.load_state_dict(trained)
    return model


def _rank_draws(group: Optional[DataGroup], drawn, device):
    """This rank's slice of a step's draws for the global batch (tensors in
    tuples and dicts), on ``device``."""
    drawn = shard_batch(group, drawn)
    if isinstance(drawn, dict):
        return {k: _rank_draws(None, v, device) for k, v in drawn.items()}
    if isinstance(drawn, (list, tuple)):
        return type(drawn)(_rank_draws(None, v, device) for v in drawn)
    return drawn.to(device)


def _from_rank(group: DataGroup, model, losses):
    """Rank 0's weights as a CPU state dict, and the losses; raises on every
    rank unless every rank holds rank 0's weights."""
    if not ranks_agree(group, model):
        raise RuntimeError(f"rank {group.rank}: the ranks' weights differ after training")
    return {k: v.cpu() for k, v in model.state_dict().items()}, losses


def _fit_rpn(group: Optional[DataGroup], loader, cfg, steps, batch_size, lr, num_parts, seed, num_workers,
             model, device=None):
    device = group.device if group is not None else device
    model = _on_rank(group, model).train()
    loader = reseed_for_rank(loader, group)
    optimizer = build_optimizer(list(model.parameters()), "adam_onecycle", lr, total_steps=steps)
    step = make_rpn_step(model, cfg, optimizer, group)
    schedule = rpn_schedule(loader.stems, steps, batch_size, num_parts, seed)
    batches = MappedPrefetcher(lambda: iter(schedule),
                               lambda stems: _on(loader.batch(shard_batch(group, stems)), device),
                               num_workers=num_workers)
    return model, [float(step(batch)[0]) for batch in batches]


def _rpn_rank(group: DataGroup, *args):
    return _from_rank(group, *_fit_rpn(group, *args))


def train_pointrcnn_rpn(loader: KittiPointRCNNLoader, cfg: PointRCNNConfig, steps: int = 100,
                        batch_size: int = 2, lr: float = 2e-3, num_parts: int = 4, seed: int = 0,
                        num_workers: int = 4, model: Optional[PointRCNN_RPN] = None,
                        device="cuda", n_devices: Optional[int] = None, backend: Optional[str] = None):
    """RPN training over the round-robin schedule with ``adam_onecycle``;
    batches are assembled on ``num_workers`` prefetch threads. ``model``
    (on ``device``) is trained in place; by default a float32 RPN is built
    from a generator seeded ``seed``. ``n_devices`` > 1 trains data-parallel
    (every batch of the schedule must split evenly). Returns ``(model,
    losses)``."""
    device = _training_device(device, "train_pointrcnn_rpn")
    # The JAX trainer assembles a first batch for its init: so does this one,
    # so that a seeded loader draws the same batches after it.
    loader.batch(loader.stems[:batch_size])
    if model is None:
        model = PointRCNN_RPN(cfg, in_features=1, device=device,
                              generator=torch.Generator().manual_seed(seed))
    args = (loader, cfg, steps, batch_size, lr, num_parts, seed, num_workers)
    n = _ranks(batch_size, n_devices, device, backend)
    if n == 1:
        return _fit_rpn(None, *args, model, device=device)
    trained, losses = spawn(_rpn_rank, n, args=args + (copy.deepcopy(model).cpu(),),
                            **rank_placement(device, backend))
    return _to_caller(model.train(), trained), losses


def rcnn_inputs(xyz, point_features, valid, rois, cfg: PointRCNNConfig):
    """RoI pool (the RoI-select kernel) and the canonical transform: the
    RCNN's ``(B, R, roi_points, 3 + C)`` points and ``(B, R)`` counts."""
    pooled, counts, _ = roi_pool3d(xyz, point_features, valid, rois, cfg.roi_points,
                                   cfg.roi_extra_width)
    canon = canonical_transform(pooled[..., :3], rois)
    return torch.cat([canon, pooled[..., 3:]], dim=-1), counts


def make_rcnn_stage1(rpn_model: PointRCNN_RPN, cfg: PointRCNNConfig, roi_noise: bool = True):
    """``stage1(points, valid, gt_boxes, gt_valid, priorities, noise) ->
    (roi_points, counts, rois, targets)`` under ``torch.no_grad()``: the
    frozen RPN, the proposals, RoI sampling on ``priorities``
    (:func:`~lyft3d_tpu_torch.models.pointrcnn.net.draw_target_priorities`),
    then, with ``roi_noise``, the RoIs jittered by ``noise``
    (:func:`~lyft3d_tpu_torch.models.pointrcnn.net.draw_roi_noise`) against
    their assigned GT boxes, and the RoI pool of the RPN's point features."""

    @torch.no_grad()
    def stage1(points, valid, gt_boxes, gt_valid, priorities, noise=None):
        out = rpn_model(points, _zero_features(points), valid)
        props = proposal_layer(points, out["cls"], out["reg"], valid, cfg)
        rois = props["rois"]
        targets = proposal_target_layer(rois, props["roi_valid"], gt_boxes, gt_valid, cfg, priorities)
        if roi_noise:
            rois = aug_rois_with_noise(rois, noise, gt_of_rois=gather_boxes(gt_boxes, targets["assigned_gt"]),
                                       fg=targets["fg"], pos_iou=cfg.fg_iou)
        roi_points, counts = rcnn_inputs(points, out["point_features"], valid, rois, cfg)
        return roi_points, counts, rois, targets

    return stage1


def rcnn_step(model, optimizer, roi_points, counts, rois, targets, gt_boxes, cfg,
              group: Optional[DataGroup] = None):
    """One RCNN training step on stage 1's output: forward, the mean over
    the batch of the per-frame losses, backward, ``optimizer.step()``.
    Returns the loss, detached. Under a data-parallel ``group`` the inputs
    are this rank's shard, and the gradients and the loss are averaged over
    the ranks."""
    optimizer.zero_grad(set_to_none=True)
    losses, _ = rcnn_loss(model(roi_points, counts), rois, targets, gt_boxes, cfg)
    loss = losses.mean()
    loss.backward()
    all_reduce_gradients(group, _params(optimizer))
    optimizer.step()
    return average_metrics(group, {"loss": loss.detach()})["loss"]


def _rcnn_model(model, cfg, in_features, seed, device):
    if model is None:
        model = PointRCNN_RCNN(cfg, in_features, device=device,
                               generator=torch.Generator().manual_seed(seed))
    return model.train()


def cache_rcnn_samples(rpn_model: PointRCNN_RPN, loader: KittiPointRCNNLoader, cfg: PointRCNNConfig,
                       stems: Optional[Sequence[str]] = None) -> List[dict]:
    """The offline RCNN's input a frame, from the frozen RPN (put in eval
    mode) on its device: the frame's points, their RPN features and the
    proposals, as numpy arrays (the keys of the JAX package's cache)."""
    device = next(rpn_model.parameters()).device
    rpn_model.eval()
    cache = []
    for stem in stems or loader.stems:
        s = loader.sample(stem)
        xyz, valid = (torch.from_numpy(s[k][None]).to(device) for k in ("points", "points_valid"))
        with torch.no_grad():
            out = rpn_model(xyz, _zero_features(xyz), valid)
            props = proposal_layer(xyz, out["cls"], out["reg"], valid, cfg)
        cache.append({
            "stem": stem,
            "xyz": s["points"],
            "points_valid": s["points_valid"],
            "point_features": out["point_features"][0].cpu().numpy(),
            "rois": props["rois"][0].cpu().numpy(),
            "roi_valid": props["roi_valid"][0].cpu().numpy(),
            "gt_boxes": s["gt_boxes"],
            "gt_valid": s["gt_valid"],
        })
    return cache


def _fit_rcnn_offline(group: Optional[DataGroup], cache, cfg, steps, lr, seed, batch_size, model, draws,
                      device=None):
    device = group.device if group is not None else device
    model = _on_rank(group, model)
    optimizer = build_optimizer(list(model.parameters()), "adam", lr)
    if draws is None:
        def draws(step):
            fixed = draw_target_priorities((1, cfg.num_proposals), torch.Generator().manual_seed(0), device)
            return tuple(p.expand(batch_size, -1) for p in fixed)

    rng = np.random.RandomState(seed)
    losses = []
    for i in range(steps):
        # The global batch's frames and draws; this rank's slice of each.
        picks = shard_batch(group, [cache[rng.randint(len(cache))] for _ in range(batch_size)])
        priorities = _rank_draws(group, draws(i), device)
        b = _on({k: np.stack([s[k] for s in picks]) for k in CACHE_KEYS}, device)
        with torch.no_grad():
            roi_points, counts = rcnn_inputs(b["xyz"], b["point_features"], b["points_valid"], b["rois"], cfg)
            targets = proposal_target_layer(b["rois"], b["roi_valid"], b["gt_boxes"], b["gt_valid"], cfg,
                                            priorities)
        losses.append(float(rcnn_step(model, optimizer, roi_points, counts, b["rois"], targets,
                                       b["gt_boxes"], cfg, group)))
    return model, losses


def _rcnn_offline_rank(group: DataGroup, *args):
    return _from_rank(group, *_fit_rcnn_offline(group, *args))


def train_rcnn_offline(cache: Sequence[dict], cfg: PointRCNNConfig, steps: int = 100,
                       lr: float = 1e-3, seed: int = 0, batch_size: int = 1,
                       model: Optional[PointRCNN_RCNN] = None,
                       draws: Optional[Callable] = None, device="cuda", n_devices: Optional[int] = None,
                       backend: Optional[str] = None):
    """Offline RCNN training on cached frames (:func:`cache_rcnn_samples`),
    ``batch_size`` frames a step picked by ``np.random.RandomState(seed)``,
    ``adam(lr)``. ``draws(step)`` gives the three ``(batch_size,
    num_proposals)`` priorities of RoI sampling; by default every step and
    every frame take the same draw, from a generator seeded 0 anew, as the
    JAX trainer samples from ``PRNGKey(0)`` each time. ``n_devices`` > 1
    trains data-parallel, each rank on its slice of the frames and of the
    draws (``draws`` is then pickled into the ranks). Returns ``(model,
    losses)``."""
    device = _training_device(device, "train_rcnn_offline")
    model = _rcnn_model(model, cfg, 3 + cache[0]["point_features"].shape[-1], seed, device)
    args = (cache, cfg, steps, lr, seed, batch_size)
    n = _ranks(batch_size, n_devices, device, backend)
    if n == 1:
        return _fit_rcnn_offline(None, *args, model, draws, device=device)
    trained, losses = spawn(_rcnn_offline_rank, n, args=args + (copy.deepcopy(model).cpu(), draws),
                            **rank_placement(device, backend))
    return _to_caller(model, trained), losses


def _fit_rcnn_online(group: Optional[DataGroup], rpn_model, loader, cfg, steps, lr, seed, roi_noise, batch_size,
                     num_workers, model, draws, device=None):
    device = group.device if group is not None else device
    rpn_model = rpn_model.to(device).eval()
    model = _on_rank(group, model)
    loader = reseed_for_rank(loader, group)
    optimizer = build_optimizer(list(model.parameters()), "adam", lr)
    stage1 = make_rcnn_stage1(rpn_model, cfg, roi_noise)
    if draws is None:
        generator = torch.Generator().manual_seed(seed)

        def draws(step):
            shape = (batch_size, cfg.num_proposals)
            return (draw_target_priorities(shape, generator, device),
                    draw_roi_noise(shape, cfg.roi_fg_aug_times, generator, device))

    rng = np.random.RandomState(seed)
    picks = [[loader.stems[rng.randint(len(loader.stems))] for _ in range(batch_size)]
             for _ in range(steps)]
    # Every rank walks the global picks and loads its own slice of each.
    batches = MappedPrefetcher(lambda: iter(picks),
                               lambda stems: _on(loader.batch(shard_batch(group, stems)), device),
                               num_workers=num_workers)
    losses = []
    for i, b in enumerate(batches):
        roi_points, counts, rois, targets = stage1(b["points"], b["points_valid"], b["gt_boxes"],
                                                   b["gt_valid"], *_rank_draws(group, draws(i), device))
        losses.append(float(rcnn_step(model, optimizer, roi_points, counts, rois, targets,
                                       b["gt_boxes"], cfg, group)))
    return model, losses


def _rcnn_online_rank(group: DataGroup, *args):
    return _from_rank(group, *_fit_rcnn_online(group, *args))


def train_rcnn_online(rpn_model: PointRCNN_RPN, loader: KittiPointRCNNLoader, cfg: PointRCNNConfig,
                      steps: int = 100, lr: float = 1e-3, seed: int = 0, roi_noise: bool = True,
                      batch_size: int = 1, num_workers: int = 4,
                      model: Optional[PointRCNN_RCNN] = None, draws: Optional[Callable] = None,
                      device="cuda", n_devices: Optional[int] = None, backend: Optional[str] = None):
    """Online RCNN training: the frozen RPN (put in eval mode) runs every
    step on ``batch_size`` frames picked by ``np.random.RandomState(seed)``
    (:func:`make_rcnn_stage1`), and the RCNN trains on its RoIs with
    ``adam(lr)``; only the RCNN's parameters change. ``draws(step)`` gives
    ``(priorities, noise)`` for the step's ``(batch_size, num_proposals)``
    RoIs; by default both are drawn from a generator seeded ``seed``.
    ``n_devices`` > 1 trains data-parallel, each rank on its slice of the
    frames and of the draws. Returns ``(model, losses)``."""
    device = _training_device(device, "train_rcnn_online")
    rpn_model.eval()
    # The JAX trainer runs stage 1 on the first frame for its init: the
    # frame is loaded here too, so that a seeded loader draws the same
    # frames after it.
    loader.sample(loader.stems[0])
    model = _rcnn_model(model, cfg, 3 + cfg.fp_width, seed, device)
    args = (loader, cfg, steps, lr, seed, roi_noise, batch_size, num_workers)
    n = _ranks(batch_size, n_devices, device, backend)
    if n == 1:
        return _fit_rcnn_online(None, rpn_model, *args, model, draws, device=device)
    trained, losses = spawn(_rcnn_online_rank, n,
                            args=(copy.deepcopy(rpn_model).cpu(),) + args + (copy.deepcopy(model).cpu(), draws),
                            **rank_placement(device, backend))
    return _to_caller(model, trained), losses


@torch.no_grad()
def assemble_joint_params(joint_model: PointRCNN, rpn_model: PointRCNN_RPN,
                          rcnn_model: PointRCNN_RCNN) -> PointRCNN:
    """Separately trained stages into the joint net: the weights of
    ``rpn_model`` and ``rcnn_model`` copied into ``joint_model`` (in place,
    cast to its dtype); returns it."""
    joint_model.rpn.load_state_dict(rpn_model.state_dict())
    joint_model.rcnn.load_state_dict(rcnn_model.state_dict())
    return joint_model
