"""Rank functions of ``tests/test_torch_parallel.py``, in a module of their
own that imports torch and the port only: ``spawn`` pickles a rank function
by its module and each rank process imports that module, so a rank never
imports JAX (the references are computed in the test process)."""

import copy
import tempfile

import numpy as np
import torch

from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.parallel.mesh import (
    average_metrics,
    barrier,
    bev_rasterize_point_sharded,
    make_train_step_dp,
    ranks_agree,
    shard_batch,
)
from lyft3d_tpu_torch.pipelines.bev_train import build_bev_model, make_bev_loss_fn, make_bev_optimizer_fn
from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn
from lyft3d_tpu_torch.train.losses import weighted_softmax_ce
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params


def run_jobs(group, jobs):
    """``{name: fn(group, *args)}`` for the ``(name, fn name, args)`` of
    ``jobs``, in order: several checks in one spawn."""
    return {name: globals()[fn](group, *args) for name, fn, args in jobs}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def second_step(group, cfg, in_features, variables, batch, lr):
    """One ``Trainer`` step of a float32 pillars ``VoxelNet`` on this rank's
    shard of ``batch``: metrics, the flax tree after the step, the float32
    master gradients by parameter name, and whether every rank holds rank
    0's weights and masters."""
    model = load_flax_params(VoxelNet(cfg, in_features=in_features), variables)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, lambda p: build_optimizer(p, "adam", lr), make_second_loss_fn(cfg, "cpu"),
                          TrainerConfig(model_dir=tmp), group=group)
        state = trainer.init_or_resume()
        state, metrics = trainer.step_fn(state, shard_batch(group, _tensors(batch)))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    shadow = copy.deepcopy(model)  # the gradients under flax's names and layouts
    with torch.no_grad():
        for p, m in zip(shadow.parameters(), state.masters):
            p.copy_(m.grad)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "variables": export_flax_params(model),
            "grads": {n: m.grad.numpy().copy() for n, m in zip(names, state.masters)},
            "grad_tree": export_flax_params(shadow)["params"],
            "agree": ranks_agree(group, [model, state.masters])}


def bev_step(group, exp, variables, batch):
    """One ``Trainer`` step of a BatchNorm BEV model with class weights on
    this rank's shard: metrics, the flax tree (parameters and running
    statistics) after the step, each BatchNorm's batch statistics, the CE of
    the step's logits with the global and with a rank-local normaliser (each
    averaged over the ranks), and whether the ranks agree."""
    model = load_flax_params(build_bev_model(exp, torch.float32, "cpu"), variables)
    seen = {}
    model.register_forward_hook(lambda m, args, out: seen.update(logits=out[0].detach()))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, make_bev_optimizer_fn(exp), make_bev_loss_fn(exp, "cpu", group),
                          TrainerConfig(model_dir=tmp), group=group)
        state = trainer.init_or_resume()
        shard = shard_batch(group, _tensors(batch))
        state, metrics = trainer.step_fn(state, shard)
    weights = torch.tensor(exp.class_weights, dtype=torch.float32)
    ce = average_metrics(group, {
        "global": weighted_softmax_ce(seen["logits"], shard["label"], weights, group),
        "rank_local": weighted_softmax_ce(seen["logits"], shard["label"], weights)})
    stats = {name: tuple(s.numpy().copy() for s in m.batch_stats)
             for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "variables": export_flax_params(model), "batch_stats": stats,
            "ce": {k: float(v) for k, v in ce.items()},
            "agree": ranks_agree(group, [model, state.masters])}


def linear_step(group, w, b, batch, lr):
    """``make_train_step_dp`` of a mean-squared linear fit with SGD on this
    rank's shard of ``batch``: the loss and the parameters after the step."""
    params = [torch.nn.Parameter(torch.from_numpy(w)), torch.nn.Parameter(torch.from_numpy(b))]
    step = make_train_step_dp(lambda bt: ((bt["x"] @ params[0] + params[1] - bt["y"]) ** 2).mean(),
                              torch.optim.SGD(params, lr=lr), group)
    loss = step(shard_batch(group, _tensors(batch)))
    return {"loss": float(loss), "w": params[0].detach().numpy(), "b": params[1].detach().numpy()}


def raster(group, points, valid, raster_kw):
    """``bev_rasterize_point_sharded`` of the whole cloud, and whether every
    rank holds the same grid."""
    counts = bev_rasterize_point_sharded(group, torch.from_numpy(points), torch.from_numpy(valid),
                                         **raster_kw)
    return {"counts": counts.numpy(), "agree": ranks_agree(group, counts)}


def fails_on_rank_one(group):
    """Rank 1 raises while rank 0 waits for it at a barrier."""
    if group.rank == 1:
        raise ValueError("rank 1 cannot go on")
    barrier(group)
    return "rank 0 was not stopped"


def dryrun_stage(group, stage, weights, batch):
    """``dryrun.stage_step`` of one dry-run stage on this rank's shard: the
    loss, the flax tree after the step and the averaged gradients as a flax
    tree, and whether every rank holds rank 0's weights."""
    from lyft3d_tpu_torch import dryrun

    ran = dryrun.stage_step(stage, weights, batch, "cpu", group)
    model = ran["model"]
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in shadow.named_parameters():
            p.copy_(ran["grads"][name])
    return {"loss": ran["loss"], "variables": export_flax_params(model),
            "grad_tree": export_flax_params(shadow)["params"], "agree": ranks_agree(group, model)}


def from_rank_check(group):
    """``pointrcnn_train._from_rank`` on equal weights, then on weights that
    differ on rank 1: what each call did, by case."""
    from lyft3d_tpu_torch.pipelines import pointrcnn_train

    out = {}
    for case in ("same", "differ"):
        model = torch.nn.Linear(3, 2)
        for p in model.parameters():
            torch.nn.init.constant_(p, 1.0)
        if case == "differ" and group.rank == 1:
            model.weight.data[0, 0] += 1e-6
        try:
            pointrcnn_train._from_rank(group, model, [])
            out[case] = "returned"
        except RuntimeError as e:
            out[case] = str(e).split(": ", 1)[1]
    return out
