"""Rank functions of ``tests/test_torch_tensor_parallel.py``, in a module of
their own that imports torch and the port only: ``spawn`` pickles a rank
function by its module and each rank process imports that module, so a rank
never imports JAX (the references are computed in the test process)."""

import copy
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.dryrun import tp_conv_stack, tp_stack_loss
from lyft3d_tpu_torch.models.backbones import register_backbone
from lyft3d_tpu_torch.models.backbones.seresnext import seresnext26
from lyft3d_tpu_torch.models.layers import SameConv2d
from lyft3d_tpu_torch.models.second.middle import (
    StridedColumnLayer,
    StridedUnitLayer,
    SubMColumnLayer,
    SubMUnitLayer,
)
from lyft3d_tpu_torch.models.unet import LyftUNet
from lyft3d_tpu_torch.ops.column_sparse import columns_from_voxels, units_from_voxels
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
from lyft3d_tpu_torch.parallel import tensor as tp
from lyft3d_tpu_torch.parallel.mesh import make_train_step_dp, ranks_agree, shard_batch
from lyft3d_tpu_torch.train import checkpoint as ckpt
from lyft3d_tpu_torch.train import optim
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig


NARROW_BACKBONE = "seresnext26_narrow"


def run_jobs(group, jobs):
    """``{name: fn(group, *args)}`` for the ``(name, fn name, args)`` of
    ``jobs``, in order: several checks in one spawn."""
    return {name: globals()[fn](group, *args) for name, fn, args in jobs}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(seed, *shape):
    return torch.randn(*shape, generator=_gen(seed))


def unit_layer_input(seed, shape=(12, 10, 8), n=150, z_slab=4):
    """A batch of two voxel sets over ``shape`` as z-slab units (dense-z
    columns where ``z_slab`` is None): ``(cols, colf)`` with 4 channels."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    coords, valid = [], []
    for _ in range(2):
        flat = rng.choice(nx * ny * nz, n, replace=False)
        c = np.zeros((n + 10, 3), np.int32)
        c[:n] = np.stack([flat % nx, (flat // nx) % ny, flat // (nx * ny)], -1)
        coords.append(c)
        valid.append(np.arange(n + 10) < n)
    active = ActiveSet(torch.from_numpy(np.stack(coords)), torch.from_numpy(np.stack(valid)), shape)
    feats = torch.from_numpy(rng.randn(2, n + 10, 4).astype(np.float32))
    if z_slab is None:
        return columns_from_voxels(feats, active)
    return units_from_voxels(feats, active, z_slab)


def _layer(kind):
    """(layer, input, extra forward args) of one column-parallel case; every
    rank builds the same."""
    torch.manual_seed(0)
    x4 = _randn(1, 2, 8, 9, 10)
    cases = {
        "conv": lambda: (nn.Conv2d(8, 12, 3, padding=1), x4),
        "same_conv_stride2": lambda: (SameConv2d(8, 12, 3, stride=2), x4),
        "grouped": lambda: (nn.Conv2d(8, 16, 3, padding=1, groups=4, bias=False), x4),
        "grouped_cut": lambda: (nn.Conv2d(6, 18, 3, padding=2, dilation=2, groups=3), _randn(1, 2, 6, 9, 10)),
        "depthwise": lambda: (nn.Conv2d(8, 8, 3, padding=1, groups=8), x4),
        "depthwise_x2_same_stride2": lambda: (SameConv2d(8, 16, 3, stride=2, groups=8, bias=False), x4),
        "linear": lambda: (nn.Linear(10, 12), _randn(1, 3, 5, 10)),
    }
    if kind in cases:
        layer, x = cases[kind]()
        return layer, x, ()
    cols, colf = unit_layer_input(2, z_slab=4 if kind.endswith("unit") else None)
    if kind == "subm_unit":
        layer = SubMUnitLayer(4, 12, 2, norm_type="layer")  # 8 z planes, slabs of 4: 2 a column
    elif kind == "strided_unit":
        layer = StridedUnitLayer(4, 12, 2, max_out=200, norm_type="folded")
    elif kind == "subm_column":
        layer = SubMColumnLayer(4, 12, norm_type="batch")
    else:  # the output activity comes from the mask's own stencil, on every rank alike
        layer = StridedColumnLayer(4, 12, max_out=20, norm_type="layer")
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(_randn(3, *p.shape) * 0.3)
    return layer, colf, (cols,)


LAYER_KINDS = ("conv", "same_conv_stride2", "grouped", "grouped_cut", "depthwise",
               "depthwise_x2_same_stride2", "linear", "subm_unit", "strided_unit", "subm_column",
               "strided_column")


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def layer_cases(group):
    """Each column-parallel layer type against itself unsharded on the same
    input: ``{kind: (output err, input-gradient err, weight-gradient err,
    sharded)}``, each error the largest difference over the scale."""
    out = {}
    for kind in LAYER_KINDS:
        layer, x, extra = _layer(kind)
        cot_seed = 7

        def run(module):
            xi = x.clone().requires_grad_(True)
            y = _first(module(xi, *extra))
            cot = _randn(cot_seed, *y.shape)
            (y * cot).sum().backward()
            return y.detach(), xi.grad

        y_ref, dx_ref = run(layer)
        w_ref = {n: p.grad.clone() for n, p in layer.named_parameters()}
        sharded = copy.deepcopy(layer)
        sharded.zero_grad(set_to_none=True)
        tp.tensor_parallel_params(group, sharded, min_features=4)
        y, dx = run(sharded)
        whole = {n: tp.unshard(p.grad, p) for n, p in sharded.named_parameters()}

        def err(a, b):
            return float((a - b).abs().max()) / max(1e-30, float(b.abs().max()))

        out[kind] = (err(y, y_ref), err(dx, dx_ref), max(err(whole[n], w_ref[n]) for n in w_ref),
                     any(tp.shard_of(p) is not None for p in sharded.parameters()))
    return out


def graft_step(group, weights, batch):
    """The dry run's TP stage: ``dryrun.tp_conv_stack`` with ``weights``
    (torch layout), ``min_features=128``, Adam 1e-3, one step of
    ``make_train_step_dp`` on this rank's shard of ``batch``: the loss and
    the whole state and the averaged gradients after the step."""
    model = tp_conv_stack()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    tp.tensor_parallel_params(group, model, min_features=128)
    step = make_train_step_dp(lambda b: tp_stack_loss(model, b),
                              build_optimizer(list(model.parameters()), "adam", 1e-3), group)
    loss = step(shard_batch(group, {k: torch.from_numpy(v) for k, v in batch.items()}))
    state = tp.gather_tensor_parallel_state(model)
    grads = {n: tp.unshard(p.grad, p).numpy() for n, p in model.named_parameters()}
    return {"loss": float(loss), "state": {k: v.numpy() for k, v in state.items()}, "grads": grads,
            "sharded": sorted(n for n, p in model.named_parameters() if tp.shard_of(p) is not None),
            "agree": ranks_agree(group, model), "apart": data_rank_differences(group, model)}


def data_rank_differences(group, model):
    """Where a rank's parameter or its gradient differs from data rank 0's:
    ``{(world rank, name, "value" or "grad"): largest difference}`` over
    every rank of the run (empty where all agree)."""
    diffs = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            for kind, t in (("value", p), ("grad", p.grad)):
                ref = t.detach().clone()
                dist.broadcast(ref, src=group.model_rank, group=group.data_group)
                d = float((ref - t).abs().max())
                if d or not torch.equal(ref, t):
                    diffs[(group.world_rank, name, kind)] = d
    every = [None] * (group.size * group.model_size)
    dist.all_gather_object(every, diffs)
    return {k: v for d in every for k, v in d.items()}


def narrow_unet(generator_seed=0):
    """``unet_seresnext26`` narrowed: stage widths 32-256, cardinality 8,
    decoder 16, ASPP 32 (the narrow backbone registered under its own name)."""
    register_backbone(NARROW_BACKBONE, partial(seresnext26, stage_features=(32, 64, 128, 256), cardinality=8))
    return LyftUNet(backbone=NARROW_BACKBONE, n_classes=10, decoder_features=16, aspp_features=32,
                    generator=_gen(generator_seed))


def unet_loss(model, batch):
    logits, aux = model(batch["image"])
    return F.cross_entropy(logits.permute(0, 3, 1, 2), batch["label"].long()) + 0.1 * aux.square().mean()


def ranger_update(model, batch, clip_norm, group=None, min_features=64, lr=0.1):
    """One ``ranger`` update (``lr``, ``clip_norm``) of :func:`narrow_unet` on
    ``batch`` (this rank's shard under ``group``): the loss and the whole
    parameters after it. The rate is large enough that the float32
    parameters resolve the update to a few digits."""
    if group is not None:
        tp.tensor_parallel_params(group, model, min_features=min_features)
    params = list(model.parameters())
    step = make_train_step_dp(lambda b: unet_loss(model, b),
                              build_optimizer(params, "ranger", lr, clip_norm=clip_norm), group)
    loss = step(shard_batch(group, batch))
    state = tp.gather_tensor_parallel_state(model) if group is not None else model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    return float(loss), {n: state[n].numpy().copy() for n in names}


def clipped_ranger(group, batch, clip_norm):
    """The clipped ``ranger`` update on the ranks, with the whole model's
    norm and again with each rank's own (the slices' squares not summed over
    the model group)."""
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, params = ranger_update(narrow_unet(), batch, clip_norm, group)
    orig = optim.shard_of
    optim.shard_of = lambda p: None  # every rank clips by its own norm
    try:
        local_loss, local_params = ranger_update(narrow_unet(), batch, clip_norm, group)
    finally:
        optim.shard_of = orig
    model = narrow_unet()
    tp.tensor_parallel_params(group, model, min_features=64)
    sharded = sorted(n for n, p in model.named_parameters() if tp.shard_of(p) is not None)
    return {"loss": loss, "params": params, "local_loss": local_loss, "local_params": local_params,
            "sharded": sharded}


def _stack_trainer(model_dir, weights, group, eval_batch):
    """A ``Trainer`` of the bfloat16 ``TPConvStack`` (float32 masters) with
    ``weights``, sharded at ``min_features=128`` under ``group``: ``ranger``
    (lr 1e-2, clip 1.0), two steps, each logged, evaluated on
    ``eval_batch`` and checkpointed."""
    model = tp_conv_stack(dtype=torch.bfloat16)
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    tp.tensor_parallel_params(group, model, min_features=128)

    def eval_fn(state):
        with torch.no_grad():
            return {"loss": float(tp_stack_loss(state.module, eval_batch))}

    return Trainer(model, lambda p: build_optimizer(p, "ranger", 1e-2, clip_norm=1.0),
                   lambda m, b, gen: (tp_stack_loss(m, b), {}),
                   TrainerConfig(model_dir=model_dir, total_steps=2, log_every=1, eval_every=1, ckpt_every=1),
                   eval_fn=eval_fn, group=group)


def _same(a, b) -> bool:
    """Two snapshots equal bit for bit (tensors) and by value (the rest)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def trainer_round_trip(group, weights, other_weights, batches, model_dir):
    """``Trainer.fit`` of :func:`_stack_trainer` over ``batches`` (this
    rank's shards under ``group``), then a second trainer of a module with
    ``other_weights`` resumed from ``model_dir``: the fitted state's whole
    snapshot, the resumed step, whether every rank's resumed snapshot equals
    its fitted one, and whether the evaluations wrote a best checkpoint."""
    batches = [{"image": torch.from_numpy(b["image"]).to(torch.bfloat16), "label": torch.from_numpy(b["label"])}
               for b in batches]
    trainer = _stack_trainer(model_dir, weights, group, batches[0])
    state = trainer.fit(trainer.init_or_resume(), [shard_batch(group, b) for b in batches])
    whole = state.state_dict()
    resumed = _stack_trainer(model_dir, other_weights, group, batches[0]).init_or_resume()
    same = torch.tensor([float(_same(whole, resumed.state_dict()))])
    if group is not None:
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return {"state": whole, "resumed_step": resumed.step, "same": bool(same.item() == 1.0),
            "sharded": state.sharded, "best": ckpt.latest_checkpoint(model_dir, "best") is not None}
