"""Stochastic weight averaging and the BatchNorm statistics refresh (port of
``lyft3d_tpu/train/swa.py``), on ``state_dict``s: name → tensor maps.

- :func:`moving_average`: ``avg ← avg + (new − avg)/(n+1)``;
- :func:`average_params`: the uniform average of several weight maps;
- :func:`swa_from_checkpoints`: the average of saved train states, each
  parameter from its float32 master where the snapshot holds one;
- :func:`bn_update`: running statistics recomputed for averaged weights, the
  mean over the given batches of each batch's statistics (only models built
  with ``norm_type="batch"`` have running statistics).

Floating-point tensors are averaged in float32; integer ones
(``num_batches_tracked``) are taken from the first map.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.train import checkpoint as ckpt

__all__ = ["moving_average", "average_params", "swa_from_checkpoints", "bn_update"]

Weights = Dict[str, torch.Tensor]


def moving_average(avg: Weights, new: Weights, n: int) -> Weights:
    """Running mean update: ``avg ← avg + (new − avg)/(n+1)``, a new map."""
    if avg.keys() != new.keys():
        raise KeyError(f"weight maps differ: {sorted(avg.keys() ^ new.keys())}")
    out = {}
    for k, a in avg.items():
        if a.is_floating_point():
            a = a.float()
            out[k] = a + (new[k].float() - a) / float(n + 1)
        else:
            out[k] = a
    return out


def average_params(weights: Sequence[Weights]) -> Weights:
    """Uniform average of weight maps (the reference's file average)."""
    if not weights:
        raise ValueError("average_params needs at least one weight map")
    out = moving_average(weights[0], weights[0], 0)  # float32 copies
    for n, w in enumerate(weights[1:], start=1):
        out = moving_average(out, w, n)
    return out


def swa_from_checkpoints(paths, module: nn.Module) -> Weights:
    """The average of the train states saved at ``paths`` (``Trainer``
    snapshots of a model built as ``module``), each parameter taken from its
    float32 master where the snapshot holds one; load it with
    ``module.load_state_dict``."""
    from lyft3d_tpu_torch.train.trainer import TrainState  # trainer imports checkpoint

    weights = []
    for path in paths:
        sd = ckpt.restore(path)
        w = dict(sd["model"])
        w.update(TrainState.masters_by_name(module, sd))
        weights.append(w)
    return average_params(weights)


@torch.no_grad()
def bn_update(model: nn.Module, batches: Iterable) -> nn.Module:
    """Recompute the running statistics of every :class:`BatchNorm` of
    ``model`` (in place) as the mean over ``batches`` of each batch's mean and
    biased variance, with the model in train mode (``model(batch)``); its mode
    is restored. A model without BatchNorm, or no batch, leaves the statistics
    as they are. Returns ``model``."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if not norms:
        return model
    was_training = model.training
    sums, n = None, 0
    model.train()
    try:
        for batch in batches:
            for bn in norms:
                bn.batch_stats = None
            model(batch)
            stats = [bn.batch_stats for bn in norms]
            if any(s is None for s in stats):
                raise RuntimeError("bn_update: a BatchNorm of the model did not run on the batch")
            sums = stats if sums is None else [(m + sm, v + sv) for (m, v), (sm, sv) in zip(sums, stats)]
            n += 1
    finally:
        model.train(was_training)
    for bn, (mean, var) in zip(norms, sums or ()):
        bn.running_mean.copy_(mean / n)
        bn.running_var.copy_(var / n)
    return model
