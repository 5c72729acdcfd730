"""BEV segmentation training (port of ``lyft3d_tpu/pipelines/bev_train.py``):
80/20 token split, PNG dataset with augmentation, weighted-CE + SIZE·BCE +
SoftDice objective, any registered optimizer with gradient accumulation and
clip-norm, best-val checkpointing, on the port's ``Trainer``.

Running statistics of ``norm_type="batch"`` models are buffers of the
module: the optimizer sees parameters only, so weight decay cannot touch
them, and every train-mode forward refreshes them. That takes the place of
the JAX package's ``optax.masked`` optimizer and ``_model_state`` convention.

:func:`make_bev_loss_fn` and :func:`make_bev_optimizer_fn` are the step's
pieces, usable without PNGs (``chip_smoke.py`` feeds them tensors).
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lyft3d_tpu_torch.config import BEVExperiment, snapshot_config
from lyft3d_tpu_torch.data.bev_dataset import BEVImageDataset, index_batches
from lyft3d_tpu_torch.data.prefetch import MappedPrefetcher
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.parallel.mesh import (
    DataGroup,
    make_data_group,
    rank_placement,
    reseed_for_rank,
    shard_batch,
    spawn,
)
from lyft3d_tpu_torch.pipelines.second_train import _training_device
from lyft3d_tpu_torch.train import checkpoint as ckpt
from lyft3d_tpu_torch.train.losses import bev_segmentation_loss
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "split_tokens",
    "build_bev_model",
    "make_bev_loss_fn",
    "make_bev_optimizer_fn",
    "make_bev_eval_fn",
    "train_bev",
]


def split_tokens(tokens: Sequence[str], seed: int) -> Tuple[List[str], List[str]]:
    """``(train, validation)``: a fifth (at least one) of ``tokens`` for
    validation, by one permutation of ``RandomState(seed)``."""
    perm = np.random.RandomState(seed).permutation(len(tokens))
    n_val = max(int(len(tokens) * 0.2), 1)
    return [tokens[i] for i in perm[n_val:]], [tokens[i] for i in perm[:n_val]]


def build_bev_model(cfg: BEVExperiment, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """``cfg.model`` with ``cfg.model_kwargs``, 6 input channels with the map
    (3 without), weights from ``torch.Generator().manual_seed(cfg.data.seed)``."""
    return build_model(cfg.model, n_classes=cfg.n_classes, in_features=6 if cfg.with_map else 3,
                       dtype=dtype, device=device,
                       generator=torch.Generator().manual_seed(cfg.data.seed), **cfg.model_kwargs)


def make_bev_loss_fn(cfg: BEVExperiment, device="cuda", group: Optional[DataGroup] = None) -> Callable:
    """``loss_fn(model, batch, generator) -> (loss, metrics)`` for the
    :class:`~lyft3d_tpu_torch.train.trainer.Trainer`: ``batch`` holds
    ``image`` ``(B, H, W, C)`` float32 and ``label`` ``(B, H, W)`` int on
    ``device``, the card by default (``"cpu"`` to run without one). The
    generator is not used (no dropout). Under a data-parallel ``group`` the
    batch is this rank's shard and the weighted CE's normaliser spans the
    global batch."""
    device = _training_device(device, "make_bev_loss_fn")
    class_weights = torch.tensor(cfg.class_weights, dtype=torch.float32, device=device)

    def loss_fn(model, batch, generator=None):
        logits, aux = model(batch["image"])
        return bev_segmentation_loss(logits, aux, batch["label"], class_weights, cfg.size_weight, group)

    return loss_fn


def make_bev_optimizer_fn(cfg: BEVExperiment) -> Callable:
    """``optimizer_fn(params)``: ``build_optimizer`` with ``cfg.optimizer``'s
    name, rate, weight decay, clip and accumulation."""
    opt = cfg.optimizer

    def optimizer_fn(params):
        return build_optimizer(params, opt.name, opt.lr, total_steps=opt.total_steps,
                               weight_decay=opt.weight_decay, clip_norm=opt.clip_norm,
                               grad_accum=opt.grad_accum)

    return optimizer_fn


def make_bev_eval_fn(cfg: BEVExperiment, val_ds: BEVImageDataset, device="cuda") -> Callable:
    """``eval_fn(state) -> {"loss": mean}``: the loss of each validation
    sample alone (batch 1), the module in eval mode (running statistics),
    then back in train mode."""
    loss_fn = make_bev_loss_fn(cfg, device)
    device = torch.device(device)

    def eval_fn(state):
        model = state.module
        model.eval()
        losses = []
        try:
            with torch.no_grad():
                for i in range(len(val_ds)):
                    x, y = val_ds.load(i)
                    batch = {"image": torch.from_numpy(np.ascontiguousarray(x[None])).to(device),
                             "label": torch.from_numpy(np.ascontiguousarray(y[None])).to(device)}
                    losses.append(float(loss_fn(model, batch)[0]))
        finally:
            model.train()
        return {"loss": float(np.mean(losses))}

    return eval_fn


def _init_from(model, cfg: BEVExperiment):
    """Shape-matching weights of the latest ``cfg.model`` checkpoint in
    ``cfg.init_from`` (a train state's snapshot, its float32 masters where
    the architectures are the same, or a bare ``state_dict``)."""
    snapshot, step = ckpt.restore_latest(cfg.init_from, name=cfg.model)
    if step is None:
        raise FileNotFoundError(f"init_from={cfg.init_from!r} has no {cfg.model!r} checkpoint")
    ckpt.load_partial(model, snapshot, verbose=True)


def _png_dataset(bev_dir: Path, with_map: bool, tokens: Sequence[str], augment: bool) -> BEVImageDataset:
    return BEVImageDataset(bev_dir, tokens, with_map=with_map, augment=augment)


def _fit_bev(group: Optional[DataGroup], cfg: BEVExperiment, dataset_fn: Callable, train_tokens, val_tokens,
             log_every: int, eval_every: int, num_workers: int, dtype: torch.dtype, device=None):
    """The step loop of :func:`train_bev` on one rank (``group``) or alone
    (``group=None``, on ``device``); returns ``(state, model)``."""
    device = group.device if group is not None else device
    train_ds = dataset_fn(train_tokens, augment=True)
    val_ds = dataset_fn(val_tokens, augment=False)
    reseed_for_rank(train_ds, group)  # each rank flips and cuts out with a stream of its own
    trainer = _bev_trainer(cfg, log_every, eval_every, dtype, device, val_ds, group)
    if trainer.lead:
        snapshot_config(cfg, cfg.model_dir)
    state = trainer.init_or_resume()
    opt = cfg.optimizer

    def assemble(take):
        # Every rank walks the same schedule of global batches and loads its
        # own slice of each.
        b = train_ds.assemble(shard_batch(group, take))
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    # Work items are cheap index chunks; imread + augmentation run on
    # parallel workers.
    batches = MappedPrefetcher(
        lambda: index_batches(len(train_ds), cfg.batch_size, steps=opt.total_steps, seed=cfg.data.seed),
        assemble, num_workers=num_workers, depth=4)
    state = trainer.fit(state, iter(batches))
    return state, trainer.model


def _bev_trainer(cfg: BEVExperiment, log_every: int, eval_every: int, dtype: torch.dtype, device,
                 val_ds: BEVImageDataset, group: Optional[DataGroup] = None) -> Trainer:
    model = build_bev_model(cfg, dtype, device)
    if cfg.init_from:
        _init_from(model, cfg)
    opt = cfg.optimizer
    tcfg = TrainerConfig(model_dir=cfg.model_dir, total_steps=opt.total_steps, log_every=log_every,
                         eval_every=eval_every, ckpt_every=eval_every)
    # Rank 0 evaluates the replicated weights alone, on its own card.
    return Trainer(model, make_bev_optimizer_fn(cfg), make_bev_loss_fn(cfg, device, group), tcfg,
                   eval_fn=make_bev_eval_fn(cfg, val_ds, device), group=group)


def _bev_rank(group: DataGroup, *args):
    _fit_bev(group, *args)


def train_bev(cfg: BEVExperiment, bev_dir, tokens=None, n_devices: Optional[int] = None,
              log_every: int = 50, eval_every: int = 500, num_workers: int = 4,
              dtype: torch.dtype = torch.bfloat16, device="cuda", dataset_fn: Optional[Callable] = None,
              backend: Optional[str] = None):
    """Train a BEV segmentation model from a generated PNG dataset; returns
    ``(state, model)``. ``device`` defaults to the card; pass ``"cpu"``
    (with float32) to run without one.

    ``dataset_fn(tokens, augment=...)`` builds the training and validation
    datasets, with ``BEVImageDataset``'s interface (``__len__``,
    ``assemble``, ``load``, an ``rng`` for the augmentation draws); by
    default a ``BEVImageDataset`` over ``bev_dir``'s PNGs. With one,
    ``tokens`` is required and ``bev_dir`` is not read. Under more than one
    rank it must pickle.

    ``n_devices``: data parallelism as the JAX trainer's, over
    :func:`~lyft3d_tpu_torch.parallel.mesh.make_data_group`'s rank count
    (``None``: every card, one rank on the CPU; the largest divisor of the
    batch size up to it). More than one rank spawns a process a rank, each
    loading its slice of every global batch, with BatchNorm statistics and
    the weighted CE's normaliser over the global batch; rank 0 evaluates and
    writes the checkpoints, and the state returned here is restored from the
    last of them. ``backend="gloo"`` runs the ranks on one card, the one
    ``device`` names (:func:`~lyft3d_tpu_torch.parallel.mesh.rank_placement`)."""
    device = _training_device(device, "train_bev")
    if dataset_fn is None:
        bev_dir = Path(bev_dir)
        dataset_fn = partial(_png_dataset, bev_dir, cfg.with_map)
        if tokens is None:
            tokens = sorted({p.name.rsplit("_", 1)[0] for p in bev_dir.glob("*_input.png")})
    elif tokens is None:
        raise ValueError("train_bev: a dataset_fn needs the tokens")
    train_tokens, val_tokens = split_tokens(list(tokens), cfg.data.seed)
    args = (cfg, dataset_fn, train_tokens, val_tokens, log_every, eval_every, num_workers, dtype)
    n = make_data_group(cfg.batch_size, n_devices, device, backend)
    if n == 1:
        return _fit_bev(None, *args, device=device)
    spawn(_bev_rank, n, args=args, **rank_placement(device, backend))
    val_ds = dataset_fn(val_tokens, augment=False)
    trainer = _bev_trainer(cfg, log_every, eval_every, dtype, device, val_ds)
    return trainer.init_or_resume(), trainer.model
