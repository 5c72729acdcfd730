"""Generic step-loop trainer: train state, checkpoints, logs (port of
``lyft3d_tpu/train/trainer.py``).

Step-based loop with periodic eval and checkpointing, best-val tracking,
auto-resume from the model_dir registry and checkpoint-on-interrupt. The
supplied ``loss_fn(model, batch, generator) -> (loss, metrics_dict)`` runs
the module; the module holds its parameters, so the JAX package's ``params``
argument and its ``_model_state`` convention have no counterpart (running
statistics are buffers of the module).

**Master parameters.** The flax parameters are float32 and each layer casts
them to its compute type. Here a module built in bfloat16 holds bfloat16
parameters, and the train state keeps a float32 master copy of each of them:
the gradient is cast up, the optimizer updates the masters, and the module's
parameters are refreshed from them after every step. Float32 parameters (a
float32 module, the heads) are their own masters.

**Data parallel.** Given a :class:`~lyft3d_tpu_torch.parallel.mesh.DataGroup`
(one rank of a :func:`~lyft3d_tpu_torch.parallel.mesh.spawn`), the trainer
computes what the JAX trainer computes over a mesh: its BatchNorms take
global statistics, the float32 master gradients are averaged over the ranks
in one flat bucket after ``push_grads`` (so ``grad_norm``, clipping and
gradient accumulation see the global gradient), and the metrics are averaged
over the ranks. Each rank's ``loss_fn`` sees its own shard of the global
batch and returns a loss whose mean over the ranks is the global one (see
``parallel/mesh.py``). Every rank reads the checkpoint to resume and then
takes rank 0's weights; only rank 0 logs, evaluates and writes checkpoints,
and the ranks wait for it after each.

**Tensor parallel.** Under a model axis (a module sharded by
:func:`~lyft3d_tpu_torch.parallel.tensor.tensor_parallel_params`), the
masters are slices as their parameters are, and a checkpoint holds the
whole model as one process would: the model ranks of data rank 0 gather
the slices of the module, the masters and the optimizer's slots, world rank
0 writes them, and every rank takes its own slice back on resume, so that a
checkpoint resumes with or without a model axis. Those model ranks also
evaluate together (the sharded layers' gathers run over their model group)
and take model rank 0's loss to decide on the best checkpoint. An interrupt
under a model axis writes no checkpoint: the gather needs every model rank,
and one may be gone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lyft3d_tpu_torch.parallel.mesh import (
    DataGroup,
    all_reduce_gradients,
    average_metrics,
    barrier,
    replicate,
    sync_batch_norms,
)
from lyft3d_tpu_torch.parallel import tensor as tp
from lyft3d_tpu_torch.train import checkpoint as ckpt
from lyft3d_tpu_torch.train.logging import MetricLog
from lyft3d_tpu_torch.train.optim import global_norm

__all__ = ["TrainState", "TrainerConfig", "Trainer"]


class TrainState:
    """(module, optimizer, step) with the float32 master parameters the
    optimizer works on."""

    def __init__(self, module: nn.Module, optimizer_fn: Callable):
        self.module = module
        own = set(self.master_names(module))
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.masters: List[nn.Parameter] = [
            tp.carry_shard(nn.Parameter(p.detach().float()), p) if n in own else p for n, p in named
        ]
        self.optimizer = optimizer_fn(self.masters)
        self.step = 0
        self.sharded = any(tp.shard_of(m) is not None for m in self.masters)

    @staticmethod
    def master_names(module: nn.Module, dtypes: Optional[Dict[str, torch.dtype]] = None) -> List[str]:
        """Names of the parameters of ``module`` that have a float32 master of
        their own, in the order in which the masters are kept and saved: the
        trainable ones not held in float32 (by their dtype in ``dtypes``, a
        name → dtype map of the module as it was trained, where given)."""
        dtypes = dtypes or {}
        return [n for n, p in module.named_parameters()
                if p.requires_grad and dtypes.get(n, p.dtype) != torch.float32]

    @staticmethod
    def masters_by_name(module: nn.Module, sd) -> Dict[str, torch.Tensor]:
        """The float32 masters of a snapshot (:meth:`state_dict`) by the name
        of their parameter in ``module``, a module built as the trained one
        was, in any dtype."""
        names = TrainState.master_names(module, {n: t.dtype for n, t in sd["model"].items()})
        if len(names) != len(sd["masters"]):
            raise ValueError(f"snapshot holds {len(sd['masters'])} master parameters for {len(names)} "
                             "non-float32 parameters")
        return dict(zip(names, sd["masters"]))

    def push_grads(self):
        """The module's gradients, cast up, onto the masters."""
        for p, m in zip(self.params, self.masters):
            if m is not p:
                m.grad = None if p.grad is None else p.grad.float()

    @torch.no_grad()
    def pull_params(self):
        """The masters' values, cast down, into the module."""
        for p, m in zip(self.params, self.masters):
            if m is not p:
                p.copy_(m)

    def state_dict(self):
        """The snapshot; of the whole model where the state is sharded (a
        collective: every rank of the model group calls it)."""
        own = [m for p, m in zip(self.params, self.masters) if m is not p]
        if not self.sharded:
            return {"model": self.module.state_dict(), "masters": [m.detach() for m in own],
                    "optimizer": self.optimizer.state_dict(), "step": int(self.step)}
        return {
            "model": tp.gather_tensor_parallel_state(self.module),
            "masters": [tp.unshard(m.detach(), m).contiguous().clone() for m in own],
            "optimizer": tp.gather_optimizer_state(self.optimizer),
            "step": int(self.step),
        }

    def load_state_dict(self, sd):
        """Load a snapshot of the whole model, each sharded tensor's slice where
        the state is sharded."""
        own = [m for p, m in zip(self.params, self.masters) if m is not p]
        if len(own) != len(sd["masters"]):
            raise ValueError(f"checkpoint holds {len(sd['masters'])} master parameters, the state {len(own)}")
        self.module.load_state_dict(tp.slice_tensor_parallel_state(self.module, sd["model"]))
        with torch.no_grad():
            for m, saved in zip(own, sd["masters"]):
                m.copy_(tp.local_slice(saved, m))
        self.optimizer.load_state_dict(tp.slice_optimizer_state(self.optimizer, sd["optimizer"]))
        self.step = int(sd["step"])


@dataclass
class TrainerConfig:
    model_dir: str = "/tmp/lyft3d_model"
    total_steps: int = 1000
    log_every: int = 50
    eval_every: int = 500
    ckpt_every: int = 500
    max_to_keep: int = 8
    ckpt_name: str = "model"
    use_tensorboard: bool = False


class _Silent:
    """The log of a rank other than 0: it writes nothing."""

    def log_metrics(self, *args, **kwargs):
        pass

    def log_text(self, *args, **kwargs):
        pass


class Trainer:
    """``optimizer_fn(params) -> torch.optim.Optimizer`` builds the optimizer
    over the master parameters (e.g. ``lambda p: build_optimizer(p, "adam",
    1e-3)``). ``group``: this process's rank of a data-parallel run, or
    ``None`` to train alone."""

    def __init__(self, model: nn.Module, optimizer_fn: Callable, loss_fn: Callable,
                 config: TrainerConfig, eval_fn: Optional[Callable] = None,
                 group: Optional[DataGroup] = None):
        self.model = sync_batch_norms(model, group) if group is not None else model
        self.optimizer_fn = optimizer_fn
        self.loss_fn = loss_fn
        self.cfg = config
        self.eval_fn = eval_fn
        self.group = group
        self.lead = group is None or group.world_rank == 0
        # The model ranks of data rank 0: they evaluate and gather what the lead writes.
        self.writer = group is None or group.rank == 0
        self.log = MetricLog(config.model_dir, use_tensorboard=config.use_tensorboard) if self.lead else _Silent()
        self.best_val = float("inf")

    def step_fn(self, state: TrainState, batch, generator=None):
        """One optimizer step on ``batch``; returns ``(state, metrics)`` with
        the metrics as detached tensors (``loss`` and ``grad_norm`` added)."""
        model = state.module
        model.train()
        for p in state.params:
            p.grad = None
        loss, metrics = self.loss_fn(model, batch, generator)
        loss.backward()
        metrics = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in dict(metrics).items()}
        metrics["loss"] = loss.detach()
        state.push_grads()
        all_reduce_gradients(self.group, state.masters)
        metrics = average_metrics(self.group, metrics)
        metrics["grad_norm"] = global_norm([m.grad for m in state.masters], state.masters)
        state.optimizer.step()
        state.pull_params()
        state.step += 1
        return state, metrics

    # -- lifecycle -----------------------------------------------------------
    def init_or_resume(self) -> TrainState:
        state = TrainState(self.model, self.optimizer_fn)
        _, step = ckpt.restore_latest(self.cfg.model_dir, state, name=self.cfg.ckpt_name)
        if step is not None:
            self.log.log_text(f"resumed from step {step}", step)
        replicate(self.group, [self.model, state.masters])
        return state

    def _save(self, state: TrainState, name: str, max_to_keep: int, wait: bool = True):
        if self.writer:
            sd = state.state_dict()
            if self.lead:
                ckpt.save(self.cfg.model_dir, sd, name=name, global_step=int(state.step),
                          max_to_keep=max_to_keep)
        if wait:
            barrier(self.group)

    def _model_rank_0(self, x: float) -> float:
        """Model rank 0's ``x`` on every rank of this model group."""
        if self.group is None or self.group.model_size == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=self.group.device)
        dist.broadcast(t, src=self.group.rank * self.group.model_size, group=self.group.model_group)
        return float(t.item())

    def fit(self, state: TrainState, batches: Iterable, generator=None) -> TrainState:
        """Run the step loop over ``batches`` (a host iterator of batches the
        ``loss_fn`` takes)."""
        cfg = self.cfg
        t0 = time.time()
        window = []
        try:
            for batch in batches:
                if state.step >= cfg.total_steps:
                    break
                state, metrics = self.step_fn(state, batch, generator)
                window.append(metrics)

                step = state.step
                if step % cfg.log_every == 0:
                    m = {k: (float(v) if torch.is_tensor(v) else v) for k, v in window[-1].items()}
                    m["runtime/steptime"] = (time.time() - t0) / max(len(window), 1)
                    t0, window = time.time(), []
                    self.log.log_metrics({"train": m}, step)
                if cfg.eval_every and step % cfg.eval_every == 0 and self.eval_fn:
                    if self.writer:
                        val = self.eval_fn(state)
                        self.log.log_metrics({"eval": val}, step)
                        vloss = self._model_rank_0(float(val.get("loss", np.inf)))
                        if vloss < self.best_val:
                            self.best_val = vloss
                            self._save(state, "best", 2, wait=False)
                    barrier(self.group)
                if cfg.ckpt_every and step % cfg.ckpt_every == 0:
                    self._save(state, cfg.ckpt_name, cfg.max_to_keep)
        except (KeyboardInterrupt, Exception):
            # Checkpoint on failure, then re-raise (no wait: another rank
            # may be gone; so no gather of slices either).
            if state.sharded:
                self.log.log_text(f"interrupted at step {int(state.step)}; no checkpoint under a model axis")
                raise
            self._save(state, cfg.ckpt_name, cfg.max_to_keep, wait=False)
            self.log.log_text(f"interrupted at step {int(state.step)}; checkpoint saved")
            raise
        self._save(state, cfg.ckpt_name, cfg.max_to_keep)
        return state
