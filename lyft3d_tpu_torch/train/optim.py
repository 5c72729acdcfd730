"""Optimizers and LR schedules (port of ``lyft3d_tpu/train/optim.py``).

The JAX package builds optax chains; here one :class:`ChainOptimizer`
(a ``torch.optim.Optimizer``) applies the same stages in the same order with
optax's formulas, so that equal parameters and equal gradients give equal
updates, step by step:

    gradient accumulation (mean over k micro-steps, zero update between)
    → global-norm clip → [L2 term] → rule → [decoupled decay] → −lr
    → [lookahead]

Rules: ``adam`` (eps outside the bias-corrected square root), ``radam``
(optax's rectification, threshold ``ro ≥ 5``), ``sgd`` (momentum trace).
``lr`` and ``b1`` may be schedules, functions of the inner step count
starting at 0. Schedules are plain functions ``step -> float`` with optax's
arithmetic. A parameter without a gradient takes a zero gradient, as every
leaf has one in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from lyft3d_tpu_torch.parallel.tensor import shard_of

__all__ = [
    "ChainOptimizer",
    "ranger",
    "radam",
    "lookahead",
    "one_cycle",
    "one_cycle_momentum",
    "cosine_warm_restarts",
    "adam_one_cycle",
    "build_optimizer",
    "global_norm",
]

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


# ------------------------------------------------------------------ schedules


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        count = min(step, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def one_cycle(lr_max: float, total_steps: int, pct_start: float = 0.4,
              div_factor: float = 10.0, final_div: float = 1e4) -> Schedule:
    """The one-cycle LR schedule: cosine warm-up ``lr_max / div_factor`` →
    ``lr_max`` over ``pct_start`` of the steps, cosine anneal to
    ``lr_max / (div_factor · final_div)``."""
    init = lr_max / div_factor
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = (init, init * div_factor, init * div_factor / (div_factor * final_div))

    def schedule(step: int) -> float:
        if step >= bounds[-1]:
            return values[-1]
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                return (1.0 - math.cos(math.pi * pct)) / 2.0 * (end - start) + start
        return 0.0

    return schedule


def one_cycle_momentum(total_steps: int, pct_start: float = 0.4, moms=(0.95, 0.85)) -> Schedule:
    """The momentum schedule paired with :func:`one_cycle` (high → low → high)."""
    up, down = moms
    turn = int(total_steps * pct_start)
    warm = _cosine_decay(up, max(turn, 1), alpha=down / up)
    anneal = _cosine_decay(down, max(total_steps - turn, 1), alpha=up / down)
    return _join([warm, anneal], [turn])


def cosine_warm_restarts(lr_max: float, period: int, t_mult: int = 1, cycles: int = 8,
                         min_scale: float = 0.0) -> Schedule:
    """Cosine schedule with warm restarts: ``cycles`` cosine decays from
    ``lr_max``, each ``t_mult`` times as long as the one before."""
    schedules, boundaries, t, acc = [], [], period, 0
    for _ in range(cycles):
        schedules.append(_cosine_decay(lr_max, t, alpha=min_scale))
        acc += t
        boundaries.append(acc)
        t *= t_mult
    return _join(schedules, boundaries[:-1])


# ------------------------------------------------------------------ optimizer


def global_norm(tensors, params=None) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` in float32 over a sequence of tensors. ``params``:
    the parameters the tensors belong to (as gradients or updates), in the
    same order. Where one is a slice of a tensor-parallel weight
    (:func:`~lyft3d_tpu_torch.parallel.tensor.tensor_parallel_params`), the
    slices' squares are summed over the model group, so that every rank gets
    the whole model's norm; a replicated tensor counts once."""
    params = [None] * len(tensors) if params is None else list(params)
    pairs = [(t, shard_of(p)) for t, p in zip(tensors, params) if t is not None]
    if not pairs:
        return torch.zeros(())
    sharded = [(t, s) for t, s in pairs if s is not None]
    if not sharded:
        return torch.sqrt(sum((t.float() * t.float()).sum() for t, _ in pairs))
    whole = sum((t.float() * t.float()).sum() for t, s in sharded)
    dist.all_reduce(whole, group=sharded[0][1].group.model_group)
    for t, s in pairs:
        if s is None:
            whole = whole + (t.float() * t.float()).sum()
    return torch.sqrt(whole)


def _value(x: ScalarOrSchedule, step: int) -> float:
    return float(x(step)) if callable(x) else float(x)


class ChainOptimizer(torch.optim.Optimizer):
    """The stages of the module docstring as one optimizer.

    ``rule``: "adam", "radam" or "sgd". ``l2``: weight decay added to the
    gradient before the rule (optax ``add_decayed_weights`` in front);
    ``decoupled_decay``: weight decay added to the rule's output (AdamW).
    ``lookahead``: ``(sync_period, slow_step)`` or None. Counters live in
    ``param_groups[0]`` and the moments in ``state``, so ``state_dict()``
    holds everything a resume needs.
    """

    def __init__(self, params, rule: str, lr: ScalarOrSchedule, b1: ScalarOrSchedule = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, momentum: Optional[float] = None,
                 l2: float = 0.0, decoupled_decay: float = 0.0, clip_norm: Optional[float] = None,
                 grad_accum: int = 1, lookahead: Optional[tuple] = None):
        if rule not in ("adam", "radam", "sgd"):
            raise KeyError(rule)
        defaults = dict(count=0, mini_step=0, lookahead_step=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("ChainOptimizer takes one parameter group")
        self.rule, self.lr, self.b1, self.b2, self.eps = rule, lr, b1, b2, eps
        self.momentum, self.l2, self.decoupled_decay = momentum, l2, decoupled_decay
        self.clip_norm, self.grad_accum, self.lookahead = clip_norm, grad_accum, lookahead

    def _slot(self, p, name):
        st = self.state[p]
        if name not in st:
            st[name] = p.detach().clone() if name == "slow" else torch.zeros_like(p)
        return st[name]

    def _rule_update(self, p, g, count: int, b1: float):
        """The rule's direction for gradient ``g`` at inner step ``count``
        (1-based, already incremented)."""
        if self.rule == "sgd":
            if self.momentum is None:
                return g
            trace = self._slot(p, "trace")
            trace.mul_(self.momentum).add_(g)
            return trace
        b2 = self.b2
        mu, nu = self._slot(p, "mu"), self._slot(p, "nu")
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        mu_hat = mu / (1.0 - b1 ** count)
        nu_hat = nu / (1.0 - b2 ** count)
        if self.rule == "adam":
            return mu_hat / (torch.sqrt(nu_hat) + self.eps)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** count
        ro = ro_inf - 2.0 * count * b2t / (1.0 - b2t)
        if ro < 5.0:
            return mu_hat
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return r * mu_hat / (torch.sqrt(nu_hat) + self.eps)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = group["params"]
        # Lookahead's slow weights start as a copy of the initial parameters.
        if self.lookahead is not None:
            for p in params:
                self._slot(p, "slow")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]

        if self.grad_accum > 1:
            mini = group["mini_step"]
            for p, g in zip(params, grads):
                acc = self._slot(p, "acc")
                acc.add_((g - acc) / (mini + 1))
            if mini + 1 < self.grad_accum:
                group["mini_step"] = mini + 1
                return loss
            group["mini_step"] = 0
            grads = [self._slot(p, "acc").clone() for p in params]
            for p in params:
                self._slot(p, "acc").zero_()

        if self.clip_norm:
            norm = global_norm(grads, params)
            if not bool(norm < self.clip_norm):
                grads = [(g / norm.to(g.dtype)) * self.clip_norm for g in grads]

        step0 = group["count"]
        lr, b1 = _value(self.lr, step0), _value(self.b1, step0)
        count = step0 + 1
        group["count"] = count
        updates = []
        for p, g in zip(params, grads):
            if self.l2:
                g = g + self.l2 * p
            u = self._rule_update(p, g, count, b1)
            if self.decoupled_decay:
                u = u + self.decoupled_decay * p
            updates.append(-lr * u)

        if self.lookahead is None:
            for p, u in zip(params, updates):
                p.add_(u)
            return loss
        sync_period, slow_step = self.lookahead
        group["lookahead_step"] += 1
        sync = group["lookahead_step"] % sync_period == 0
        for p, u in zip(params, updates):
            fast = p + u
            if sync:
                slow = self._slot(p, "slow")
                slow.add_(slow_step * (fast - slow))
                p.copy_(slow)
            else:
                p.copy_(fast)
        return loss


# --------------------------------------------------------------- constructors


def radam(params, learning_rate, b1: float = 0.95, b2: float = 0.999, eps: float = 1e-5,
          weight_decay: float = 0.0, **chain):
    """Rectified Adam, with the weight decay as an L2 term in front."""
    return ChainOptimizer(params, "radam", learning_rate, b1=b1, b2=b2, eps=eps, l2=weight_decay, **chain)


def lookahead(inner: ChainOptimizer, sync_period: int = 6, slow_step: float = 0.5) -> ChainOptimizer:
    """Lookahead around ``inner``: every ``sync_period`` steps (counted from
    1) the slow weights move ``slow_step`` of the way to the fast ones and
    the parameters take their value. The slow weights live in the optimizer
    state."""
    inner.lookahead = (sync_period, slow_step)
    return inner


def ranger(params, learning_rate, sync_period: int = 6, slow_step: float = 0.5, b1: float = 0.95,
           b2: float = 0.999, eps: float = 1e-5, weight_decay: float = 0.0, **chain):
    """Ranger = RAdam + Lookahead."""
    return lookahead(radam(params, learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                           **chain), sync_period, slow_step)


def adam_one_cycle(params, lr_max: float, total_steps: int, weight_decay: float = 1e-2,
                   pct_start: float = 0.4, clip_norm: Optional[float] = None, **chain):
    """The ``adam_onecycle`` configuration: weight decay as an L2 term in
    front of Adam (b2 = 0.99), one-cycle learning rate and momentum, the
    global-norm clip in front of it all."""
    return ChainOptimizer(
        params, "adam", one_cycle(lr_max, total_steps, pct_start),
        b1=one_cycle_momentum(total_steps, pct_start), b2=0.99, l2=weight_decay,
        clip_norm=clip_norm, **chain,
    )


def build_optimizer(params, name: str, lr, total_steps: int = 0, weight_decay: float = 0.0,
                    clip_norm: Optional[float] = None, grad_accum: int = 1, **kwargs):
    """Config-driven construction, the JAX package's switch with ``params``
    in front. As there, ``clip_norm`` does not reach ``adam_onecycle`` through
    this function (pass it to :func:`adam_one_cycle` for a clipped one)."""
    chain = dict(grad_accum=grad_accum)
    if name == "adam_onecycle":
        return adam_one_cycle(params, lr, total_steps, weight_decay=weight_decay, **kwargs, **chain)
    chain["clip_norm"] = clip_norm
    if name == "ranger":
        return ranger(params, lr, weight_decay=weight_decay, **kwargs, **chain)
    if name == "radam":
        return radam(params, lr, weight_decay=weight_decay, **kwargs, **chain)
    if name == "adam":
        return ChainOptimizer(params, "adam", lr, **kwargs, **chain)
    if name == "adamw":
        return ChainOptimizer(params, "adam", lr, decoupled_decay=weight_decay, **kwargs, **chain)
    if name == "sgd":
        return ChainOptimizer(params, "sgd", lr, momentum=kwargs.pop("momentum", 0.9), **kwargs, **chain)
    raise KeyError(name)
