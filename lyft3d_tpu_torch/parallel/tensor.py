"""Tensor parallelism over the model axis (port of the JAX
``tensor_parallel_params``).

The JAX rule shards the last axis of every flax ``kernel`` leaf of two or
more dimensions whose output features are at least ``min_features`` and
divide the ``model`` axis; everything else, biases included, is replicated.
Under ``jit`` XLA then partitions the computation and the function stays the
one-device function. Here the same rule is read on the torch layout, per
module type, as ``utils/flax_params.py`` maps the leaves: the output
features are dim 0 of an ``nn.Conv2d`` or ``nn.Linear`` weight; a layer of
the port whose ``kernel`` is laid out otherwise names the dim in its
``kernel_out_dim`` and computes its convolution in a ``conv`` method (the
sparse conv layers: the last dim of their ``(27, Cin, Cout)`` kernels).

Each selected layer is made column-parallel on its model group: model rank
``m`` keeps output features ``[m·k, (m+1)·k)`` of its weight (``k = Cout/M``)
as the parameter, computes those outputs on the full input, and the outputs
are all-gathered along the channel dimension, so that every layer after it
sees the full tensor and the function is unchanged. Two autograd functions
carry the gradients: the input's backward sums the ranks' partial input
gradients over the model group (each rank's slice gives only its part of
``dX``), and the gather's backward takes this rank's slice of the output
gradient (the layers after the gather run redundantly on every model rank,
so their gradients are whole on each). A bias stays whole and is added
after the gather. A grouped or depthwise conv computes its slice from the
input channels of the groups the slice touches; where the slice cuts a group
(``groups % M != 0``), the cut group is a conv of its own.

A sharded weight carries its :class:`Shard` (``shard_of``): its gradient
stays on its model rank and is averaged over its data group like every
other gradient, and the optimizer's global-norm clip sums the slices'
squares over the model group
(:func:`~lyft3d_tpu_torch.train.optim.global_norm`).
:func:`gather_tensor_parallel_state` puts the slices back together into the
full ``state_dict`` (to compare with one process, to export or to
checkpoint), and :func:`slice_tensor_parallel_state` takes each rank's slice
of a full one; :func:`gather_optimizer_state` and
:func:`slice_optimizer_state` do the same for the per-element slots of an
optimizer (moments, slow weights) of the sharded parameters.
"""

from __future__ import annotations

import types
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Shard",
    "COLLECTIVES",
    "shard_of",
    "carry_shard",
    "tensor_parallel_selection",
    "tensor_parallel_params",
    "unshard",
    "local_slice",
    "gather_tensor_parallel_state",
    "slice_tensor_parallel_state",
    "gather_optimizer_state",
    "slice_optimizer_state",
]

SHARD_ATTR = "tensor_shard"

# The column-parallel layers' all-gathers (forward) and input-gradient
# all-reduces (backward) in this process, and their bytes: the gathered
# tensors' and the reduced ones'. Gathers of whole states are not counted.
COLLECTIVES = {"all_gather": 0, "all_gather_bytes": 0, "all_reduce": 0, "all_reduce_bytes": 0}


@dataclass(frozen=True)
class Shard:
    """This rank's slice ``[lo, hi)`` of dimension ``dim`` of a weight with
    ``full`` output features, over the model group of ``group`` (a
    :class:`~lyft3d_tpu_torch.parallel.mesh.DataGroup`)."""

    dim: int
    lo: int
    hi: int
    full: int
    group: Any


def shard_of(t) -> Optional[Shard]:
    """The :class:`Shard` of a tensor-parallel parameter, else ``None``."""
    return getattr(t, SHARD_ATTR, None)


def carry_shard(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` (a copy of ``old``, e.g. its float32 master) marked as the same
    slice as ``old``; returns ``new``."""
    shard = shard_of(old)
    if shard is not None:
        setattr(new, SHARD_ATTR, shard)
    return new


def _kernel_out_dim(module: nn.Module, name: str, p: torch.Tensor) -> Optional[int]:
    """The torch dim of ``p`` that is the last axis of its flax ``kernel``
    leaf, or ``None`` where ``p`` maps to no kernel (a bias, a norm's scale)."""
    if isinstance(module, (nn.Conv2d, nn.Linear)) and name == "weight":
        return 0
    if name == "kernel" and getattr(module, "kernel_out_dim", None) is not None:
        return module.kernel_out_dim
    if p.dim() >= 2:
        raise TypeError(f"tensor parallelism: no kernel layout known for {type(module).__name__}.{name} "
                        f"{tuple(p.shape)}")
    return None


def tensor_parallel_selection(module: nn.Module, model_parallel: int,
                              min_features: int = 256) -> Dict[str, Tuple[nn.Module, str, int]]:
    """The JAX rule on ``module``: ``{parameter name: (layer, attribute, dim)}``
    of every weight that ``model_parallel`` model ranks shard on ``dim`` (a
    ``meta`` module will do: only shapes are read)."""
    chosen = {}
    for mname, layer in module.named_modules():
        for pname, p in layer.named_parameters(recurse=False):
            dim = _kernel_out_dim(layer, pname, p)
            if dim is None:
                continue
            out = p.shape[dim]
            if model_parallel > 1 and out >= min_features and out % model_parallel == 0:
                chosen[f"{mname}.{pname}" if mname else pname] = (layer, pname, dim)
    return chosen


# ----------------------------------------------------------------- collectives


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every model rank, concatenated along ``dim`` in rank order.
    The ranks' pieces are gathered with ``dim`` innermost (a ``channels_last``
    map's NHWC view needs no copy) and concatenated there: one copy."""
    y = x.movedim(dim, -1).contiguous()
    parts = [torch.empty_like(y) for _ in range(group.model_size)]
    dist.all_gather(parts, y, group=group.model_group)
    return torch.cat(parts, -1).movedim(-1, dim)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the input gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group.model_group)
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["all_reduce_bytes"] += grad.numel() * grad.element_size()
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's slice of the
    output gradient."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        out = _all_gather(x, dim, shard.group)
        COLLECTIVES["all_gather"] += 1
        COLLECTIVES["all_gather_bytes"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return grad.narrow(ctx.dim, s.lo, s.hi - s.lo), None, None


# ---------------------------------------------------------- column-parallel layers


def _conv_pieces(lo: int, hi: int, out_per_group: int, in_per_group: int) -> List[Tuple[int, ...]]:
    """Output channels ``[lo, hi)`` of a grouped conv as runs that each read
    one block of input channels: ``(out_lo, out_hi, in_lo, in_hi, groups)``.
    Whole groups in a row make one run; a group the slice cuts is a run of
    its own."""
    pieces, o = [], lo
    while o < hi:
        g = o // out_per_group
        whole = (hi - o) // out_per_group if o % out_per_group == 0 else 0
        if whole:
            pieces.append((o, o + whole * out_per_group, g * in_per_group, (g + whole) * in_per_group, whole))
            o += whole * out_per_group
        else:
            end = min((g + 1) * out_per_group, hi)
            pieces.append((o, end, g * in_per_group, (g + 1) * in_per_group, 1))
            o = end
    return pieces


def _conv_forward(self, x, weight, bias):
    """``nn.Conv2d._conv_forward`` of a column-parallel conv (``SameConv2d``
    pads before it, as for the whole layer)."""
    s = shard_of(weight)
    x = _CopyToModel.apply(x, s.group)
    groups = self.groups
    outs = [F.conv2d(x[:, ilo:ihi], weight[olo - s.lo:ohi - s.lo], None, self.stride, self.padding,
                     self.dilation, g)
            for olo, ohi, ilo, ihi, g in _conv_pieces(s.lo, s.hi, s.full // groups, self.in_channels // groups)]
    y = _GatherFromModel.apply(outs[0] if len(outs) == 1 else torch.cat(outs, 1), 1, s)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def _linear_forward(self, x):
    s = shard_of(self.weight)
    y = _GatherFromModel.apply(F.linear(_CopyToModel.apply(x, s.group), self.weight), -1, s)
    return y if self.bias is None else y + self.bias


def _sparse_conv(self, features, *args):
    """A sparse layer's ``conv`` on its kernel's slice; the first output
    (``(…, Cout)`` rows) gathered, the rest (a strided layer's activity)
    computed alike on every rank."""
    s = shard_of(self.kernel)
    out = type(self).conv(self, _CopyToModel.apply(features, s.group), *args)
    if isinstance(out, tuple):
        return (_GatherFromModel.apply(out[0], -1, s),) + out[1:]
    return _GatherFromModel.apply(out, -1, s)


def _make_column_parallel(layer: nn.Module) -> None:
    if isinstance(layer, nn.Conv2d):
        if layer.padding_mode != "zeros":
            raise NotImplementedError(f"tensor parallelism: padding_mode {layer.padding_mode!r}")
        layer._conv_forward = types.MethodType(_conv_forward, layer)
    elif isinstance(layer, nn.Linear):
        layer.forward = types.MethodType(_linear_forward, layer)
    elif getattr(layer, "kernel_out_dim", None) is not None:
        layer.conv = types.MethodType(_sparse_conv, layer)
    else:  # _kernel_out_dim names no other type
        raise TypeError(type(layer).__name__)


@torch.no_grad()
def tensor_parallel_params(group, module: nn.Module, min_features: int = 256) -> nn.Module:
    """Shard the wide layers of ``module`` over the model axis of ``group``
    (a :class:`~lyft3d_tpu_torch.parallel.mesh.DataGroup` from
    ``spawn(..., model_parallel=M)``), in place, by the JAX rule (the module
    docstring); returns ``module``. Every rank builds the full module with
    the same weights first (a seed, or ``load_flax_params`` of one tree);
    each then keeps its slice. Without a model axis (``group`` ``None`` or
    ``model_size == 1``) nothing changes."""
    if group is None or group.model_size == 1:
        return module
    m_size, m = group.model_size, group.model_rank
    for name, (layer, pname, dim) in tensor_parallel_selection(module, m_size, min_features).items():
        p = getattr(layer, pname)
        if shard_of(p) is not None:
            raise ValueError(f"tensor_parallel_params: {name} is sharded already")
        full = p.shape[dim]
        k = full // m_size
        piece = nn.Parameter(p.detach().narrow(dim, m * k, k).clone(), requires_grad=p.requires_grad)
        setattr(piece, SHARD_ATTR, Shard(dim, m * k, (m + 1) * k, full, group))
        setattr(layer, pname, piece)
        _make_column_parallel(layer)
    return module


@torch.no_grad()
def unshard(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` (a value or gradient of ``param``) is
    this rank's slice, gathered over the model group (a collective: every
    rank of the group calls it); ``t`` itself where ``param`` is not
    sharded."""
    s = shard_of(param)
    return t if s is None else _all_gather(t.detach(), s.dim, s.group)


@torch.no_grad()
def gather_tensor_parallel_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded weight gathered whole (a
    collective: every rank of the model group calls it), as detached copies."""
    return {key: unshard(t.detach(), t).contiguous().clone()
            for key, t in module.state_dict(keep_vars=True).items()}


def local_slice(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t``, a whole tensor of the shape ``param``
    (a tensor-parallel slice) was cut from; ``t`` itself where ``param`` is
    not sharded. The inverse of :func:`unshard`, with no collective."""
    s = shard_of(param)
    if s is None:
        return t
    if t.shape[s.dim] != s.full:
        raise ValueError(f"local_slice: {tuple(t.shape)} is not whole on dim {s.dim} ({s.full})")
    return t.narrow(s.dim, s.lo, s.hi - s.lo)


def slice_tensor_parallel_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` (:func:`gather_tensor_parallel_state`'s, or one
    process's) cut to this rank's slices of ``module``, for
    ``module.load_state_dict``."""
    own = module.state_dict(keep_vars=True)
    return {k: local_slice(t, own[k]) if k in own else t for k, t in state.items()}


def _map_slots(optimizer, sd, fn):
    """``sd`` (an optimizer ``state_dict``) with ``fn(slot, param)`` applied
    to every tensor slot of a sharded parameter that is not a scalar, in the
    order ``state_dict`` numbers the parameters; the other entries as they
    are."""
    state = dict(sd["state"])
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        if i in state and shard_of(p) is not None:
            state[i] = {k: fn(v, p) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in state[i].items()}
    return {**sd, "state": state}


@torch.no_grad()
def gather_optimizer_state(optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with every per-element slot of a sharded
    parameter gathered whole (a collective: every rank of the model group
    calls it), as one process would hold it."""
    return _map_slots(optimizer, optimizer.state_dict(), lambda v, p: unshard(v, p).contiguous().clone())


def slice_optimizer_state(optimizer, sd: Dict[str, Any]) -> Dict[str, Any]:
    """A whole optimizer ``state_dict`` (:func:`gather_optimizer_state`'s, or
    one process's) cut to this rank's slices, for ``optimizer.load_state_dict``."""
    return _map_slots(optimizer, sd, local_slice)
