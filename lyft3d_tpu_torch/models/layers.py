"""Shared building blocks: ConvNormAct, SE gate, ASPP, decoder UpBlock
(port of ``lyft3d_tpu/models/layers.py``).

Layers run NCHW (``channels_last`` in memory on the card); the models'
``forward`` takes and returns the JAX package's NHWC layout. Numerics follow
the flax modules:

- convs pad symmetrically, ``dilation·(k−1)//2`` each side (torch style);
- GroupNorm uses ``eps=1e-6``, :func:`_num_groups` groups and flax's
  one-pass variance (:class:`GroupNorm`), LayerNorm the same statistics over
  the last dim (:class:`LayerNorm`); BatchNorm uses ``eps=1e-5``, flax's
  momentum 0.99 and its biased one-pass batch variance, with float32 running
  statistics (:class:`BatchNorm`);
- bilinear resizes use half-pixel centres (``align_corners=False``) and
  antialias when they shrink, as ``jax.image.resize`` does;
- the few flax layers that pad ``"SAME"`` (a depthwise conv, two stem
  max-pools, an average pool) pad as flax does: ``pad_lo = total // 2``,
  the rest after (:func:`same_pads`), which at stride 2 on an even size is
  ``(0, 1)``, not the symmetric ``(1, 1)``.

The flax modules infer their input width; here it is an explicit first
argument. ``PackedGroupedConv`` (a TPU layout of the grouped conv) has no
counterpart: a grouped ``nn.Conv2d`` computes the same function.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = [
    "upsample2x",
    "resize_to",
    "same_pads",
    "pad_same",
    "max_pool_same",
    "avg_pool_same",
    "SameConv2d",
    "ConvNormAct",
    "LayerNorm",
    "BatchNorm",
    "SEModule",
    "ASPP",
    "UpBlock",
    "init_params",
]

NORM_TYPES = ("group", "batch", "folded")
GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm default
LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm default
BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm default
BATCH_NORM_MOMENTUM = 0.99  # flax: running = 0.99·running + 0.01·batch


def resize_to(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``hw``, antialiased when shrinking."""
    h, w = x.shape[-2:]
    hw = (int(hw[0]), int(hw[1]))
    if (h, w) == hw:
        return x
    shrink = hw[0] < h or hw[1] < w
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False, antialias=shrink)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    return resize_to(x, (2 * h, 2 * w))


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """flax's ``"SAME"`` padding of one spatial dim: the output has
    ``ceil(size / stride)`` positions; of the padding this needs,
    ``total // 2`` goes before and the rest after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded for a ``"SAME"`` window; ``value`` fills the pad."""
    (t, b), (l, r) = (same_pads(n, kernel, stride, dilation) for n in x.shape[-2:])
    if not (t or b or l or r):
        return x
    return F.pad(x, (l, r, t, b), value=value)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(padding="SAME")``: the pad never wins a max."""
    return F.max_pool2d(pad_same(x, kernel, stride, value=float("-inf")), kernel, stride)


def avg_pool_same(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """flax ``nn.avg_pool(padding="SAME")``: zeros padded and counted in every
    window's mean (flax's ``count_include_pad=True``)."""
    return F.avg_pool2d(pad_same(x, kernel, stride), kernel, stride)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``"SAME"`` padding (:func:`same_pads`); its
    own ``padding`` stays 0."""

    def forward(self, x):
        return self._conv_forward(pad_same(x, self.kernel_size[0], self.stride[0], self.dilation[0]),
                                  self.weight, self.bias)


def _num_groups(features: int) -> int:
    for g in (32, 16, 8, 4, 2, 1):
        if features % g == 0:
            return g
    return 1


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with flax's statistics: float32 reductions and the
    one-pass variance ``E[x²] − E[x]²`` clipped at 0 (flax's
    ``use_fast_variance=True``), then ``(x − mean)·(rsqrt(var + eps)·scale) + bias``.
    On sparse BEV inputs, where a group's mean dwarfs its spread, the
    one-pass variance loses digits; computing it the same way keeps the port
    next to the reference."""

    def forward(self, x):
        n, c = x.shape[:2]
        g = self.num_groups
        xg = x.float().unflatten(1, (g, c // g))  # a view, also for channels_last
        dims = (2, 3, 4)
        mean = xg.mean(dim=dims, keepdim=True)
        var = ((xg * xg).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().view(g, c // g, 1, 1)
        y = (xg - mean) * mul + self.bias.float().view(g, c // g, 1, 1)
        return y.flatten(1, 2).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last dim with flax's statistics: float32
    reductions, the one-pass variance ``E[x²] − E[x]²`` clipped at 0, eps
    1e-6, then ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` in float32,
    cast back to the input's dtype."""

    def __init__(self, features: int, eps: float = LAYER_NORM_EPS, device=None, dtype=None):
        super().__init__(features, eps=eps, device=device, dtype=dtype)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's ``nn.BatchNorm`` semantics.

    Train mode: statistics over (N, H, W) in float32 (float64 stays float64),
    the mean and the biased one-pass variance ``E[x²] − E[x]²`` clipped at 0
    (flax's ``use_fast_variance=True``); the input is normalised with them,
    and the running buffers become ``0.99·running + 0.01·batch`` (flax's
    momentum, the biased variance; torch's would be 0.9 and the unbiased
    one). The
    batch statistics of the last train-mode call stay in ``batch_stats``
    (``train/swa.py::bn_update`` averages them). Eval mode: the running
    buffers. Both normalise as flax does, ``(x − mean)·(rsqrt(var + eps)·scale)
    + bias`` in float32, cast back to the input's dtype. The running buffers
    are float32 whatever the module's dtype, as flax keeps ``batch_stats``:
    every cast of the module (``.to(dtype)``, ``.bfloat16()``, …) leaves them
    float32 with their values (in bfloat16, ``0.99·r + 0.01·b`` rounds back
    to ``r`` unless ``b`` is far from ``r``); ``num_batches_tracked`` is not
    used.

    ``channel_dim`` is the features' dimension: 1 for NCHW maps, −1 for the
    ``(…, C)`` activations of a Dense layer, where the statistics are over
    every other dimension, as flax's ``BatchNorm`` after ``nn.Dense``.

    ``use_running_average = True`` normalises with the running statistics in
    train mode too and updates nothing (flax's ``use_running_average``; see
    ``pipelines/second_train.py::batch_stats_as_parameters``, where the
    running statistics are also parameters).

    ``group`` (a :class:`~lyft3d_tpu_torch.parallel.mesh.DataGroup`, set by
    :func:`~lyft3d_tpu_torch.parallel.mesh.sync_batch_norms`): the train-mode
    statistics span the global batch of a data-parallel run, as flax's do
    under ``jax.jit`` over a sharded batch. Each rank's float32 ``(Σx, Σx²,
    count)`` is summed over the ranks and the same one-pass formula applied;
    the sum's backward sums the ranks' gradients of those statistics. With
    ``group=None`` (the default) the statistics are this process's batch's."""

    def __init__(self, features: int, eps: float = BATCH_NORM_EPS, device=None, dtype=None,
                 channel_dim: int = 1):
        super().__init__(features, eps=eps, momentum=1.0 - BATCH_NORM_MOMENTUM, device=device,
                         dtype=dtype)
        self.channel_dim = channel_dim
        self.running_mean = self.running_mean.float()
        self.running_var = self.running_var.float()
        self.batch_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.use_running_average = False
        self.group = None

    def _apply(self, fn, *args, **kwargs):
        # A cast would round the statistics; keep the float32 values, on the
        # device the cast chose.
        stats = {"running_mean": self.running_mean, "running_var": self.running_var}
        super()._apply(fn, *args, **kwargs)
        for name, old in stats.items():
            new = getattr(self, name)
            if new.dtype != torch.float32:
                kept = old.detach().to(new.device, torch.float32)
                if isinstance(new, nn.Parameter):
                    kept = nn.Parameter(kept, requires_grad=new.requires_grad)
                setattr(self, name, kept)
        return self

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axis = self.channel_dim % xf.dim()
        shape = [1] * xf.dim()
        shape[axis] = xf.shape[axis]
        if self.training and not self.use_running_average:
            dims = tuple(d for d in range(xf.dim()) if d != axis)
            if self.group is None:
                mean = xf.mean(dim=dims)
                var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
            else:
                count = xf.new_full((xf.shape[axis],), xf.numel() // xf.shape[axis])
                total = all_reduce_sum(self.group, torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]))
                mean = total[0] / total[2]
                var = (total[1] / total[2] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = BATCH_NORM_MOMENTUM
                # In the buffers' float32, also for a float64 input: the
                # update rounds once a step, whatever the module's dtype.
                f32 = self.running_mean.dtype
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.to(f32))
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var.to(f32))
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


class ConvNormAct(nn.Module):
    """Conv → norm → ReLU.

    ``norm_type``: "group" (GroupNorm, default), "batch" (BatchNorm with
    running statistics) or "folded" (conv with bias and no norm op: the
    inference structure :func:`lyft3d_tpu_torch.models.fold_bn.fold_batch_norms`
    produces from a "batch" model).
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 3,
        strides: int = 1,
        dilation: int = 1,
        groups: int = 1,
        act: bool = True,
        norm: bool = True,
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"norm_type must be one of {NORM_TYPES}, got {norm_type!r}")
        fk = {"device": device, "dtype": dtype}
        has_norm_op = norm and norm_type != "folded"
        use_bias = (not norm) or norm_type == "folded"
        pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv2d(
            in_features, features, kernel, stride=strides, padding=pad,
            dilation=dilation, groups=groups, bias=use_bias, **fk,
        )
        self.norm: Optional[nn.Module] = None
        if has_norm_op:
            if norm_type == "batch":
                self.norm = BatchNorm(features, **fk)
            else:
                self.norm = GroupNorm(_num_groups(features), features, eps=GROUP_NORM_EPS, **fk)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act:
            x = F.relu(x)
        return x


class SEModule(nn.Module):
    """Squeeze-and-excitation channel gate."""

    def __init__(self, features: int, reduction: int = 16, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        hidden = max(features // reduction, 4)
        self.fc1 = nn.Linear(features, hidden, **fk)
        self.fc2 = nn.Linear(hidden, features, **fk)

    def forward(self, x):
        s = x.mean(dim=(2, 3))
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s[:, :, None, None]


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 + dilated 3x3 branches + a
    global-pool branch → 1x1 projection."""

    def __init__(
        self,
        in_features: int,
        features: int = 256,
        rates: Sequence[int] = (6, 12, 18),
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()

        def cna(cin, **kw):
            return ConvNormAct(cin, features, norm_type=norm_type, device=device, dtype=dtype, **kw)

        self.branches = nn.ModuleList(
            [cna(in_features, kernel=1)]
            + [cna(in_features, kernel=3, dilation=r) for r in rates]
        )
        self.pool = cna(in_features, kernel=1)
        self.project = cna(features * (len(rates) + 2), kernel=1)

    def forward(self, x):
        n, _, h, w = x.shape
        outs = [branch(x) for branch in self.branches]
        pooled = self.pool(x.mean(dim=(2, 3), keepdim=True))
        outs.append(pooled.expand(n, pooled.shape[1], h, w))
        return self.project(torch.cat(outs, dim=1))


class UpBlock(nn.Module):
    """Decoder stage: 2x upsample → concat skip → conv → conv → SE gate."""

    def __init__(
        self,
        in_features: int,
        skip_features: int,
        features: int,
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.conv1 = ConvNormAct(in_features + skip_features, features, **fk)
        self.conv2 = ConvNormAct(features, features, **fk)
        self.se = SEModule(features, device=device, dtype=dtype)

    def forward(self, x, skip=None):
        x = upsample2x(x)
        if skip is not None:
            x = resize_to(x, skip.shape[-2:])
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.se(self.conv2(self.conv1(x)))


@torch.no_grad()
def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fill every parameter and buffer of ``module`` from ``generator``.

    Conv and linear weights are normal with std ``1/sqrt(fan_in)`` (flax's
    lecun-normal scale, untruncated), biases zero, norm scales one, running
    means zero and variances one. Values are drawn in float32 on the CPU and
    copied, so one seed gives the same weights on every device and dtype. A
    module with parameters of its own kind fills them in its
    ``init_own_params(normal)``. Raises on a parameter of a module type it
    does not know.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32) * std)

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal(m.weight, 1.0 / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif hasattr(m, "init_own_params"):
            m.init_own_params(normal)
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"init_params does not know {type(m).__name__}")
    return module


def materialize(module: nn.Module, device, dtype: torch.dtype,
                generator: Optional[torch.Generator], float32_heads: Tuple[nn.Module, ...] = ()):
    """Turn a module built on the ``meta`` device into a real one: allocate on
    ``device``, cast to ``dtype`` (the heads in ``float32_heads`` stay float32,
    as the flax heads do, and so do BatchNorm's running statistics), use
    channels_last, and initialise from ``generator``."""
    module.to_empty(device=torch.device(device) if device is not None else torch.device("cpu"))
    module.to(dtype=dtype)
    for head in float32_heads:
        head.to(dtype=torch.float32)
    module.to(memory_format=torch.channels_last)
    init_params(module, generator)
    return module
