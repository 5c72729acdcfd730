"""WideResNet-38 encoder (port of ``lyft3d_tpu/models/backbones/wide_resnet.py``).

Wide 3-conv identity blocks, stages (3, 3, 6, 3) with doubling widths, the
trunk of ``deeplab_wide_resnet38``. NCHW inside; returns the four stage
features (/4, /8, /16, /32), or with ``output_stride`` 8 or 16 the last
stages at stride 1 and dilated instead (a stage is strided only where it is
not dilated).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.backbones.resnet import _DILATIONS
from lyft3d_tpu_torch.models.layers import ConvNormAct, max_pool_same

__all__ = ["WideBlock", "WideResNet38", "wide_resnet38"]


class WideBlock(nn.Module):
    """3x3 (carries the stride and dilation) → 3x3 → 1x1 to ``out``, plus the
    residual (a strided 1x1 projection where the shape changes); flax's
    ``ConvNormAct_0..3`` are ``conv1..3`` and ``downsample``."""

    def __init__(self, in_features: int, features: Tuple[int, int], strides: int = 1,
                 dilation: int = 1, norm_type: str = "group", device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        inner, out = features
        self.conv1 = ConvNormAct(in_features, inner, strides=strides, dilation=dilation, **fk)
        self.conv2 = ConvNormAct(inner, inner, dilation=dilation, **fk)
        self.conv3 = ConvNormAct(inner, out, kernel=1, act=False, **fk)
        self.downsample = None
        if in_features != out or strides != 1:
            self.downsample = ConvNormAct(in_features, out, kernel=1, strides=strides, act=False, **fk)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class WideResNet38(nn.Module):
    """``stage_features`` are the (inner, out) widths of each stage's blocks,
    as in flax; the attribute ``stage_features`` holds the four output
    widths, as on :class:`~lyft3d_tpu_torch.models.backbones.resnet.ResNet`.
    The stem: two 3x3 convs (the first of stride 2), then flax's ``"SAME"``
    3x3 max-pool of stride 2."""

    def __init__(
        self,
        in_features: int = 6,
        stage_sizes: Sequence[int] = (3, 3, 6, 3),
        stage_features: Sequence[Tuple[int, int]] = ((128, 256), (256, 512), (512, 1024),
                                                     (1024, 2048)),
        output_stride: int = 32,
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.stage_features = tuple(out for _, out in stage_features)
        self.stem1 = ConvNormAct(in_features, 64, strides=2, **fk)
        self.stem2 = ConvNormAct(64, 64, **fk)
        dilations = _DILATIONS[output_stride]
        stages, cin = [], 64
        for si, (n_blocks, f) in enumerate(zip(stage_sizes, stage_features)):
            dil = dilations[si]
            blocks = []
            for bi in range(n_blocks):
                strides = 2 if (si > 0 and bi == 0 and dil == 1) else 1
                blocks.append(WideBlock(cin, tuple(f), strides=strides, dilation=dil, **fk))
                cin = f[1]
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = max_pool_same(self.stem2(self.stem1(x)), 3, 2)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return tuple(feats)


def wide_resnet38(**kw):
    return WideResNet38(**kw)
