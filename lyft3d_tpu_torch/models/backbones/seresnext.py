"""SE-ResNeXt encoder (port of ``lyft3d_tpu/models/backbones/seresnext.py``).

ResNeXt bottlenecks of cardinality 32 with squeeze-and-excitation gates. NCHW
inside; returns the four stage features (/4, /8, /16, /32). The grouped 3x3
convolutions are ``nn.Conv2d(groups=cardinality)`` (cuDNN runs them natively;
the JAX package's block-diagonal ``PackedGroupedConv`` is a TPU lane-packing
workaround and computes the same function).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.backbones.resnet import _DILATIONS
from lyft3d_tpu_torch.models.layers import ConvNormAct, SEModule

__all__ = ["SEResNeXtBlock", "SEResNeXt", "seresnext26", "seresnext50", "seresnext101"]


class SEResNeXtBlock(nn.Module):
    """1x1 → grouped 3x3 (carries the stride and dilation) → 1x1 → SE gate,
    plus the residual; ``features`` is the output width, twice the inner
    width. Submodules in flax's creation order: ``conv1..3`` are
    ``ConvNormAct_0..2``, ``se`` is ``SEModule_0`` and ``downsample`` is
    ``ConvNormAct_3``."""

    def __init__(self, in_features, features, strides=1, dilation=1, cardinality=32,
                 norm_type="group", device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        inner = features // 2
        self.conv1 = ConvNormAct(in_features, inner, kernel=1, **fk)
        self.conv2 = ConvNormAct(inner, inner, strides=strides, dilation=dilation,
                                 groups=cardinality, **fk)
        self.conv3 = ConvNormAct(inner, features, kernel=1, act=False, **fk)
        self.se = SEModule(features, device=device, dtype=dtype)
        self.downsample = None
        if in_features != features or strides != 1:
            self.downsample = ConvNormAct(in_features, features, kernel=1, strides=strides,
                                          act=False, **fk)

    def forward(self, x):
        y = self.se(self.conv3(self.conv2(self.conv1(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class SEResNeXt(nn.Module):
    """Returns the four stage features (/4, /8, /16, /32); ``output_stride``
    8 or 16 keeps the last stages at stride 1 and dilates them instead."""

    def __init__(
        self,
        in_features: int = 6,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        stage_features: Sequence[int] = (256, 512, 1024, 2048),
        cardinality: int = 32,
        output_stride: int = 32,
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.stage_features = tuple(stage_features)
        self.stem = ConvNormAct(in_features, 64, kernel=7, strides=2, **fk)
        dilations = _DILATIONS[output_stride]
        stages = []
        cin = 64
        for si, (n_blocks, f) in enumerate(zip(stage_sizes, stage_features)):
            dil = dilations[si]
            blocks = []
            for bi in range(n_blocks):
                strides = 2 if (si > 0 and bi == 0 and dil == 1) else 1
                blocks.append(SEResNeXtBlock(cin, f, strides=strides, dilation=dil,
                                             cardinality=cardinality, **fk))
                cin = f
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        # torch-style symmetric pad with -inf, as the flax stem max-pool
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return tuple(feats)


def seresnext26(**kw):
    return SEResNeXt(stage_sizes=(2, 2, 2, 2), **kw)


def seresnext50(**kw):
    return SEResNeXt(stage_sizes=(3, 4, 6, 3), **kw)


def seresnext101(**kw):
    return SEResNeXt(stage_sizes=(3, 4, 23, 3), **kw)
