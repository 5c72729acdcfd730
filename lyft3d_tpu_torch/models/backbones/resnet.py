"""ResNet encoder (port of ``lyft3d_tpu/models/backbones/resnet.py``).

NCHW inside; returns the four stage features (/4, /8, /16, /32).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet34", "resnet50"]


class BasicBlock(nn.Module):
    def __init__(self, in_features, features, strides=1, dilation=1, norm_type="group",
                 device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.conv1 = ConvNormAct(in_features, features, strides=strides, dilation=dilation, **fk)
        self.conv2 = ConvNormAct(features, features, dilation=dilation, act=False, **fk)
        self.downsample = None
        if in_features != features or strides != 1:
            self.downsample = ConvNormAct(in_features, features, kernel=1, strides=strides,
                                          act=False, **fk)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (carries the stride and dilation) → 1x1; ``features`` is the
    output width, four times the inner width."""

    def __init__(self, in_features, features, strides=1, dilation=1, norm_type="group",
                 device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        inner = features // 4
        self.conv1 = ConvNormAct(in_features, inner, kernel=1, **fk)
        self.conv2 = ConvNormAct(inner, inner, strides=strides, dilation=dilation, **fk)
        self.conv3 = ConvNormAct(inner, features, kernel=1, act=False, **fk)
        self.downsample = None
        if in_features != features or strides != 1:
            self.downsample = ConvNormAct(in_features, features, kernel=1, strides=strides,
                                          act=False, **fk)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


# Stride-8/16 surgery: the last stages keep stride 1 and dilate instead.
_DILATIONS = {32: (1, 1, 1, 1), 16: (1, 1, 1, 2), 8: (1, 1, 2, 4)}


class ResNet(nn.Module):
    """Returns the four stage features (/4, /8, /16, /32)."""

    def __init__(
        self,
        in_features: int = 6,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        stage_features: Sequence[int] = (64, 128, 256, 512),
        bottleneck: bool = False,
        output_stride: int = 32,
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.stage_features = tuple(stage_features)
        self.stem = ConvNormAct(in_features, 64, kernel=7, strides=2, **fk)
        block = Bottleneck if bottleneck else BasicBlock
        dilations = _DILATIONS[output_stride]
        stages = []
        cin = 64
        for si, (n_blocks, f) in enumerate(zip(stage_sizes, stage_features)):
            dil = dilations[si]
            blocks = []
            for bi in range(n_blocks):
                strides = 2 if (si > 0 and bi == 0 and dil == 1) else 1
                blocks.append(block(cin, f, strides=strides, dilation=dil, **fk))
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


def resnet18(**kw):
    return ResNet(stage_sizes=(2, 2, 2, 2), **kw)


def resnet34(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet50(**kw):
    return ResNet(
        stage_sizes=(3, 4, 6, 3),
        stage_features=(256, 512, 1024, 2048),
        bottleneck=True,
        **kw,
    )
