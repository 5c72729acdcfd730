"""Xception and Inception-style encoders (port of
``lyft3d_tpu/models/backbones/xception.py``).

Depthwise-separable Xception blocks and multi-branch Inception mixes, each
exposed as a four-stage encoder (/4, /8, /16, /32), NCHW inside. The trunks
are the JAX package's compacted ones (``docs/PARITY.md``: 4 middle-flow
repeats instead of 8, generic Inception mixes, 1/2/4/2 scaled-residual
blocks), ported as they are.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct, SameConv2d, avg_pool_same

__all__ = ["SeparableConv", "XceptionBlock", "Xception", "InceptionMix", "InceptionV4",
           "InceptionResBlock", "InceptionResNetV2"]


class SeparableConv(nn.Module):
    """A bare depthwise 3x3 conv (no bias, no norm; flax's ``"SAME"`` padding,
    ``Conv_0``), then a 1x1 conv + norm without activation
    (``ConvNormAct_0``)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 norm_type: str = "group", device=None, dtype=None):
        super().__init__()
        self.depthwise = SameConv2d(in_features, in_features, 3, stride=strides,
                                    groups=in_features, bias=False, device=device, dtype=dtype)
        self.pointwise = ConvNormAct(in_features, features, kernel=1, act=False,
                                     norm_type=norm_type, device=device, dtype=dtype)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class XceptionBlock(nn.Module):
    """``reps`` × (ReLU → :class:`SeparableConv`), the last carrying the
    stride, plus the input (a strided 1x1 projection where the shape
    changes)."""

    def __init__(self, in_features: int, features: int, strides: int = 1, reps: int = 2,
                 norm_type: str = "group", device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.seps = nn.ModuleList(
            SeparableConv(in_features if i == 0 else features, features,
                          strides=strides if i == reps - 1 else 1, **fk)
            for i in range(reps)
        )
        self.skip = None
        if in_features != features or strides != 1:
            self.skip = ConvNormAct(in_features, features, kernel=1, strides=strides, act=False,
                                    **fk)

    def forward(self, x):
        y = x
        for sep in self.seps:
            y = sep(F.relu(y))
        return y + (x if self.skip is None else self.skip(x))


class Xception(nn.Module):
    def __init__(self, in_features: int = 6, stage_features: Sequence[int] = (128, 256, 728, 1024),
                 middle_reps: int = 4, norm_type: str = "group", device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        f1, f2, f3, f4 = stage_features
        self.stem1 = ConvNormAct(in_features, 32, strides=2, **fk)
        self.stem2 = ConvNormAct(32, 64, **fk)
        self.entry = nn.ModuleList([XceptionBlock(64, f1, strides=2, **fk),
                                    XceptionBlock(f1, f2, strides=2, **fk),
                                    XceptionBlock(f2, f3, strides=2, **fk)])
        self.middle = nn.ModuleList(XceptionBlock(f3, f3, reps=3, **fk) for _ in range(middle_reps))
        self.exit = XceptionBlock(f3, f4, strides=2, **fk)
        self.exit_sep = SeparableConv(f4, f4 * 2, **fk)
        self.stage_features = (f1, f2, f3, f4 * 2)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stem2(self.stem1(x))
        feats = []
        x = self.entry[0](x)
        feats.append(x)  # /4
        x = self.entry[1](x)
        feats.append(x)  # /8
        x = self.entry[2](x)
        for block in self.middle:
            x = block(x)
        feats.append(x)  # /16
        feats.append(F.relu(self.exit_sep(self.exit(x))))  # /32
        return tuple(feats)


class InceptionMix(nn.Module):
    """Four branches of ``features // 4``: 1x1 | 1x1 → 3x3 | 1x1 → 3x3 → 3x3 |
    3x3 average pool (flax's ``"SAME"``, the pad counted) → 1x1; concatenated.
    ``convs`` are flax's ``ConvNormAct_0..6`` in that order."""

    def __init__(self, in_features: int, features: int, norm_type: str = "group", device=None,
                 dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        f = features // 4
        self.convs = nn.ModuleList([
            ConvNormAct(in_features, f, kernel=1, **fk),
            ConvNormAct(in_features, f, kernel=1, **fk), ConvNormAct(f, f, **fk),
            ConvNormAct(in_features, f, kernel=1, **fk), ConvNormAct(f, f, **fk),
            ConvNormAct(f, f, **fk),
            ConvNormAct(in_features, f, kernel=1, **fk),
        ])

    def forward(self, x):
        c = self.convs
        b1 = c[0](x)
        b2 = c[2](c[1](x))
        b3 = c[5](c[4](c[3](x)))
        b4 = c[6](avg_pool_same(x, 3, 1))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionV4(nn.Module):
    def __init__(self, in_features: int = 6, stage_features: Sequence[int] = (96, 192, 384, 1024),
                 blocks_per_stage: Sequence[int] = (1, 2, 3, 2), norm_type: str = "group",
                 device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.stem = nn.Sequential(ConvNormAct(in_features, 32, strides=2, **fk),
                                  ConvNormAct(32, 64, **fk))
        reductions, stages, widths, cin = [], [], [], 64
        for f, n in zip(stage_features, blocks_per_stage):
            reductions.append(ConvNormAct(cin, f, strides=2, **fk))
            mixes, cin = [], f
            for _ in range(n):
                mixes.append(InceptionMix(cin, f, **fk))
                cin = f // 4 * 4
            stages.append(nn.Sequential(*mixes))
            widths.append(cin)
        self.reductions = nn.ModuleList(reductions)
        self.stages = nn.ModuleList(stages)
        self.stage_features = tuple(widths)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        feats = []
        for reduce, stage in zip(self.reductions, self.stages):
            x = stage(reduce(x))
            feats.append(x)
        return tuple(feats)


class InceptionResBlock(nn.Module):
    """Scaled residual: 1x1 | 1x1 → 3x3 | 1x1 → 3x3 (×3/2) → 3x3 (×2)
    branches of ``max(features // 8, 16)``, concatenated, a linear 1x1 back
    to ``features``, then ``ReLU(x + scale · branch)`` with ``scale`` cast to
    the compute dtype (0.17 rounds in bfloat16, as in flax). ``convs`` are
    flax's ``ConvNormAct_0..6``."""

    def __init__(self, features: int, scale: float = 0.17, norm_type: str = "group", device=None,
                 dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        f = max(features // 8, 16)
        self.scale = scale
        self.convs = nn.ModuleList([
            ConvNormAct(features, f, kernel=1, **fk),
            ConvNormAct(features, f, kernel=1, **fk), ConvNormAct(f, f, **fk),
            ConvNormAct(features, f, kernel=1, **fk), ConvNormAct(f, f * 3 // 2, **fk),
            ConvNormAct(f * 3 // 2, f * 2, **fk),
            ConvNormAct(f + f + f * 2, features, kernel=1, act=False, **fk),
        ])

    def forward(self, x):
        c = self.convs
        mixed = torch.cat([c[0](x), c[2](c[1](x)), c[5](c[4](c[3](x)))], dim=1)
        up = c[6](mixed)
        scale = torch.tensor(self.scale, dtype=up.dtype, device=up.device)
        return F.relu(x + scale * up)


class InceptionResNetV2(nn.Module):
    def __init__(self, in_features: int = 6,
                 stage_features: Sequence[int] = (128, 320, 1088, 2080),
                 blocks_per_stage: Sequence[int] = (1, 2, 4, 2),
                 block_scales: Sequence[float] = (0.17, 0.17, 0.10, 0.20),
                 norm_type: str = "group", device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.stem = nn.Sequential(ConvNormAct(in_features, 32, strides=2, **fk),
                                  ConvNormAct(32, 32, **fk), ConvNormAct(32, 64, **fk))
        reductions, stages, cin = [], [], 64
        for f, n, s in zip(stage_features, blocks_per_stage, block_scales):
            reductions.append(ConvNormAct(cin, f, strides=2, **fk))
            stages.append(nn.Sequential(*[InceptionResBlock(f, scale=s, **fk) for _ in range(n)]))
            cin = f
        self.reductions = nn.ModuleList(reductions)
        self.stages = nn.ModuleList(stages)
        self.stage_features = tuple(stage_features)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        feats = []
        for reduce, stage in zip(self.reductions, self.stages):
            x = stage(reduce(x))
            feats.append(x)
        return tuple(feats)


def xception(**kw):
    return Xception(**kw)


def inception_v4(**kw):
    return InceptionV4(**kw)


def inceptionresnetv2(**kw):
    return InceptionResNetV2(**kw)
