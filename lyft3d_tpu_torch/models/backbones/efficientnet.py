"""EfficientNet encoder, b0-b5 (port of
``lyft3d_tpu/models/backbones/efficientnet.py``).

MBConv inverted bottlenecks (1x1 expand, depthwise kxk, squeeze-and-excite,
1x1 project) with SiLU and compound width/depth scaling. NCHW inside;
returns four feature stages (/4, /8, /16, /32): the activations just before
each stride-2 block past the stem, and the last block's output. The
depthwise convolutions are ``nn.Conv2d(groups=channels)``, cuDNN's depthwise
kernels (the JAX package keeps them grouped too: ``pack_groups="never"``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct

__all__ = ["MBConv", "EfficientNet", "VARIANTS"]

# (width_mult, depth_mult) per variant.
_SCALING = {
    "b0": (1.0, 1.0),
    "b1": (1.0, 1.1),
    "b2": (1.1, 1.2),
    "b3": (1.2, 1.4),
    "b4": (1.4, 1.8),
    "b5": (1.6, 2.2),
}

# (expand_ratio, channels, repeats, stride, kernel) of the b0 blocks.
_BASE_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _round_filters(f: float, width_mult: float, divisor: int = 8) -> int:
    f *= width_mult
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


class MBConv(nn.Module):
    """[1x1 expand → SiLU] → depthwise kxk (carries the stride) → SiLU → SE
    gate (a Linear to ``in_features // 4``, SiLU, a Linear back, sigmoid) →
    1x1 project, no activation, plus the input where the shape allows.
    Submodules in flax's creation order: ``expand`` (when ``expand != 1``),
    ``depthwise``, ``se1`` / ``se2`` (``Dense_0`` / ``Dense_1``), ``project``."""

    def __init__(self, in_features: int, features: int, expand: int, kernel: int, strides: int,
                 norm_type: str = "group", device=None, dtype=None):
        super().__init__()
        fk = {"act": False, "norm_type": norm_type, "device": device, "dtype": dtype}
        mid = in_features * expand
        self.expand = ConvNormAct(in_features, mid, kernel=1, **fk) if expand != 1 else None
        self.depthwise = ConvNormAct(mid, mid, kernel=kernel, strides=strides, groups=mid, **fk)
        se_dim = max(1, in_features // 4)
        self.se1 = nn.Linear(mid, se_dim, device=device, dtype=dtype)
        self.se2 = nn.Linear(se_dim, mid, device=device, dtype=dtype)
        self.project = ConvNormAct(mid, features, kernel=1, **fk)
        self.residual = strides == 1 and in_features == features

    def forward(self, x):
        h = x if self.expand is None else F.silu(self.expand(x))
        h = F.silu(self.depthwise(h))
        s = torch.sigmoid(self.se2(F.silu(self.se1(h.mean(dim=(2, 3))))))
        h = self.project(h * s[:, :, None, None])
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """Stem (3x3 stride 2, SiLU), then the scaled MBConv blocks; returns the
    four stage features."""

    def __init__(self, in_features: int = 6, variant: str = "b0", norm_type: str = "group",
                 device=None, dtype=None):
        super().__init__()
        wm, dm = _SCALING[variant]
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        stem = _round_filters(32, wm)
        self.stem = ConvNormAct(in_features, stem, strides=2, act=False, **fk)
        blocks, taps, cin = [], [], stem
        for expand, ch, reps, stride, k in _BASE_BLOCKS:
            f = _round_filters(ch, wm)
            for i in range(_round_repeats(reps, dm)):
                s = stride if i == 0 else 1
                if s == 2:
                    taps.append(len(blocks))  # the input of this block
                blocks.append(MBConv(cin, f, expand, k, s, **fk))
                cin = f
        self.blocks = nn.ModuleList(blocks)
        # The tap before the first stride-2 block (/2) is dropped.
        self.taps = tuple(taps[1:])
        self.stage_features = (*[blocks[i - 1].project.conv.out_channels for i in self.taps], cin)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = F.silu(self.stem(x))
        feats = []
        for i, block in enumerate(self.blocks):
            if i in self.taps:
                feats.append(x)
            x = block(x)
        feats.append(x)
        return tuple(feats)


VARIANTS = tuple(_SCALING)
