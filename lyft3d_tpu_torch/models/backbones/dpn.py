"""Dual-Path Network encoder, dpn68 and dpn92 (port of
``lyft3d_tpu/models/backbones/dpn.py``).

Each block carries a residual path (summed) and a dense path
(concatenated), through a 1x1 → grouped 3x3 → 1x1 bottleneck. NCHW inside;
returns four stage features (/4, /8, /16, /32), each the residual and dense
paths concatenated. The grouped 3x3 convolutions are
``nn.Conv2d(groups=groups)`` (the JAX package's block-diagonal
``PackedGroupedConv`` computes the same function).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct, max_pool_same

__all__ = ["DualPathBlock", "DPN"]


class DualPathBlock(nn.Module):
    """``(res, dense)`` → ``(res', dense')``: the block's input is ``res`` and
    ``dense`` concatenated; its output splits into ``res_features`` summed
    onto the residual and ``dense_inc`` appended to the dense path. Where the
    residual's width or the stride changes, a strided 1x1 projection of the
    input gives both paths anew. ``conv1..3`` and ``proj`` are flax's
    ``ConvNormAct_0..3``."""

    def __init__(self, res_in: int, dense_in: int, res_features: int, dense_inc: int,
                 groups: int = 32, strides: int = 1, norm_type: str = "group", device=None,
                 dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        cin = res_in + dense_in
        inner = res_features // 2
        self.res_features = res_features
        self.conv1 = ConvNormAct(cin, inner, kernel=1, **fk)
        self.conv2 = ConvNormAct(inner, inner, strides=strides, groups=groups, **fk)
        self.conv3 = ConvNormAct(inner, res_features + dense_inc, kernel=1, act=False, **fk)
        self.proj = None
        if res_in != res_features or strides != 1:
            self.proj = ConvNormAct(cin, res_features + dense_inc, kernel=1, strides=strides,
                                    act=False, **fk)

    def forward(self, res: torch.Tensor, dense: Optional[torch.Tensor]):
        x = res if dense is None else torch.cat([res, dense], dim=1)
        y = self.conv3(self.conv2(self.conv1(x)))
        r = self.res_features
        y_res, y_dense = y[:, :r], y[:, r:]
        if self.proj is not None:
            p = self.proj(x)
            res, dense = p[:, :r], p[:, r:]
        new_dense = y_dense if dense is None else torch.cat([dense, y_dense], dim=1)
        return F.relu(res + y_res), new_dense


class DPN(nn.Module):
    """Stem (3x3 stride 2 to ``10·groups/32 + 54`` channels, flax's ``"SAME"``
    3x3 max-pool of stride 2), then the dual-path stages."""

    def __init__(
        self,
        in_features: int = 6,
        stage_sizes: Sequence[int] = (3, 4, 12, 3),
        res_features: Sequence[int] = (64, 128, 256, 512),
        dense_inc: Sequence[int] = (16, 32, 32, 64),
        groups: int = 32,
        norm_type: str = "group",
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        stem = 10 * groups // 32 + 54
        self.stem = ConvNormAct(in_features, stem, strides=2, **fk)
        stages, widths = [], []
        res_c, dense_c = stem, 0
        for si, n_blocks in enumerate(stage_sizes):
            blocks = []
            for bi in range(n_blocks):
                strides = 2 if (si > 0 and bi == 0) else 1
                block = DualPathBlock(res_c, dense_c, res_features[si], dense_inc[si], groups=groups,
                                      strides=strides, **fk)
                if block.proj is not None:
                    dense_c = dense_inc[si]
                res_c, dense_c = res_features[si], dense_c + dense_inc[si]
                blocks.append(block)
            stages.append(nn.ModuleList(blocks))
            widths.append(res_c + dense_c)
        self.stages = nn.ModuleList(stages)
        self.stage_features = tuple(widths)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        res, dense = max_pool_same(self.stem(x), 3, 2), None
        feats = []
        for stage in self.stages:
            for block in stage:
                res, dense = block(res, dense)
            feats.append(torch.cat([res, dense], dim=1))
        return tuple(feats)


def dpn68(**kw):
    return DPN(**kw)


def dpn92(**kw):
    return DPN(stage_sizes=(3, 4, 20, 3), res_features=(256, 512, 1024, 2048),
               dense_inc=(16, 32, 24, 128), **kw)
