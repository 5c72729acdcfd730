"""Region proposal network over the dense BEV map (port of
``lyft3d_tpu/models/second/rpn.py``).

Blocks of ``ConvNormAct`` (a strided first conv, then ``layer_nums[i]``
more), each followed by a 1x1 ``ConvNormAct`` branch resized to block 0's
output scaled by ``upsample_strides[0]`` and concatenated; then three 1x1
float32 heads with bias: box (A·code), cls (A·classes), dir (A·2).

Runs NCHW (``channels_last`` in memory); ``forward`` takes the NCHW BEV
map and returns the heads in the JAX package's NHWC layout
``(B, H, W, A·code)``, whose flattening is position-major
``(y, x, anchor)`` like the anchors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct, resize_to

__all__ = ["RPN"]


class RPN(nn.Module):
    def __init__(
        self,
        in_features: int,
        layer_nums: Sequence[int] = (3, 5, 5),
        layer_strides: Sequence[int] = (2, 2, 2),
        num_filters: Sequence[int] = (64, 128, 256),
        upsample_strides: Sequence[float] = (1, 2, 4),
        num_upsample_filters: Sequence[int] = (128, 128, 128),
        num_anchors_per_loc: int = 2,
        num_classes: int = 1,
        box_code_size: int = 7,
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.up_stride0 = upsample_strides[0]
        blocks, ups, cin = [], [], in_features
        for n_layers, stride, filters, up_f in zip(
            layer_nums, layer_strides, num_filters, num_upsample_filters
        ):
            layers = [ConvNormAct(cin, filters, strides=stride, **fk)]
            layers += [ConvNormAct(filters, filters, **fk) for _ in range(n_layers)]
            blocks.append(nn.Sequential(*layers))
            ups.append(ConvNormAct(filters, up_f, kernel=1, **fk))
            cin = filters
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        cat = sum(num_upsample_filters)
        a = num_anchors_per_loc
        self.box = nn.Conv2d(cat, a * box_code_size, 1, **fk)
        self.cls = nn.Conv2d(cat, a * num_classes, 1, **fk)
        self.dir = nn.Conv2d(cat, a * 2, 1, **fk)

    def heads(self):
        return (self.box, self.cls, self.dir)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = x.to(self.blocks[0][0].conv.weight.dtype)
        outs, out_hw = [], None
        for block, up in zip(self.blocks, self.ups):
            x = block(x)
            if out_hw is None:
                h, w = x.shape[-2:]
                out_hw = (int(h * self.up_stride0), int(w * self.up_stride0))
            outs.append(resize_to(up(x), out_hw))
        x = torch.cat(outs, dim=1).float()
        return {name: head(x).permute(0, 2, 3, 1)
                for name, head in zip(("box", "cls", "dir"), self.heads())}
