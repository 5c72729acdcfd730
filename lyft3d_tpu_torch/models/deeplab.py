"""DeepLabV3+ and the EfficientNet-UNet, BEV segmentation (port of
``lyft3d_tpu/models/deeplab.py``).

- :class:`DeepLabV3Plus` — a trunk at output stride 8 (dilation instead of
  the last two strides) → ASPP (rates 6/12/18) on the /8 features → upsample
  to the /4 skip, concatenated with its 1x1 reduction → two 3x3 convs → 1x1
  class head at /4 → bilinear upsample to the input.
- :class:`EfficientNetUNet` — SE-gated UpBlocks (256, 128, 64, 32) over an
  EfficientNet's stage features, the last without a skip → 1x1 head →
  upsample.

``forward`` takes ``(N, H, W, C_in)`` and returns ``(logits (N, H, W,
n_classes), aux (N, n_classes))``, float32, like the UNets, so one trainer
and one inference function drive both families. ``dtype``, ``device`` and
``generator`` as in :mod:`lyft3d_tpu_torch.models.unet`; the aux head (a
Linear on the mean of the ASPP output, or of the deepest stage) and the
class head stay float32, as the flax heads do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from lyft3d_tpu_torch.models.backbones import build_backbone
from lyft3d_tpu_torch.models.layers import ASPP, ConvNormAct, UpBlock, materialize, resize_to
from lyft3d_tpu_torch.models.registry import register_model
from lyft3d_tpu_torch.models.unet import _META, _to_nchw

__all__ = ["DeepLabV3Plus", "EfficientNetUNet"]


class DeepLabV3Plus(nn.Module):
    def __init__(
        self,
        backbone: str = "seresnext50",
        n_classes: int = 10,
        aspp_features: int = 256,
        low_features: int = 48,
        output_stride: int = 8,
        norm_type: str = "group",
        in_features: int = 6,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        fk = {"norm_type": norm_type, "device": _META}
        self.backbone = build_backbone(backbone, in_features=in_features,
                                       output_stride=output_stride, **fk)
        stage_ch = self.backbone.stage_features
        self.aspp = ASPP(stage_ch[3], aspp_features, rates=(6, 12, 18), **fk)
        self.aux = nn.Linear(aspp_features, n_classes, device=_META)
        # flax's ConvNormAct_0..2: the /4 skip's 1x1, then the two 3x3.
        self.low = ConvNormAct(stage_ch[0], low_features, kernel=1, **fk)
        self.decode1 = ConvNormAct(aspp_features + low_features, aspp_features, **fk)
        self.decode2 = ConvNormAct(aspp_features, aspp_features, **fk)
        self.head = nn.Conv2d(aspp_features, n_classes, 1, device=_META)
        materialize(self, device, dtype, generator, float32_heads=(self.aux, self.head))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        in_hw = x.shape[1:3]
        feats = self.backbone(_to_nchw(x, self.dtype))
        low = feats[0]  # /4
        a = self.aspp(feats[3])  # /8
        aux = self.aux(a.mean(dim=(2, 3)).float())
        d = torch.cat([resize_to(a, low.shape[-2:]), self.low(low)], dim=1)
        d = self.decode2(self.decode1(d))
        # The 1x1 head at /4, then the class logits upsampled (the two commute).
        logits = resize_to(self.head(d.float()), in_hw)
        return logits.permute(0, 2, 3, 1), aux


class EfficientNetUNet(nn.Module):
    """``norm_type`` is "group" only: the flax model has no norm choice (its
    trunk and decoder use GroupNorm)."""

    def __init__(
        self,
        backbone: str = "efficientnet_b3",
        n_classes: int = 10,
        decoder_features: Sequence[int] = (256, 128, 64, 32),
        norm_type: str = "group",
        in_features: int = 6,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if norm_type != "group":
            raise ValueError(f"EfficientNetUNet has GroupNorm only (as the flax model), "
                             f"got norm_type={norm_type!r}")
        self.dtype = dtype
        self.backbone = build_backbone(backbone, in_features=in_features, device=_META)
        stage_ch = self.backbone.stage_features
        self.aux = nn.Linear(stage_ch[3], n_classes, device=_META)
        ups, cin = [], stage_ch[3]
        for f, skip in zip(decoder_features, (stage_ch[2], stage_ch[1], stage_ch[0], 0)):
            ups.append(UpBlock(cin, skip, f, device=_META))
            cin = f
        self.decoder = nn.ModuleList(ups)
        self.head = nn.Conv2d(cin, n_classes, 1, device=_META)
        materialize(self, device, dtype, generator, float32_heads=(self.aux, self.head))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        in_hw = x.shape[1:3]
        feats = self.backbone(_to_nchw(x, self.dtype))
        aux = self.aux(feats[3].mean(dim=(2, 3)).float())
        d = feats[3]
        for up, skip in zip(self.decoder, (feats[2], feats[1], feats[0], None)):
            d = up(d, skip)
        logits = resize_to(self.head(d.float()), in_hw)
        return logits.permute(0, 2, 3, 1), aux


def _deeplab(backbone):
    def ctor(n_classes: int = 10, **kw):
        return DeepLabV3Plus(backbone=backbone, n_classes=n_classes, **kw)

    return ctor


def _efficientnet_unet(backbone):
    def ctor(n_classes: int = 10, **kw):
        return EfficientNetUNet(backbone=backbone, n_classes=n_classes, **kw)

    return ctor


for _b in ("seresnext50", "seresnext101", "wide_resnet38", "resnet50"):
    register_model(f"deeplab_{_b}")(_deeplab(_b))
for _b in ("efficientnet_b3", "efficientnet_b5"):
    register_model(f"{_b}_unet")(_efficientnet_unet(_b))
