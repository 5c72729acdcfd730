"""BEV segmentation UNets (port of ``lyft3d_tpu/models/unet.py``).

- :class:`ReferenceUNet` — the plain Ronneberger encoder-decoder.
- :class:`LyftUNet` — backbone encoder → 1x1 skip reductions → ASPP centre →
  SE-gated UpBlock decoder → hypercolumn → full-resolution class head, plus
  the auxiliary image-level class head.

``forward`` takes ``(N, H, W, C_in)`` (the JAX layout) and returns
``(logits (N, H, W, n_classes), aux (N, n_classes))``, both float32.

``dtype`` is the compute and storage type of the trunk (float32 by default;
bfloat16 is the speed choice on the card); the class heads stay float32, as
the flax heads do. Modules are built on the ``meta`` device and then
allocated on ``device`` and initialised from ``generator``
(:func:`~lyft3d_tpu_torch.models.layers.init_params`), so no global random
state is used. Use :func:`lyft3d_tpu_torch.utils.flax_params.load_flax_params`
to load the JAX package's weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lyft3d_tpu_torch.models.backbones import build_backbone
from lyft3d_tpu_torch.models.layers import ASPP, ConvNormAct, UpBlock, materialize, resize_to, upsample2x
from lyft3d_tpu_torch.models.registry import register_model

__all__ = ["ReferenceUNet", "LyftUNet"]

_META = torch.device("meta")


def _to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # An NHWC-contiguous tensor permuted to NCHW is channels_last already.
    return x.permute(0, 3, 1, 2).to(dtype)


class ReferenceUNet(nn.Module):
    def __init__(
        self,
        n_classes: int = 10,
        wf: int = 5,  # first stage has 2**wf features
        depth: int = 4,
        norm_type: str = "group",
        in_features: int = 6,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype

        def pair(cin, f):
            return nn.Sequential(
                ConvNormAct(cin, f, norm_type=norm_type, device=_META),
                ConvNormAct(f, f, norm_type=norm_type, device=_META),
            )

        down, cin = [], in_features
        for d in range(depth):
            down.append(pair(cin, 2 ** (wf + d)))
            cin = 2 ** (wf + d)
        self.down = nn.ModuleList(down)
        self.bottom = pair(cin, 2 ** (wf + depth))
        self.up = nn.ModuleList(
            pair(2 ** (wf + d + 1) + 2 ** (wf + d), 2 ** (wf + d)) for d in reversed(range(depth))
        )
        self.head = nn.Conv2d(2 ** wf, n_classes, 1, device=_META)
        materialize(self, device, dtype, generator, float32_heads=(self.head,))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _to_nchw(x, self.dtype)
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, stride=2)
        x = self.bottom(x)
        for block, skip in zip(self.up, reversed(skips)):
            x = resize_to(upsample2x(x), skip.shape[-2:])
            x = block(torch.cat([x, skip], dim=1))
        logits = self.head(x.float()).permute(0, 2, 3, 1)
        return logits, logits.mean(dim=(1, 2))


class LyftUNet(nn.Module):
    def __init__(
        self,
        backbone: str = "resnet50",
        n_classes: int = 10,
        decoder_features: int = 64,
        aspp_features: int = 256,
        # 1x1 skip width = stage_channels // skip_reduction; 0 = fixed
        # ``decoder_features`` width.
        skip_reduction: int = 4,
        norm_type: str = "group",
        in_features: int = 6,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        fk = {"norm_type": norm_type, "device": _META}
        self.backbone = build_backbone(backbone, in_features=in_features, **fk)
        stage_ch = self.backbone.stage_features

        def skip_width(c):
            if skip_reduction <= 0:
                return decoder_features
            return max(c // skip_reduction, decoder_features)

        skip_w = [skip_width(c) for c in stage_ch[:3]]
        self.skips = nn.ModuleList(
            ConvNormAct(c, sw, kernel=1, **fk) for c, sw in zip(stage_ch[:3], skip_w)
        )
        self.aspp = ASPP(stage_ch[3], aspp_features, **fk)
        self.aux = nn.Linear(aspp_features, n_classes, device=_META)
        # /32→/16→/8→/4 with skips, then /2 without.
        ups, cin = [], aspp_features
        for sw in [*reversed(skip_w), 0]:
            ups.append(UpBlock(cin, sw, decoder_features, **fk))
            cin = decoder_features
        self.decoder = nn.ModuleList(ups)
        self.hyper = ConvNormAct(decoder_features * len(ups), decoder_features, **fk)
        self.head = nn.Conv2d(decoder_features, n_classes, 1, device=_META)
        materialize(self, device, dtype, generator, float32_heads=(self.aux, self.head))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        in_hw = x.shape[1:3]
        feats = self.backbone(_to_nchw(x, self.dtype))
        skips = [conv(f) for conv, f in zip(self.skips, feats[:3])]
        center = self.aspp(feats[3])
        aux = self.aux(center.mean(dim=(2, 3)).float())

        d = center
        decoder_outs = []
        for up, skip in zip(self.decoder, [*reversed(skips), None]):
            d = up(d, skip)
            decoder_outs.append(d)
        # Hypercolumn: every decoder stage resized to /2 and concatenated.
        hyper = torch.cat([resize_to(o, d.shape[-2:]) for o in decoder_outs], dim=1)
        h = self.hyper(hyper)
        # 1x1 head at /2, then upsample the class logits (the two commute).
        logits = resize_to(self.head(h.float()), in_hw)
        return logits.permute(0, 2, 3, 1), aux


@register_model("unet_reference")
def _unet_reference(n_classes: int = 10, **kw):
    return ReferenceUNet(n_classes=n_classes, **kw)


def _make_backbone_unet(backbone):
    def ctor(n_classes: int = 10, **kw):
        return LyftUNet(backbone=backbone, n_classes=n_classes, **kw)

    return ctor


for _b in ("resnet18", "resnet34", "resnet50", "seresnext26", "seresnext50", "seresnext101",
           "efficientnet_b1", "efficientnet_b2", "efficientnet_b3", "efficientnet_b5", "dpn68",
           "xception", "inception_v4", "inceptionresnetv2"):
    register_model(f"unet_{_b}")(_make_backbone_unet(_b))
