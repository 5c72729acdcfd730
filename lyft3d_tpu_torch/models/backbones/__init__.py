"""Encoder backbones returning 4 feature stages (/4, /8, /16, /32).

Every family of the JAX package is ported: ResNet, SE-ResNeXt,
EfficientNet b0-b5, DPN, WideResNet-38, Xception and the two Inception
trunks. Each takes ``in_features`` (the input channels), ``norm_type``,
``device`` and ``dtype`` and exposes the four stages' widths as
``stage_features``; ResNet, SE-ResNeXt and WideResNet-38 also take
``output_stride`` (8 or 16: dilation instead of the last strides).
"""

from functools import partial

from lyft3d_tpu_torch.models.backbones.dpn import DPN, dpn68, dpn92
from lyft3d_tpu_torch.models.backbones.efficientnet import VARIANTS, EfficientNet
from lyft3d_tpu_torch.models.backbones.resnet import ResNet, resnet18, resnet34, resnet50
from lyft3d_tpu_torch.models.backbones.seresnext import (
    SEResNeXt,
    seresnext26,
    seresnext50,
    seresnext101,
)
from lyft3d_tpu_torch.models.backbones.wide_resnet import WideResNet38, wide_resnet38
from lyft3d_tpu_torch.models.backbones.xception import (
    InceptionResNetV2,
    InceptionV4,
    Xception,
    inception_v4,
    inceptionresnetv2,
    xception,
)

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "seresnext26": seresnext26,
    "seresnext50": seresnext50,
    "seresnext101": seresnext101,
    **{f"efficientnet_{v}": partial(EfficientNet, variant=v) for v in VARIANTS},
    "dpn68": dpn68,
    "dpn92": dpn92,
    "wide_resnet38": wide_resnet38,
    "xception": xception,
    "inception_v4": inception_v4,
    "inceptionresnetv2": inceptionresnetv2,
}


def register_backbone(name: str, fn) -> None:
    """Make ``fn(**kwargs)`` the backbone ``name`` (a new family, or another
    constructor for a name that exists)."""
    BACKBONES[name] = fn


def build_backbone(name: str, **kwargs):
    if name not in BACKBONES:
        raise KeyError(
            f"backbone {name!r} is unknown or not yet ported to lyft3d_tpu_torch; "
            f"ported: {sorted(BACKBONES)}"
        )
    return BACKBONES[name](**kwargs)
