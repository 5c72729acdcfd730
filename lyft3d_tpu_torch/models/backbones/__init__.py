"""Encoder backbones returning 4 feature stages (/4, /8, /16, /32).

The ResNet and SE-ResNeXt families are ported; the JAX package's other
families (efficientnet, dpn, wide_resnet, xception, inception) raise
``KeyError`` here until their port lands.
"""

from lyft3d_tpu_torch.models.backbones.resnet import ResNet, resnet18, resnet34, resnet50
from lyft3d_tpu_torch.models.backbones.seresnext import (
    SEResNeXt,
    seresnext26,
    seresnext50,
    seresnext101,
)

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "seresnext26": seresnext26,
    "seresnext50": seresnext50,
    "seresnext101": seresnext101,
}


def build_backbone(name: str, **kwargs):
    if name not in BACKBONES:
        raise KeyError(
            f"backbone {name!r} is not yet ported to lyft3d_tpu_torch; "
            f"ported: {sorted(BACKBONES)}"
        )
    return BACKBONES[name](**kwargs)
