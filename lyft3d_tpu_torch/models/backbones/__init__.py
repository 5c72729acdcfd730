"""Encoder backbones returning 4 feature stages (/4, /8, /16, /32).

Only the ResNet family is ported so far; the JAX package's other families
(seresnext, efficientnet, dpn, wide_resnet, xception, inception) raise
``KeyError`` here until their port lands.
"""

from lyft3d_tpu_torch.models.backbones.resnet import ResNet, resnet18, resnet34, resnet50

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
}


def build_backbone(name: str, **kwargs):
    if name not in BACKBONES:
        raise KeyError(
            f"backbone {name!r} is not yet ported to lyft3d_tpu_torch; "
            f"ported: {sorted(BACKBONES)}"
        )
    return BACKBONES[name](**kwargs)
