"""Torch-checkpoint importer for the port's backbone zoo (port of
``lyft3d_tpu/utils/torch_import.py``).

Restores the reference's transfer-learning capability (the reference pulls
ImageNet weights from torch hub into its modelzoo encoders,
``unet_baseline/models/modelzoo/senet.py:436-458`` /
``modelzoo/resnet.py``) in a zero-egress world: given a torch
``state_dict`` the *user* already has on disk (e.g. the hub file the
reference downloads), copy it into this package's torch backbones, torch to
torch: the tensors go straight into the modules' parameters and buffers,
with no other layout in between.

Conversion rules (the JAX importer's, in torch layouts)
-------------------------------------------------------
- Conv weights stay OIHW (grouped and depthwise ones too).
- SE gates stored as 1x1 convs (senet.py ``SEModule.fc1/fc2``,
  efficientnet's ``_se_reduce/_se_expand``) become the ``nn.Linear`` weights
  ``(out, in)`` of the port's gates.
- BatchNorm → GroupNorm (``norm_type="group"``, the models' default):
  running stats are *folded* into the affine pair (``weight = γ/√(var+ε)``,
  ``bias = β − mean·weight``). GroupNorm re-normalizes activations, so this
  is an **initialization transfer** (what fine-tuning needs), not a
  function-preserving conversion. With ``norm_type="batch"`` (the model
  built with the same option) γ/β and the running statistics load into the
  port's ``BatchNorm`` unchanged: FUNCTION-PRESERVING in eval mode.
- Input-channel inflation: a 3-channel stem weight is tiled to the target
  channel count and rescaled by ``3/C_in`` so pre-activation magnitudes
  are preserved (standard 2-frame/6-channel inflation trick).

Supported torch layouts:
- SE-ResNeXt (Cadene ``pretrainedmodels`` senet layout — what the
  reference's ``modelzoo/senet.py`` is): ``layer0.conv1/bn1``,
  ``layer{1..4}.{i}.conv{1,2,3}/bn{1,2,3}``, ``se_module.fc{1,2}``
  (1x1 convs), ``downsample.{0,1}``.
- ResNet (torchvision layout): ``conv1/bn1``,
  ``layer{1..4}.{i}.conv{1,2[,3]}/bn{1,2[,3]}``, ``downsample.{0,1}``.
- EfficientNet (efficientnet-pytorch layout — what the reference's
  ``modelzoo/efficientNet.py`` is): ``_conv_stem/_bn0``,
  ``_blocks.{i}._expand_conv/_bn0, _depthwise_conv/_bn1,
  _se_reduce/_se_expand, _project_conv/_bn2``.

NOT supported: dpn (the trunk is a generic dual-path re-implementation
whose widths differ from Cadene dpn68 — nearly every tensor would
shape-skip), and the compacted xception/inception trunks (structurally
impossible; see docs/PARITY.md).

Classifier heads (``last_linear`` / ``fc``) are dropped — the detector
heads are task-specific. A checkpoint shallower than the model leaves the
missing blocks at their initialisation; only shape-matching tensors are
replaced, and the rest is reported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from lyft3d_tpu_torch.models.backbones.efficientnet import (
    _BASE_BLOCKS,
    _SCALING,
    EfficientNet,
    _round_repeats,
)
from lyft3d_tpu_torch.models.backbones.resnet import ResNet
from lyft3d_tpu_torch.models.backbones.seresnext import SEResNeXt

__all__ = [
    "load_torch_state_dict",
    "normalize_state_dict",
    "linear_weight",
    "fold_bn",
    "inflate_input_channels",
    "seresnext_params_from_torch",
    "resnet_params_from_torch",
    "efficientnet_params_from_torch",
    "load_pretrained_backbone",
]

BN_EPS = 1e-5


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint file into a flat {name: np.ndarray} dict.

    Handles the common nestings the reference strips by hand: a
    ``state_dict`` wrapper key and ``module.`` DataParallel prefixes
    (``unet-inference-with-map.py:568-586``).
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return normalize_state_dict(obj)


def normalize_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    """Unwrap/strip a loaded torch checkpoint object to flat numpy arrays."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, Mapping) and "model_state" in obj:  # torchplus ckpt
        obj = obj["model_state"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def linear_weight(w: np.ndarray) -> np.ndarray:
    """A Linear weight ``(out, in)``; 1x1-conv SE gates (senet.py SEModule
    fc1/fc2 are Conv2d) are squeezed to it."""
    if w.ndim == 4:  # (O, I, 1, 1) 1x1 conv used as a linear layer
        w = w[:, :, 0, 0]
    return w


def fold_bn(sd: Mapping[str, np.ndarray], prefix: str, eps: float = BN_EPS):
    """Fold BN running stats into a (weight, bias) affine pair for GroupNorm."""
    gamma = sd[prefix + ".weight"].astype(np.float32)
    beta = sd[prefix + ".bias"].astype(np.float32)
    mean = sd[prefix + ".running_mean"].astype(np.float32)
    var = sd[prefix + ".running_var"].astype(np.float32)
    scale = gamma / np.sqrt(var + eps)
    return {"weight": scale, "bias": beta - mean * scale}


def inflate_input_channels(weight: np.ndarray, in_channels: int) -> np.ndarray:
    """Tile an OIHW stem weight's input channels to ``in_channels``.

    Rescales by ``orig/in_channels`` so the expected pre-activation
    magnitude is unchanged when the extra channels carry similar data.
    """
    orig = weight.shape[1]
    if orig == in_channels:
        return weight
    reps = -(-in_channels // orig)  # ceil
    tiled = np.tile(weight, (1, reps, 1, 1))[:, :in_channels]
    return tiled * (orig / in_channels)


def _conv_norm_act(sd, conv_name: str, bn_name: str,
                   in_channels: int | None = None, norm_type: str = "group"):
    """A ``ConvNormAct``'s tensors from torch conv+bn tensors.

    norm_type="group": BN stats folded into the GroupNorm affine
    (initialization transfer — GN re-normalizes, see module docstring).
    norm_type="batch": FUNCTION-PRESERVING — γ/β and the running mean/var
    go to the port's BatchNorm as they are.
    """
    weight = sd[conv_name + ".weight"]
    if in_channels is not None:
        weight = inflate_input_channels(weight, in_channels)
    if norm_type == "batch":
        norm = {
            "weight": sd[bn_name + ".weight"].astype(np.float32),
            "bias": sd[bn_name + ".bias"].astype(np.float32),
            "running_mean": sd[bn_name + ".running_mean"].astype(np.float32),
            "running_var": sd[bn_name + ".running_var"].astype(np.float32),
        }
    else:
        norm = fold_bn(sd, bn_name)
    return {"conv": {"weight": weight}, "norm": norm}


def _linear(sd, name: str):
    return {"weight": linear_weight(sd[name + ".weight"]), "bias": sd[name + ".bias"]}


def seresnext_params_from_torch(
    sd: Mapping[str, np.ndarray],
    stage_sizes: Sequence[int] = (3, 4, 23, 3),
    in_channels: int = 6,
    norm_type: str = "group",
) -> Dict[str, Any]:
    """Map a Cadene-senet state_dict onto the ``SEResNeXt`` module's names."""
    cna = lambda *a, **kw: _conv_norm_act(sd, *a, norm_type=norm_type, **kw)
    stages: Dict[str, Any] = {}
    for si, n_blocks in enumerate(stage_sizes):
        for bi in range(n_blocks):
            p = f"layer{si + 1}.{bi}"
            if p + ".conv1.weight" not in sd:
                # Shallower torch checkpoint: leave this block at its
                # initialisation (reference load_pretrain skip semantics).
                continue
            blk: Dict[str, Any] = {
                "conv1": cna(p + ".conv1", p + ".bn1"),
                "conv2": cna(p + ".conv2", p + ".bn2"),
                "conv3": cna(p + ".conv3", p + ".bn3"),
                "se": {"fc1": _linear(sd, p + ".se_module.fc1"),
                       "fc2": _linear(sd, p + ".se_module.fc2")},
            }
            if p + ".downsample.0.weight" in sd:
                blk["downsample"] = cna(p + ".downsample.0", p + ".downsample.1")
            stages.setdefault(str(si), {})[str(bi)] = blk
    return {"stem": cna("layer0.conv1", "layer0.bn1", in_channels), "stages": stages}


def resnet_params_from_torch(
    sd: Mapping[str, np.ndarray],
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    bottleneck: bool = False,
    in_channels: int = 6,
    norm_type: str = "group",
) -> Dict[str, Any]:
    """Map a torchvision-resnet state_dict onto the ``ResNet`` module's names."""
    cna = lambda *a, **kw: _conv_norm_act(sd, *a, norm_type=norm_type, **kw)
    n_convs = 3 if bottleneck else 2
    stages: Dict[str, Any] = {}
    for si, n_blocks in enumerate(stage_sizes):
        for bi in range(n_blocks):
            p = f"layer{si + 1}.{bi}"
            if p + ".conv1.weight" not in sd:
                continue
            blk = {f"conv{ci + 1}": cna(f"{p}.conv{ci + 1}", f"{p}.bn{ci + 1}") for ci in range(n_convs)}
            if p + ".downsample.0.weight" in sd:
                blk["downsample"] = cna(p + ".downsample.0", p + ".downsample.1")
            stages.setdefault(str(si), {})[str(bi)] = blk
    return {"stem": cna("conv1", "bn1", in_channels), "stages": stages}


def efficientnet_params_from_torch(
    sd: Mapping[str, np.ndarray],
    variant: str = "b0",
    in_channels: int = 6,
    norm_type: str = "group",
) -> Dict[str, Any]:
    """Map an efficientnet-pytorch state_dict onto the ``EfficientNet``
    module's names.

    The reference's ``modelzoo/efficientNet.py`` IS this layout
    (``_conv_stem``/``_bn0``, ``_blocks.{i}._expand_conv/_depthwise_conv/
    _project_conv`` + ``_bn0/1/2`` + ``_se_reduce/_se_expand``), and the
    port's ``EfficientNet`` keeps its MBConv blocks in the same compound-
    scaled order, so the mapping is 1:1 per block."""
    cna = lambda *a, **kw: _conv_norm_act(sd, *a, norm_type=norm_type, **kw)
    _, dm = _SCALING[variant]
    blocks: Dict[str, Any] = {}
    bi = 0
    for expand, _ch, reps, _stride, _k in _BASE_BLOCKS:
        for _ in range(_round_repeats(reps, dm)):
            p = f"_blocks.{bi}"
            if p + "._depthwise_conv.weight" in sd:  # else a shallower checkpoint: keep the init
                blk: Dict[str, Any] = {}
                if expand != 1:
                    blk["expand"] = cna(p + "._expand_conv", p + "._bn0")
                blk["depthwise"] = cna(p + "._depthwise_conv", p + "._bn1")
                blk["se1"] = _linear(sd, p + "._se_reduce")
                blk["se2"] = _linear(sd, p + "._se_expand")
                blk["project"] = cna(p + "._project_conv", p + "._bn2")
                blocks[str(bi)] = blk
            bi += 1
    return {"stem": cna("_conv_stem", "_bn0", in_channels), "blocks": blocks}


_BACKBONE_SPECS = {
    "seresnext26": (SEResNeXt, seresnext_params_from_torch, {"stage_sizes": (2, 2, 2, 2)}),
    "seresnext50": (SEResNeXt, seresnext_params_from_torch, {"stage_sizes": (3, 4, 6, 3)}),
    "seresnext101": (SEResNeXt, seresnext_params_from_torch, {"stage_sizes": (3, 4, 23, 3)}),
    "resnet18": (ResNet, resnet_params_from_torch, {"stage_sizes": (2, 2, 2, 2)}),
    "resnet34": (ResNet, resnet_params_from_torch, {"stage_sizes": (3, 4, 6, 3)}),
    "resnet50": (
        ResNet,
        resnet_params_from_torch,
        {"stage_sizes": (3, 4, 6, 3), "bottleneck": True},
    ),
    **{
        f"efficientnet_{v}": (
            EfficientNet, efficientnet_params_from_torch, {"variant": v},
        )
        for v in ("b0", "b1", "b2", "b3", "b4", "b5")
    },
}

_NORMS = {"group": nn.GroupNorm, "batch": nn.BatchNorm2d}


@torch.no_grad()
def _merge(dst: nn.Module, src: Mapping[str, Any], path: str, report: list, norm_type: str):
    """Shape-checked recursive copy into ``dst`` (reference
    filter_param_dict semantics, second/pytorch/train.py:117-206 /
    models/model.py:50-60): matching shapes are replaced, mismatches and
    unknown names (a submodule, or a norm of the other kind) are skipped and
    reported."""
    for k, v in src.items():
        where = f"{path}.{k}"
        if isinstance(v, Mapping):
            child = dst._modules.get(k)
            if child is None or (k == "norm" and not isinstance(child, _NORMS[norm_type])):
                report.append(("missing", where))
                continue
            _merge(child, v, where, report, norm_type)
            continue
        tensors = dict(dst.named_parameters(recurse=False))
        tensors.update(dst.named_buffers(recurse=False))
        cur = tensors.get(k)
        if cur is None:
            report.append(("missing", where))
        elif tuple(cur.shape) != tuple(np.shape(v)):
            report.append(("shape", where))
        else:
            cur.copy_(torch.from_numpy(np.ascontiguousarray(v)))
            report.append(("loaded", where))


def load_pretrained_backbone(
    module: nn.Module,
    state_dict: Mapping[str, np.ndarray],
    backbone: str,
    in_channels: int = 6,
    verbose: bool = False,
    norm_type: str = "group",
) -> nn.Module:
    """Copy the named backbone's converted torch weights into ``module`` (in
    place; returns it).

    ``module`` is a model built around one of the zoo backbones (e.g.
    ``unet_seresnext101``), or the backbone itself; the first submodule of
    the backbone's class is the target. Partial-load semantics match the
    reference's ``load_pretrain``: only shape-matching tensors are replaced.

    With ``norm_type="batch"`` (the model built with the same option) the
    conversion is FUNCTION-PRESERVING in eval mode: BN γ/β and the running
    mean/var load into the port's BatchNorm.
    """
    if backbone not in _BACKBONE_SPECS:
        raise KeyError(
            f"no torch importer for backbone {backbone!r}; "
            f"supported: {sorted(_BACKBONE_SPECS)}"
        )
    if norm_type not in _NORMS:
        raise ValueError(f"norm_type must be one of {sorted(_NORMS)}, got {norm_type!r}")
    cls, fn, kw = _BACKBONE_SPECS[backbone]
    converted = fn(normalize_state_dict(state_dict), in_channels=in_channels,
                   norm_type=norm_type, **kw)
    target = next((m for m in module.modules() if isinstance(m, cls)), None)
    if target is None:
        raise KeyError(f"backbone {cls.__name__} not found in {type(module).__name__}")
    report: list = []
    _merge(target, converted, cls.__name__, report, norm_type)
    loaded = sum(1 for s, _ in report if s == "loaded")
    skipped = [w for s, w in report if s != "loaded"]
    if verbose or skipped:
        print(f"[torch_import] loaded {loaded} tensors, skipped {len(skipped)}")
        for w in skipped[:20]:
            print(f"[torch_import]   skipped {w}")
    return module
