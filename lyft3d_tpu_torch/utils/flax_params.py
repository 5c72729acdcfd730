"""The weight bridge: the JAX package's flax variables ↔ this port's modules.

:func:`load_flax_params` takes a ``{"params": …, "batch_stats": …}`` tree
(nested dicts of numpy-convertible arrays, as ``model.init`` returns them)
and copies it into the matching torch module:

- conv kernel HWIO → OIHW, grouped ones too (flax's ``(kh, kw, in/g, out)``
  gives output channel ``o`` to group ``o // (out/g)``, in ``nn.Conv`` and in
  the block-diagonal ``PackedGroupedConv`` alike, as torch's
  ``(out, in/g, kh, kw)`` does); Dense kernel (in, out) → (out, in); sparse conv
  kernels ``(27, Cin, Cout)`` as they are; the ``nn.vmap``ped modules (the
  RoI encoder of PointRCNN, the per-voxel sparse middle of SECOND) have one
  shared set of parameters under a ``Vmap_…`` name;
- GroupNorm / LayerNorm / BatchNorm ``scale``/``bias`` → ``weight``/``bias``, and
  BatchNorm ``mean``/``var`` (under ``batch_stats``) → the running buffers.

The mapping is written out per module type below and follows flax's
auto-naming (``ConvNormAct_0``, ``Conv_0``, ``Dense_1``, …). It raises if any
flax leaf is left unused or any torch parameter or buffer is left unfilled
(``num_batches_tracked`` has no flax counterpart and is set to 0), and on any
shape mismatch.

:func:`export_flax_params` is the reverse, through the same mapping: a module
→ the ``{"params": …}`` tree as float32 numpy arrays, so that a test can take
an optimizer step in both packages and compare the updated weights leaf by
leaf. It raises on a torch tensor the mapping does not name.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from lyft3d_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from lyft3d_tpu_torch.models.backbones.seresnext import SEResNeXt, SEResNeXtBlock
from lyft3d_tpu_torch.models.layers import ASPP, ConvNormAct, LayerNorm, SEModule, UpBlock
from lyft3d_tpu_torch.models.pointrcnn.modules import (
    FPModule,
    SAModuleGlobal,
    SAModuleMSG,
    SharedMLP,
)
from lyft3d_tpu_torch.models.pointrcnn.net import (
    PointRCNN,
    PointRCNN_RCNN,
    PointRCNN_RPN,
    PointRCNNBackbone,
)
from lyft3d_tpu_torch.models.second.middle import SparseMiddle, SparseMiddleUnits
from lyft3d_tpu_torch.models.second.rpn import RPN
from lyft3d_tpu_torch.models.second.voxel_encoder import PillarFeatureNet
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.models.unet import LyftUNet, ReferenceUNet

__all__ = ["load_flax_params", "export_flax_params"]

Path = Tuple[str, ...]


def _flatten(tree, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val, dtype=np.float32)
    return out


class _Source:
    """Flax leaves by path; remembers which were taken."""

    def __init__(self, tree):
        self.params = _flatten(tree.get("params", {}))
        self.stats = _flatten(tree.get("batch_stats", {}))
        self.used = set()

    def take(self, collection: str, path: Path) -> np.ndarray:
        leaves = self.params if collection == "params" else self.stats
        if path not in leaves:
            raise KeyError(f"flax leaf {collection}/{'/'.join(path)} not found")
        self.used.add((collection, path))
        return leaves[path]

    def unused(self):
        return sorted(
            f"{c}/{'/'.join(p)}"
            for c, leaves in (("params", self.params), ("batch_stats", self.stats))
            for p in leaves
            if (c, p) not in self.used
        )


Out = Dict[str, np.ndarray]


def _conv(conv: nn.Conv2d, src: _Source, path: Path, name: str, out: Out):
    out[f"{name}.weight"] = src.take("params", path + ("kernel",)).transpose(3, 2, 0, 1)
    if conv.bias is not None:
        out[f"{name}.bias"] = src.take("params", path + ("bias",))


def _dense(src: _Source, path: Path, name: str, out: Out, bias: bool = True):
    out[f"{name}.weight"] = src.take("params", path + ("kernel",)).T
    if bias:
        out[f"{name}.bias"] = src.take("params", path + ("bias",))


def _norm(src: _Source, path: Path, name: str, out: Out):
    out[f"{name}.weight"] = src.take("params", path + ("scale",))
    out[f"{name}.bias"] = src.take("params", path + ("bias",))


def _batch_norm(src: _Source, path: Path, name: str, out: Out):
    """The port's BatchNorm: ``scale``/``bias`` and the float32 running
    statistics under ``batch_stats``."""
    _norm(src, path, name, out)
    out[f"{name}.running_mean"] = src.take("batch_stats", path + ("mean",))
    out[f"{name}.running_var"] = src.take("batch_stats", path + ("var",))


def _conv_norm_act(m: ConvNormAct, src, path, name, out):
    _conv(m.conv, src, path + ("Conv_0",), f"{name}conv", out)
    if isinstance(m.norm, nn.BatchNorm2d):  # the port's BatchNorm
        _batch_norm(src, path + ("BatchNorm_0",), f"{name}norm", out)
    elif isinstance(m.norm, nn.GroupNorm):
        _norm(src, path + ("GroupNorm_0",), f"{name}norm", out)


def _se(m: SEModule, src, path, name, out):
    _dense(src, path + ("Dense_0",), f"{name}fc1", out)
    _dense(src, path + ("Dense_1",), f"{name}fc2", out)


def _aspp(m: ASPP, src, path, name, out):
    # flax order of creation: 1x1, one per rate, pooled 1x1, projection.
    cnas = [*m.branches, m.pool, m.project]
    names = [f"branches.{i}" for i in range(len(m.branches))] + ["pool", "project"]
    for i, (cna, sub) in enumerate(zip(cnas, names)):
        _conv_norm_act(cna, src, path + (f"ConvNormAct_{i}",), f"{name}{sub}.", out)


def _up_block(m: UpBlock, src, path, name, out):
    _conv_norm_act(m.conv1, src, path + ("ConvNormAct_0",), f"{name}conv1.", out)
    _conv_norm_act(m.conv2, src, path + ("ConvNormAct_1",), f"{name}conv2.", out)
    _se(m.se, src, path + ("SEModule_0",), f"{name}se.", out)


def _block(m, src, path, name, out):
    convs = ["conv1", "conv2"] + (["conv3"] if isinstance(m, Bottleneck) else [])
    if m.downsample is not None:
        convs.append("downsample")
    for i, sub in enumerate(convs):
        _conv_norm_act(getattr(m, sub), src, path + (f"ConvNormAct_{i}",), f"{name}{sub}.", out)


def _resnet(m: ResNet, src, path, name, out):
    _conv_norm_act(m.stem, src, path + ("ConvNormAct_0",), f"{name}stem.", out)
    k = 0  # flax numbers blocks across stages
    for si, stage in enumerate(m.stages):
        for bi, block in enumerate(stage):
            flax_name = f"{type(block).__name__}_{k}"
            _block(block, src, path + (flax_name,), f"{name}stages.{si}.{bi}.", out)
            k += 1


def _seresnext_block(m: SEResNeXtBlock, src, path, name, out):
    # flax creation order: the three convs, the SE gate, then the downsample.
    for i, sub in enumerate(("conv1", "conv2", "conv3")):
        _conv_norm_act(getattr(m, sub), src, path + (f"ConvNormAct_{i}",), f"{name}{sub}.", out)
    _se(m.se, src, path + ("SEModule_0",), f"{name}se.", out)
    if m.downsample is not None:
        _conv_norm_act(m.downsample, src, path + ("ConvNormAct_3",), f"{name}downsample.", out)


def _seresnext(m: SEResNeXt, src, path, name, out):
    _conv_norm_act(m.stem, src, path + ("ConvNormAct_0",), f"{name}stem.", out)
    k = 0  # flax numbers blocks across stages
    for si, stage in enumerate(m.stages):
        for bi, block in enumerate(stage):
            _seresnext_block(block, src, path + (f"SEResNeXtBlock_{k}",), f"{name}stages.{si}.{bi}.", out)
            k += 1


_BACKBONE_MAPPERS: Dict[type, Tuple[str, Callable]] = {
    ResNet: ("ResNet_0", _resnet),
    SEResNeXt: ("SEResNeXt_0", _seresnext),
}


def _lyft_unet(m: LyftUNet, src, path, name, out):
    flax_name, backbone = _BACKBONE_MAPPERS[type(m.backbone)]
    backbone(m.backbone, src, path + (flax_name,), f"{name}backbone.", out)
    # ConvNormAct_0..2: skip reductions; ConvNormAct_3: hypercolumn conv.
    for i, cna in enumerate(m.skips):
        _conv_norm_act(cna, src, path + (f"ConvNormAct_{i}",), f"{name}skips.{i}.", out)
    _conv_norm_act(m.hyper, src, path + (f"ConvNormAct_{len(m.skips)}",), f"{name}hyper.", out)
    _aspp(m.aspp, src, path + ("ASPP_0",), f"{name}aspp.", out)
    _dense(src, path + ("Dense_0",), f"{name}aux", out)
    for i, up in enumerate(m.decoder):
        _up_block(up, src, path + (f"UpBlock_{i}",), f"{name}decoder.{i}.", out)
    _conv(m.head, src, path + ("Conv_0",), f"{name}head", out)


def _reference_unet(m: ReferenceUNet, src, path, name, out):
    k = 0  # flax numbers every ConvNormAct in creation order
    for group, prefix in ((m.down, "down"), ([m.bottom], "bottom"), (m.up, "up")):
        for gi, pair in enumerate(group):
            base = f"{prefix}.{gi}." if prefix != "bottom" else "bottom."
            for pi, cna in enumerate(pair):
                _conv_norm_act(cna, src, path + (f"ConvNormAct_{k}",), f"{name}{base}{pi}.", out)
                k += 1
    _conv(m.head, src, path + ("Conv_0",), f"{name}head", out)


def _pillar_feature_net(m: PillarFeatureNet, src, path, name, out):
    for i in range(len(m.linears)):
        _dense(src, path + (f"Dense_{i}",), f"{name}linears.{i}", out, bias=False)
        _norm(src, path + (f"LayerNorm_{i}",), f"{name}norms.{i}", out)


def _rpn(m: RPN, src, path, name, out):
    k = 0  # flax numbers every ConvNormAct in creation order: block, then its up branch
    for bi, (block, up) in enumerate(zip(m.blocks, m.ups)):
        for li, cna in enumerate(block):
            _conv_norm_act(cna, src, path + (f"ConvNormAct_{k}",), f"{name}blocks.{bi}.{li}.", out)
            k += 1
        _conv_norm_act(up, src, path + (f"ConvNormAct_{k}",), f"{name}ups.{bi}.", out)
        k += 1
    for i, head in enumerate(("box", "cls", "dir")):
        _conv(getattr(m, head), src, path + (f"Conv_{i}",), f"{name}{head}", out)


def _sparse_layer(m, src, path, name, out):
    """A sparse conv layer: its kernel, and LayerNorm_0 ("layer") or bias ("folded")."""
    out[f"{name}kernel"] = src.take("params", path + ("kernel",))
    if m.norm is not None:
        _norm(src, path + ("LayerNorm_0",), f"{name}norm", out)
    if m.bias is not None:
        out[f"{name}bias"] = src.take("params", path + ("bias",))


def _sparse_middle(subm_name: str, strided_name: str):
    def mapper(m, src, path, name, out):
        for i, layer in enumerate(m.subm):
            _sparse_layer(layer, src, path + (f"{subm_name}_{i}",), f"{name}subm.{i}.", out)
        for i, layer in enumerate(m.strided):
            _sparse_layer(layer, src, path + (f"{strided_name}_{i}",), f"{name}strided.{i}.", out)
    return mapper


_sparse_middle_units = _sparse_middle("SubMUnitLayer", "StridedUnitLayer")
_sparse_middle_voxels = _sparse_middle("SubMConvLayer", "SparseConvLayer")


def _voxelnet(m: VoxelNet, src, path, name, out):
    if isinstance(m.middle, SparseMiddleUnits):  # SimpleVoxel has no parameters
        _sparse_middle_units(m.middle, src, path + ("SparseMiddleUnits_0",), f"{name}middle.", out)
    elif isinstance(m.middle, SparseMiddle):
        # nn.vmap over the samples shares one set of parameters.
        _sparse_middle_voxels(m.middle, src, path + ("Vmap_SparseMiddleBatch_0", "SparseMiddle_0"),
                              f"{name}middle.", out)
    else:
        _pillar_feature_net(m.encoder, src, path + ("PillarFeatureNet_0",), f"{name}encoder.", out)
    _rpn(m.rpn, src, path + ("RPN_0",), f"{name}rpn.", out)


def _shared_mlp(m: SharedMLP, src, path, name, out):
    for i, (linear, norm) in enumerate(zip(m.linears, m.norms)):
        _dense(src, path + (f"Dense_{i}",), f"{name}linears.{i}", out, bias=linear.bias is not None)
        if isinstance(norm, LayerNorm):
            _norm(src, path + (f"LayerNorm_{i}",), f"{name}norms.{i}", out)
        elif isinstance(norm, nn.BatchNorm2d):  # the port's BatchNorm over the last dim
            _batch_norm(src, path + (f"BatchNorm_{i}",), f"{name}norms.{i}", out)


def _sa_msg(m: SAModuleMSG, src, path, name, out):
    for i, mlp in enumerate(m.mlps):
        _shared_mlp(mlp, src, path + (f"SharedMLP_{i}",), f"{name}mlps.{i}.", out)


def _sa_global(m: SAModuleGlobal, src, path, name, out):
    _shared_mlp(m.mlp, src, path + ("SharedMLP_0",), f"{name}mlp.", out)


def _fp_module(m: FPModule, src, path, name, out):
    _shared_mlp(m.mlp, src, path + ("SharedMLP_0",), f"{name}mlp.", out)


def _pointrcnn_backbone(m: PointRCNNBackbone, src, path, name, out):
    for i, sa in enumerate(m.sa):
        _sa_msg(sa, src, path + (f"SAModuleMSG_{i}",), f"{name}sa.{i}.", out)
    for i, fp in enumerate(m.fp):
        _fp_module(fp, src, path + (f"FPModule_{i}",), f"{name}fp.{i}.", out)


def _pointrcnn_rpn(m: PointRCNN_RPN, src, path, name, out):
    _pointrcnn_backbone(m.backbone, src, path + ("PointRCNNBackbone_0",), f"{name}backbone.", out)
    _shared_mlp(m.mlp, src, path + ("SharedMLP_0",), f"{name}mlp.", out)
    _dense(src, path + ("Dense_0",), f"{name}cls", out)
    _dense(src, path + ("Dense_1",), f"{name}reg", out)


def _pointrcnn_rcnn(m: PointRCNN_RCNN, src, path, name, out):
    # nn.vmap over the RoIs shares one set of encoder parameters.
    enc, ep, en = m.encoder, path + ("Vmap_RoIEncoder_0",), f"{name}encoder."
    _shared_mlp(enc.lift, src, ep + ("SharedMLP_0",), f"{en}lift.", out)
    for i, sa in enumerate(enc.sa):
        _sa_msg(sa, src, ep + (f"SAModuleMSG_{i}",), f"{en}sa.{i}.", out)
    _sa_global(enc.pool, src, ep + ("SAModuleGlobal_0",), f"{en}pool.", out)
    for i, sub in enumerate(("fc", "cls", "reg")):
        _dense(src, path + (f"Dense_{i}",), f"{name}{sub}", out)


def _pointrcnn(m: PointRCNN, src, path, name, out):
    _pointrcnn_rpn(m.rpn, src, path + ("PointRCNN_RPN_0",), f"{name}rpn.", out)
    _pointrcnn_rcnn(m.rcnn, src, path + ("PointRCNN_RCNN_0",), f"{name}rcnn.", out)


_MAPPERS: Dict[type, Callable] = {
    ConvNormAct: _conv_norm_act,
    SEModule: _se,
    ASPP: _aspp,
    UpBlock: _up_block,
    SEResNeXt: _seresnext,
    LyftUNet: _lyft_unet,
    ReferenceUNet: _reference_unet,
    PillarFeatureNet: _pillar_feature_net,
    RPN: _rpn,
    SparseMiddleUnits: _sparse_middle_units,
    SparseMiddle: _sparse_middle_voxels,
    VoxelNet: _voxelnet,
    SharedMLP: _shared_mlp,
    SAModuleMSG: _sa_msg,
    SAModuleGlobal: _sa_global,
    FPModule: _fp_module,
    PointRCNNBackbone: _pointrcnn_backbone,
    PointRCNN_RPN: _pointrcnn_rpn,
    PointRCNN_RCNN: _pointrcnn_rcnn,
    PointRCNN: _pointrcnn,
}


@torch.no_grad()
def load_flax_params(module: nn.Module, tree) -> nn.Module:
    """Copy the flax variables ``tree`` into ``module`` (in place); returns it."""
    mapper = _MAPPERS.get(type(module))
    if mapper is None:
        raise TypeError(f"no flax mapping for {type(module).__name__}")
    src = _Source(tree)
    arrays: Out = {}
    mapper(module, src, (), "", arrays)
    unused = src.unused()
    if unused:
        raise ValueError(f"flax leaves not used by {type(module).__name__}: {unused}")
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    unfilled = sorted(
        k for k in targets if k not in arrays and not k.endswith("num_batches_tracked")
    )
    if unfilled:
        raise ValueError(f"torch tensors of {type(module).__name__} left unfilled: {unfilled}")
    stray = sorted(set(arrays) - set(targets))
    if stray:
        raise ValueError(f"mapping names tensors {type(module).__name__} lacks: {stray}")
    for key, t in targets.items():
        if key.endswith("num_batches_tracked"):
            t.zero_()
            continue
        arr = arrays[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} vs torch {tuple(t.shape)}")
        t.copy_(torch.tensor(arr))
    return module


class _Ref:
    """Stands for a flax leaf in a mapper run by :func:`export_flax_params`:
    remembers the leaf's path and the axis permutation the mapper applies."""

    def __init__(self, collection: str, path: Path, perm=None):
        self.collection, self.path, self.perm = collection, path, perm

    def transpose(self, *axes):
        return _Ref(self.collection, self.path, axes)

    @property
    def T(self):
        return _Ref(self.collection, self.path, (1, 0))


class _Recorder:
    def take(self, collection: str, path: Path) -> _Ref:
        return _Ref(collection, path)


@torch.no_grad()
def export_flax_params(module: nn.Module):
    """The flax variables of ``module``: ``{"params": …}`` (and
    ``"batch_stats"`` where the module has running statistics) as nested
    dicts of float32 numpy arrays in flax's layouts and names."""
    mapper = _MAPPERS.get(type(module))
    if mapper is None:
        raise TypeError(f"no flax mapping for {type(module).__name__}")
    refs: Dict[str, _Ref] = {}
    mapper(module, _Recorder(), (), "", refs)
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    unmapped = sorted(
        k for k in targets if k not in refs and not k.endswith("num_batches_tracked")
    )
    if unmapped:
        raise ValueError(f"torch tensors of {type(module).__name__} without a flax name: {unmapped}")
    stray = sorted(set(refs) - set(targets))
    if stray:
        raise ValueError(f"mapping names tensors {type(module).__name__} lacks: {stray}")
    tree: Dict[str, dict] = {}
    for key, ref in refs.items():
        arr = targets[key].detach().float().cpu().numpy()
        if ref.perm is not None:
            arr = arr.transpose(np.argsort(ref.perm))
        node = tree.setdefault(ref.collection, {})
        for part in ref.path[:-1]:
            node = node.setdefault(part, {})
        node[ref.path[-1]] = np.ascontiguousarray(arr)
    return tree
