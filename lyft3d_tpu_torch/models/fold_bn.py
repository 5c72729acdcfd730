"""Fold BatchNorm statistics into conv and Dense kernels for inference
(port of ``lyft3d_tpu/models/fold_bn.py``).

Turns a ``norm_type="batch"`` model into the same model with
``norm_type="folded"`` (conv with bias, no norm op), and a PointRCNN
``SharedMLP(norm="batch")`` into ``norm="folded"`` (Linear with bias),
function-preserving for eval outputs:

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv'(x) + bias'      with  kernel' = kernel * s, bias' = beta - mean * s,
                                    s = gamma / sqrt(var + eps)
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct
from lyft3d_tpu_torch.models.pointrcnn.modules import SharedMLP

__all__ = ["fold_batch_norms"]


def _fold_into(layer: nn.Module, bn: nn.BatchNorm2d):
    """kernel' = kernel·s along the output channels, bias' = beta − mean·s
    (+ old bias·s); ``layer`` is a conv or a Linear, changed in place."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    kernel = layer.weight.float() * s.view(-1, *([1] * (layer.weight.dim() - 1)))
    bias = bn.bias.float() - bn.running_mean.float() * s
    if layer.bias is not None:
        bias = bias + layer.bias.float() * s
    layer.weight.copy_(kernel.to(layer.weight.dtype))
    layer.bias = nn.Parameter(bias.to(layer.weight.dtype))


@torch.no_grad()
def fold_batch_norms(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ConvNormAct's BatchNorm folded into its
    conv and every SharedMLP's into its Linear layers. The copy has the
    state-dict layout of the model built with ``norm_type="folded"`` (or
    ``norm="folded"``); ``model`` is left unchanged."""
    folded = copy.deepcopy(model)
    for m in folded.modules():
        if isinstance(m, ConvNormAct) and isinstance(m.norm, nn.BatchNorm2d):
            _fold_into(m.conv, m.norm)
            m.norm = None
        elif isinstance(m, SharedMLP):
            for i, (linear, bn) in enumerate(zip(m.linears, m.norms)):
                if isinstance(bn, nn.BatchNorm2d):
                    _fold_into(linear, bn)
                    m.norms[i] = nn.Identity()
    return folded
