"""Fold BatchNorm statistics into conv kernels for inference
(port of ``lyft3d_tpu/models/fold_bn.py``).

Turns a ``norm_type="batch"`` model into the same model with
``norm_type="folded"`` (conv with bias, no norm op), function-preserving for
eval outputs:

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv'(x) + bias'      with  kernel' = kernel * s, bias' = beta - mean * s,
                                    s = gamma / sqrt(var + eps)
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import ConvNormAct

__all__ = ["fold_batch_norms"]


@torch.no_grad()
def fold_batch_norms(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ConvNormAct's BatchNorm folded into its
    conv. The copy has the state-dict layout of the model built with
    ``norm_type="folded"``; ``model`` is left unchanged."""
    folded = copy.deepcopy(model)
    for m in folded.modules():
        if not (isinstance(m, ConvNormAct) and isinstance(m.norm, nn.BatchNorm2d)):
            continue
        conv, bn = m.conv, m.norm
        s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
        kernel = conv.weight.float() * s[:, None, None, None]
        bias = bn.bias.float() - bn.running_mean.float() * s
        if conv.bias is not None:
            bias = bias + conv.bias.float() * s
        conv.weight.copy_(kernel.to(conv.weight.dtype))
        conv.bias = nn.Parameter(bias.to(conv.weight.dtype))
        m.norm = None
    return folded
