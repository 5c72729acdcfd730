"""PointNet++ set-abstraction and feature-propagation modules (port of
``lyft3d_tpu/models/pointrcnn/modules.py``).

Batched: xyz ``(B, N, 3)`` float32, features ``(B, N, C)``, valid ``(B, N)``;
the JAX package's per-sample ``vmap`` is the leading dimension. Geometry
stays float32; features, the grouped MLPs, the −inf slot mask and the max
run in the modules' ``dtype``, as in the flax modules. The flax modules
infer their input width; here it is an explicit first argument.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import BatchNorm, LayerNorm
from lyft3d_tpu_torch.ops.pointnet2 import (
    fps,
    group_points,
    multi_radius_ball_query,
    three_interpolate,
    three_nn,
)

__all__ = ["SharedMLP", "SAModuleMSG", "SAModuleGlobal", "FPModule"]

NORMS = ("layer", "batch", "folded")


class SharedMLP(nn.Module):
    """Pointwise Linear + norm + ReLU stack over the last dimension.

    ``norm``: "layer" (Linear without bias → LayerNorm with flax's
    statistics), "batch" (Linear without bias → BatchNorm over every
    dimension but the last, flax's statistics in train mode, the running ones
    in eval mode) or "folded" (Linear with bias, no norm op: the inference
    structure, which :func:`lyft3d_tpu_torch.models.fold_bn.fold_batch_norms`
    makes of a "batch" model). The input is cast to the weights' dtype.
    """

    def __init__(self, in_features: int, features: Sequence[int], norm: str = "layer",
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
        fk = {"device": device, "dtype": dtype}
        widths = [in_features, *features]
        self.linears = nn.ModuleList(
            nn.Linear(i, o, bias=norm == "folded", **fk) for i, o in zip(widths[:-1], widths[1:])
        )
        norms = {"layer": lambda o: LayerNorm(o, **fk),
                 "batch": lambda o: BatchNorm(o, channel_dim=-1, **fk),
                 "folded": lambda o: nn.Identity()}[norm]
        self.norms = nn.ModuleList(norms(o) for o in features)
        self.out_features = widths[-1]

    def forward(self, x):
        x = x.to(self.linears[0].weight.dtype)
        for linear, norm in zip(self.linears, self.norms):
            x = torch.relu(norm(linear(x)))
        return x


def _take_points(x, idx):
    """``x[b, idx[b, s]]`` for ``(B, N, …)`` x and ``(B, S)`` idx."""
    return group_points(x, idx[:, :, None])[:, :, 0]


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction: FPS → ball query at every radius
    (one kernel launch) → grouping → shared MLP → max over the group.

    ``forward(xyz (B, N, 3), features (B, N, C) or None, valid (B, N))`` →
    ``(new_xyz (B, S, 3), new_features (B, S, ΣC'), new_valid (B, S))``.
    ``in_features`` is C (0 without features).
    """

    def __init__(self, in_features: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]], use_xyz: bool = True,
                 norm: str = "layer", device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(k) for k in nsamples)
        self.use_xyz = use_xyz
        self.has_features = in_features > 0
        width = in_features + 3 if (use_xyz or not self.has_features) else in_features
        self.mlps = nn.ModuleList(
            SharedMLP(width, mlp, norm=norm, device=device, dtype=dtype) for mlp in mlps
        )
        self.out_features = sum(m.out_features for m in self.mlps)

    def forward(self, xyz, features, valid):
        dtype = self.mlps[0].linears[0].weight.dtype
        sel = fps(xyz, valid, self.npoint)
        new_xyz = _take_points(xyz, sel)
        new_valid = torch.gather(valid, 1, sel.long())

        # Features go to the compute dtype before the group gather (the
        # gathered tensor is the module's largest); geometry stays float32.
        feats_c = features.to(dtype) if features is not None else None
        queries = multi_radius_ball_query(new_xyz, xyz, valid, self.radii, self.nsamples)
        outs = []
        for (idx, count), nsample, mlp in zip(queries, self.nsamples, self.mlps):
            grouped = (group_points(xyz, idx) - new_xyz[:, :, None, :]).to(dtype)
            if feats_c is not None:
                gathered = group_points(feats_c, idx)
                grouped = torch.cat([grouped, gathered], dim=-1) if self.use_xyz else gathered
            h = mlp(grouped)  # (B, S, K, C')
            slots = torch.arange(nsample, device=xyz.device)
            slot_ok = slots < count.clamp(min=1)[..., None]
            h = torch.where(slot_ok[..., None], h, float("-inf"))
            pooled = h.amax(dim=2)
            outs.append(torch.where((count > 0)[..., None], pooled, 0.0))
        return new_xyz, torch.cat(outs, dim=-1), new_valid


class SAModuleGlobal(nn.Module):
    """Group-all set abstraction: shared MLP over every point, max over the
    valid ones → ``(B, C')``. ``in_features`` is the features' width C."""

    def __init__(self, in_features: int, mlp: Sequence[int], use_xyz: bool = True,
                 norm: str = "layer", device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_xyz = use_xyz
        self.mlp = SharedMLP(in_features + 3 if use_xyz else in_features, mlp, norm=norm,
                             device=device, dtype=dtype)
        self.out_features = self.mlp.out_features

    def forward(self, xyz, features, valid):
        x = torch.cat([xyz, features.to(xyz.dtype)], dim=-1) if self.use_xyz else features
        h = self.mlp(x)
        h = torch.where(valid[..., None], h, float("-inf"))
        return h.amax(dim=1)


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling of the known
    features (float32), concatenated with the unknown points' own features,
    then a shared MLP. ``in_features`` is the width after the concatenation."""

    def __init__(self, in_features: int, mlp: Sequence[int], norm: str = "layer",
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp, norm=norm, device=device, dtype=dtype)
        self.out_features = self.mlp.out_features

    def forward(self, unknown_xyz, unknown_feats, known_xyz, known_feats, known_valid):
        dists, idx = three_nn(unknown_xyz, known_xyz, known_valid)
        interp = three_interpolate(known_feats, idx, dists)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats.to(interp.dtype)], dim=-1)
        return self.mlp(interp)
