"""Voxel feature encoders (port of ``lyft3d_tpu/models/second/voxel_encoder.py``).

Operates on the fixed-capacity :func:`lyft3d_tpu_torch.ops.voxelize.voxelize`
output, batched: voxels ``(B, V, T, D)``, num_points ``(B, V)``, coords
``(B, V, 3)``: ``PillarFeatureNet`` and ``pillar_scatter`` (the Lyft
pillars config), ``SimpleVoxel`` (the sparse FHD config) and
``VoxelFeatureExtractor`` with its VFE layers (``encoder: vfe``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import LayerNorm
from lyft3d_tpu_torch.ops.dense_fill import fill_rows_by_id

__all__ = ["voxel_mean", "SimpleVoxel", "VFELayer", "VoxelFeatureExtractor", "PillarFeatureNet",
           "pillar_scatter"]


def _point_mask(voxels, num_points):
    """``(…, T, D)`` + ``(…,)`` → ``(…, T)`` membership mask in the voxels' dtype."""
    t = voxels.shape[-2]
    return (torch.arange(t, device=voxels.device) < num_points[..., None]).to(voxels.dtype)


def voxel_mean(voxels, num_points):
    """``(…, T, D)`` → ``(…, D)`` masked mean."""
    mask = _point_mask(voxels, num_points)
    s = (voxels * mask[..., None]).sum(dim=-2)
    return s / torch.clamp(num_points[..., None], min=1).to(voxels.dtype)


class SimpleVoxel(nn.Module):
    """Mean encoder: the mean of each voxel's points over the first
    ``num_features`` point dims, computed in the points' dtype and returned
    in ``dtype``. No parameters."""

    def __init__(self, num_features: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features = num_features
        self.dtype = dtype

    def forward(self, voxels, num_points, coords):
        return voxel_mean(voxels[..., : self.num_features], num_points).to(self.dtype)


class VFELayer(nn.Module):
    """Linear without bias to ``features // 2`` → LayerNorm → ReLU · mask, then
    each point's features concatenated with the voxel's max over its points
    (``features`` out). Empty slots are 0 after the mask, and the max runs
    over them too, as in the flax layer: a voxel's max is never below 0."""

    def __init__(self, in_features: int, features: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.linear = nn.Linear(in_features, features // 2, bias=False, **fk)
        self.norm = LayerNorm(features // 2, **fk)

    def forward(self, x, mask):
        """``x`` ``(…, T, C)``, ``mask`` ``(…, T, 1)`` in ``x``'s dtype."""
        h = torch.relu(self.norm(self.linear(x))) * mask
        return torch.cat([h, h.amax(dim=-2, keepdim=True).expand_as(h)], dim=-1)


class VoxelFeatureExtractor(nn.Module):
    """VFE encoder: each point with its offset from the voxel's point mean (and
    its distance from the origin with ``with_distance``), one
    :class:`VFELayer` a width of ``features``, then Linear without bias →
    LayerNorm → ReLU · mask and the max over the points.

    ``in_features`` is the point width D; the first layer takes D + 3 (+ 1).
    Preprocessing runs in the points' float32, the layers in ``dtype``; the
    output ``(…, V, features[-1])`` is in ``dtype``."""

    def __init__(self, in_features: int, features: Sequence[int] = (32, 128),
                 with_distance: bool = False, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.with_distance = with_distance
        widths = [in_features + 3 + int(with_distance), *features]
        self.vfe = nn.ModuleList(VFELayer(i, o, **fk) for i, o in zip(widths[:-1], widths[1:]))
        self.linear = nn.Linear(features[-1], features[-1], bias=False, **fk)
        self.norm = LayerNorm(features[-1], **fk)

    def forward(self, voxels, num_points, coords):
        mask = _point_mask(voxels, num_points)
        mean = voxel_mean(voxels[..., :3], num_points)
        feats = [voxels, voxels[..., :3] - mean[..., None, :]]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(voxels[..., :3], dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1).to(self.linear.weight.dtype)
        m = mask[..., None].to(x.dtype)
        for layer in self.vfe:
            x = layer(x, m)
        x = torch.relu(self.norm(self.linear(x))) * m
        return x.amax(dim=-2)


class PillarFeatureNet(nn.Module):
    """PointPillars encoder: each point augmented with its offset from the
    pillar's point mean and from the pillar centre, then (Linear without
    bias → LayerNorm → ReLU · mask) per layer and a max over the points.

    ``in_features`` is the point width D; the first layer takes D + 5.
    Preprocessing runs in the points' float32; the layers in ``dtype``. The
    output ``(…, V, features[-1])`` is in ``dtype``: ReLU times a 0/1 mask
    keeps values exact in it, so this equals the flax module's float32
    output cast to ``dtype``.
    """

    def __init__(
        self,
        in_features: int,
        features: Sequence[int] = (64,),
        voxel_size: Tuple[float, float] = (0.25, 0.25),
        point_range: Tuple[float, float] = (-50.0, -50.0),
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.voxel_size = tuple(voxel_size)
        self.point_range = tuple(point_range)
        widths = [in_features + 5, *features]
        self.linears = nn.ModuleList(
            nn.Linear(i, o, bias=False, **fk) for i, o in zip(widths[:-1], widths[1:])
        )
        self.norms = nn.ModuleList(LayerNorm(o, **fk) for o in features)

    def forward(self, voxels, num_points, coords):
        mask = _point_mask(voxels, num_points)
        mean = voxel_mean(voxels[..., :3], num_points)
        cluster_rel = voxels[..., :3] - mean[..., None, :]
        px = (coords[..., 0].to(voxels.dtype) + 0.5) * self.voxel_size[0] + self.point_range[0]
        py = (coords[..., 1].to(voxels.dtype) + 0.5) * self.voxel_size[1] + self.point_range[1]
        pillar_rel = torch.stack(
            [voxels[..., 0] - px[..., None], voxels[..., 1] - py[..., None]], dim=-1
        )
        x = torch.cat([voxels, cluster_rel, pillar_rel], dim=-1).to(self.linears[0].weight.dtype)
        m = mask[..., None].to(x.dtype)
        for linear, norm in zip(self.linears, self.norms):
            x = torch.relu(norm(linear(x))) * m
        return x.amax(dim=-2)


def pillar_scatter(features, coords, voxel_valid, grid_hw: Tuple[int, int],
                   assume_sorted: bool = False):
    """``(…, V, C)`` pillar features → ``(…, ny, nx, C)`` dense BEV canvas
    through :func:`~lyft3d_tpu_torch.ops.dense_fill.fill_rows_by_id` (the
    CUDA kernel on the card). ``assume_sorted`` holds for coords from
    ``voxelize`` with nz == 1 (ascending unique ids, invalid at the tail)."""
    ny, nx = grid_hw
    flat = coords[..., 1] * nx + coords[..., 0]
    canvas = fill_rows_by_id(features, flat, voxel_valid, ny * nx, assume_sorted=assume_sorted)
    return canvas.unflatten(-2, (ny, nx))
