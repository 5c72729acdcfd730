"""Sparse middle feature extractors (port of
``lyft3d_tpu/models/second/middle.py``): stacks of submanifold 3³ convs and
strided (k3 s2 p1) sparse convs over a voxel set, flattened at the end to a
dense BEV map ``(B, ny, nx, nz·C)``.

- :class:`SparseMiddleUnits` (config ``middle: sparse_units``) works on
  z-slab units of BEV columns (:mod:`lyft3d_tpu_torch.ops.column_sparse`);
  every conv is one launch of the stencil kernel ``csrc/stencil_conv.cu``.
- :class:`SparseMiddleColumns` (config ``middle: sparse_columns``) works on
  whole BEV columns with a dense z axis; every conv is one launch of the same
  stencil kernel over 1 to 5 chunks of the z axis, and each strided layer
  has a second launch on its 1-channel activity mask. Its caps bound
  columns, not units, so where a cap fills it keeps other voxels than the
  unit middle.
- :class:`SparseMiddle` (config ``middle: sparse``) is the per-voxel
  formulation (:mod:`lyft3d_tpu_torch.ops.sparse_conv`): its submanifold
  convs run the rank gather kernel ``csrc/subm_conv.cu``, its strided convs
  a gather and an einsum, as in the JAX package.

All take batched inputs (``(B, V, C)`` features and a batched
``ActiveSet``) and agree at active sites where no capacity cap truncates.

The flax modules infer their input width; here it is an explicit first
argument. Kernels are ``(27, Cin, Cout)`` as in flax, held in the module's
dtype. ``norm_type`` of the unit and column middles: "layer" (LayerNorm with flax's
statistics), "batch" (flax's BatchNorm over the ``(B, V, C)`` output: its
statistics in train mode run over every row, inactive and padded ones
included, as the flax layer's do; eval mode uses the running statistics) or
"folded" (conv + bias, no norm op: the inference structure). ReLU and the
activity mask come after the norm in all three.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from lyft3d_tpu_torch.models.layers import BatchNorm, LayerNorm
from lyft3d_tpu_torch.ops.column_sparse import (
    ColumnSet,
    columns_from_voxels,
    columns_to_dense_bev,
    downsample_columns,
    downsample_units,
    strided_conv_columns_batched,
    strided_conv_units_batched,
    subm_conv_columns_batched,
    subm_conv_units_batched,
    units_from_voxels,
    units_to_dense_bev,
)
from lyft3d_tpu_torch.ops.dense_fill import fill_rows_by_id
from lyft3d_tpu_torch.ops.sparse_conv import (
    ActiveSet,
    build_hash,
    downsample_coords,
    kernel_offsets,
    sparse_conv3d_gather,
    subm_neighbors,
    take_rows,
)
from lyft3d_tpu_torch.ops.subm_conv_kernel import subm_conv

__all__ = [
    "SubMConvLayer",
    "SparseConvLayer",
    "sparse_to_dense_bev",
    "SparseMiddle",
    "SubMUnitLayer",
    "StridedUnitLayer",
    "SparseMiddleUnits",
    "SubMColumnLayer",
    "StridedColumnLayer",
    "SparseMiddleColumns",
]

NORM_TYPES = ("layer", "batch", "folded")


class _SparseConvBase(nn.Module):
    """A ``(27, Cin, Cout)`` kernel with its norm: LayerNorm ("layer"),
    BatchNorm over the channels ("batch") or a bias ("folded"). Each layer's
    ``conv`` is its convolution alone, ``(…, C)`` rows in and ``(…, Cout)``
    out (a strided layer's also its output activity), before ``norm_act``:
    what ``parallel/tensor.py`` shards on ``Cout``, the kernel's dim
    ``kernel_out_dim`` (flax's output axis)."""

    kernel_out_dim = 2

    def __init__(self, in_features: int, features: int, norm_type: str, device=None, dtype=None):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"unknown norm_type {norm_type!r}")
        fk = {"device": device, "dtype": dtype}
        self.kernel = nn.Parameter(torch.empty(27, in_features, features, **fk))
        self.norm = None
        if norm_type == "layer":
            self.norm = LayerNorm(features, **fk)
        elif norm_type == "batch":
            self.norm = BatchNorm(features, channel_dim=-1, **fk)
        self.bias = nn.Parameter(torch.empty(features, **fk)) if norm_type == "folded" else None

    def init_own_params(self, normal):
        """He-normal kernel (fan-in 27·Cin), zero bias; called by ``init_params``."""
        normal(self.kernel, math.sqrt(2.0 / (27 * self.kernel.shape[1])))
        if self.bias is not None:
            self.bias.zero_()

    def norm_act(self, out, mask):
        """Cast to the module's dtype, norm or bias, ReLU, zero the inactive."""
        out = out.to(self.kernel.dtype)
        out = self.norm(out) if self.norm is not None else out + self.bias
        return torch.relu(out) * mask[..., None].to(out.dtype)


# ---------------------------------------------------------------- per voxel


class SubMConvLayer(_SparseConvBase):
    """Submanifold sparse conv + LayerNorm + ReLU on the per-voxel set, through
    :func:`~lyft3d_tpu_torch.ops.subm_conv_kernel.subm_conv` (the CUDA kernel
    on the card)."""

    def __init__(self, in_features: int, features: int, device=None, dtype=None):
        super().__init__(in_features, features, "layer", device, dtype)

    def conv(self, features, hash_, neighbors):
        # Ranks index the sorted order; their V axis is the active list's, so
        # the output needs no un-permute.
        f_sorted = take_rows(features, hash_[1]).to(self.kernel.dtype)
        return subm_conv(f_sorted, neighbors, self.kernel)

    def forward(self, features, active: ActiveSet, hash_, neighbors=None):
        if neighbors is None:
            neighbors = subm_neighbors(active, hash_, kernel_offsets(3, features.device))
        return self.norm_act(self.conv(features, hash_, neighbors), active.valid)


class SparseConvLayer(_SparseConvBase):
    """Strided sparse conv producing a new (downsampled) active set: a gather
    and an einsum, as in the JAX package."""

    def __init__(self, in_features: int, features: int, max_out: int,
                 stride: Tuple[int, int, int] = (2, 2, 2),
                 padding: Tuple[int, int, int] = (1, 1, 1), device=None, dtype=None):
        super().__init__(in_features, features, "layer", device, dtype)
        self.max_out = max_out
        self.stride = tuple(stride)
        self.padding = tuple(padding)

    def conv(self, features, active: ActiveSet, out_active: ActiveSet):
        gathered = sparse_conv3d_gather(features, active, out_active, 3, self.stride, self.padding)
        return torch.einsum("...kvc,kcd->...vd", gathered.to(self.kernel.dtype), self.kernel)

    def forward(self, features, active: ActiveSet):
        out_active = downsample_coords(active, self.max_out, 3, self.stride, self.padding)
        return self.norm_act(self.conv(features, active, out_active), out_active.valid), out_active


def sparse_to_dense_bev(features, active: ActiveSet):
    """``(…, V, C)`` features at ``(…, V, 3)`` coords → ``(…, ny, nx, nz·C)`` BEV
    map through :func:`~lyft3d_tpu_torch.ops.dense_fill.fill_rows_by_id`;
    ``downsample_coords`` emits ascending unique flat ids, so no sort."""
    nx, ny, nz = active.spatial_shape
    c = features.shape[-1]
    x, y, z = (active.coords[..., i].long() for i in range(3))
    dense = fill_rows_by_id(features, (z * ny + y) * nx + x, active.valid, nz * ny * nx,
                            assume_sorted=True)
    dense = dense.unflatten(-2, (nz, ny, nx))  # (…, nz, ny, nx, c)
    return dense.movedim(-4, -2).flatten(-2)


class SparseMiddle(nn.Module):
    """Per stage ``subm_per_stage`` submanifold convs, then one strided
    downsample; at the end the dense BEV flatten. One stencil match per stage
    is shared by its submanifold layers."""

    def __init__(self, in_features: int, stage_features: Sequence[int] = (16, 32, 64),
                 stage_max_voxels: Sequence[int] = (8192, 4096, 2048), subm_per_stage: int = 2,
                 strides: Sequence[Tuple[int, int, int]] = ((2, 2, 2), (2, 2, 2), (2, 2, 2)),
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.subm_per_stage = subm_per_stage
        subm, strided, cin = [], [], in_features
        for f, mo, st in zip(stage_features, stage_max_voxels, strides):
            for _ in range(subm_per_stage):
                subm.append(SubMConvLayer(cin, f, **fk))
                cin = f
            strided.append(SparseConvLayer(f, f, max_out=mo, stride=st, **fk))
        self.subm = nn.ModuleList(subm)  # flax: SubMConvLayer_i
        self.strided = nn.ModuleList(strided)  # flax: SparseConvLayer_i

    def stage(self, i: int, x, active: ActiveSet):
        hash_ = build_hash(active)
        neighbors = subm_neighbors(active, hash_, kernel_offsets(3, x.device))
        for layer in self.subm[i * self.subm_per_stage:(i + 1) * self.subm_per_stage]:
            x = layer(x, active, hash_, neighbors=neighbors)
        return self.strided[i](x, active)

    def forward(self, features, active: ActiveSet):
        x = features.to(self.subm[0].kernel.dtype)
        for i in range(len(self.strided)):
            x, active = self.stage(i, x, active)
        return sparse_to_dense_bev(x, active), active


# -------------------------------------------------------------- z-slab units


class SubMUnitLayer(_SparseConvBase):
    """Submanifold conv + norm + ReLU over z-slab units."""

    def __init__(self, in_features: int, features: int, ncs: int, norm_type: str = "layer",
                 device=None, dtype=None):
        super().__init__(in_features, features, norm_type, device, dtype)
        self.ncs = ncs

    def conv(self, colf, cols: ColumnSet):
        return subm_conv_units_batched(colf.to(self.kernel.dtype), cols, self.kernel, self.ncs)

    def forward(self, colf, cols: ColumnSet):
        return self.norm_act(self.conv(colf, cols), cols.mask)


class StridedUnitLayer(_SparseConvBase):
    """Strided (k3 s2 p1) sparse conv over z-slab units → a new unit set with
    half the slab size."""

    def __init__(self, in_features: int, features: int, ncs: int, max_out: int,
                 norm_type: str = "layer", device=None, dtype=None):
        super().__init__(in_features, features, norm_type, device, dtype)
        self.ncs = ncs
        self.max_out = max_out

    def conv(self, colf, cols: ColumnSet, out_cols: ColumnSet):
        """``(out, output activity)``: the activity rides as one more channel
        of the stencil pass, whatever slice of the kernel it runs on."""
        return strided_conv_units_batched(colf.to(self.kernel.dtype), cols, out_cols, self.kernel, self.ncs)

    def forward(self, colf, cols: ColumnSet):
        out_cols = downsample_units(cols, self.ncs, self.max_out)
        out, omask = self.conv(colf, cols, out_cols)
        out_cols = out_cols.replace(mask=omask)
        return self.norm_act(out, omask), out_cols


class SparseMiddleUnits(nn.Module):
    """The sparse stack over z-slab units: only active slabs of each BEV
    column are stored and convolved. ``z_slab`` is the stage-0 slab size and
    must be divisible by ``2**(stages − 1)`` so that slabs halve with each
    strided layer; the caps bound units per stage."""

    def __init__(self, in_features: int, stage_features: Sequence[int] = (16, 32, 64),
                 stage_max_voxels: Sequence[int] = (8192, 4096, 2048), subm_per_stage: int = 2,
                 z_slab: int = 8, norm_type: str = "layer", assume_sorted_voxels: bool = False,
                 nz: int = 40, device=None, dtype=None):
        super().__init__()
        nstages = len(stage_features)
        assert z_slab % (2 ** (nstages - 1)) == 0, (
            f"z_slab {z_slab} must halve across {nstages - 1} strided stages"
        )
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.subm_per_stage = subm_per_stage
        self.z_slab = z_slab
        self.assume_sorted_voxels = assume_sorted_voxels
        self.nz = nz
        self.ncs = -(-nz // z_slab)
        subm, strided, cin = [], [], in_features
        for f, mo in zip(stage_features, stage_max_voxels):
            for _ in range(subm_per_stage):
                subm.append(SubMUnitLayer(cin, f, self.ncs, **fk))
                cin = f
            strided.append(StridedUnitLayer(f, f, self.ncs, max_out=mo, **fk))
        self.subm = nn.ModuleList(subm)  # flax: SubMUnitLayer_i
        self.strided = nn.ModuleList(strided)  # flax: StridedUnitLayer_i

    def to_units(self, features, active: ActiveSet):
        assert active.spatial_shape[2] == self.nz, (active.spatial_shape, self.nz)
        return units_from_voxels(features.to(self.subm[0].kernel.dtype), active, self.z_slab,
                                 self.assume_sorted_voxels)

    def stage(self, i: int, x, cols: ColumnSet):
        for layer in self.subm[i * self.subm_per_stage:(i + 1) * self.subm_per_stage]:
            x = layer(x, cols)
        return self.strided[i](x, cols)

    def to_dense(self, x, cols: ColumnSet):
        nz = self.nz
        for _ in self.strided:
            nz = (nz + 2 - 3) // 2 + 1
        return units_to_dense_bev(x, cols, self.ncs, nz)

    def forward(self, features, active: ActiveSet):
        cols, x = self.to_units(features, active)
        for i in range(len(self.strided)):
            x, cols = self.stage(i, x, cols)
        return self.to_dense(x, cols), cols


# ------------------------------------------------------------- dense-z columns


class SubMColumnLayer(_SparseConvBase):
    """Submanifold conv + norm + ReLU over dense-z BEV columns."""

    def conv(self, colf, cols: ColumnSet):
        return subm_conv_columns_batched(colf.to(self.kernel.dtype), cols, self.kernel)

    def forward(self, colf, cols: ColumnSet):
        return self.norm_act(self.conv(colf, cols), cols.mask)


class StridedColumnLayer(_SparseConvBase):
    """Strided (k3 s2 p1) sparse conv over columns → a new column set of half
    the extent in x, y and z, at most ``max_out`` columns."""

    def __init__(self, in_features: int, features: int, max_out: int, norm_type: str = "layer",
                 device=None, dtype=None):
        super().__init__(in_features, features, norm_type, device, dtype)
        self.max_out = max_out

    def conv(self, colf, cols: ColumnSet, out_cols: ColumnSet):
        """``(out, output activity)``; the activity comes from a stencil pass of
        its own over the input's mask, whatever slice of the kernel runs."""
        return strided_conv_columns_batched(colf.to(self.kernel.dtype), cols, out_cols, self.kernel)

    def forward(self, colf, cols: ColumnSet):
        out_cols = downsample_columns(cols, self.max_out)
        out, omask = self.conv(colf, cols, out_cols)
        out_cols = out_cols.replace(mask=omask)
        return self.norm_act(out, omask), out_cols


class SparseMiddleColumns(nn.Module):
    """The sparse stack over dense-z BEV columns: each column carries all its
    z cells, so a layer's work scales with nz rather than with occupancy. The
    caps bound columns per stage (columns ≤ voxels)."""

    def __init__(self, in_features: int, stage_features: Sequence[int] = (16, 32, 64),
                 stage_max_voxels: Sequence[int] = (8192, 4096, 2048), subm_per_stage: int = 2,
                 norm_type: str = "layer", assume_sorted_voxels: bool = False, device=None, dtype=None):
        super().__init__()
        fk = {"norm_type": norm_type, "device": device, "dtype": dtype}
        self.subm_per_stage = subm_per_stage
        self.assume_sorted_voxels = assume_sorted_voxels
        subm, strided, cin = [], [], in_features
        for f, mo in zip(stage_features, stage_max_voxels):
            for _ in range(subm_per_stage):
                subm.append(SubMColumnLayer(cin, f, **fk))
                cin = f
            strided.append(StridedColumnLayer(f, f, max_out=mo, **fk))
        self.subm = nn.ModuleList(subm)  # flax: SubMColumnLayer_i
        self.strided = nn.ModuleList(strided)  # flax: StridedColumnLayer_i

    def to_columns(self, features, active: ActiveSet):
        return columns_from_voxels(features.to(self.subm[0].kernel.dtype), active, self.assume_sorted_voxels)

    def stage(self, i: int, x, cols: ColumnSet):
        for layer in self.subm[i * self.subm_per_stage:(i + 1) * self.subm_per_stage]:
            x = layer(x, cols)
        return self.strided[i](x, cols)

    def to_dense(self, x, cols: ColumnSet):
        return columns_to_dense_bev(x, cols)

    def forward(self, features, active: ActiveSet):
        cols, x = self.to_columns(features, active)
        for i in range(len(self.strided)):
            x, cols = self.stage(i, x, cols)
        return self.to_dense(x, cols), cols
