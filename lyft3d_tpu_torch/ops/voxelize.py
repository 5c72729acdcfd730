"""Point-cloud voxelization with fixed capacities (port of
``lyft3d_tpu/ops/voxelize.py``).

Points ``(B, N, D≥3)`` (or ``(N, D)``) with a bool valid mask → voxels with
``max_voxels`` / ``max_points_per_voxel`` caps, batched over the leading
dimension where the JAX package ``vmap``s. The semantics are the JAX
package's:

- flat voxel ids in (y, x, z) order, ``(iy·nx + ix)·nz + iz``; the output
  slots hold them ascending and unique, with the invalid slots at the tail;
- when more than ``max_voxels`` voxels are occupied, the even-spread
  overflow policy keeps ranks ``k·s + min(k, rem)`` of the sorted ids, in
  closed form;
- each voxel keeps at most ``max_points_per_voxel`` of its points; padding
  rows are zero;
- ``need_point_voxel`` maps every point to its slot (−1 when dropped).

The sort is stable, so a voxel keeps its points in input order. The JAX
sort is unstable: which points an overflowing voxel keeps, and their order
inside a voxel, are not part of the contract. The TPU-specific payload
routing and compaction sort are not ported: on a GPU the compaction is one
scatter. ``block_filtering`` (ground removal, used by the sparse FHD
config) is :func:`block_filter_mask`: a scatter-min per block takes the place
of the JAX package's sort and segmented scan.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lyft3d_tpu_torch.utils.profiler import span

__all__ = ["VoxelGrid", "voxelize", "block_filter_mask"]


class VoxelGrid(NamedTuple):
    """Static voxelization spec (the JAX package's ``VoxelGrid``)."""

    point_cloud_range: Tuple[float, float, float, float, float, float]
    voxel_size: Tuple[float, float, float]
    block_filtering: bool = False
    block_factor: int = 1
    block_size: int = 8
    height_threshold: float = 0.2

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz)."""
        r = self.point_cloud_range
        return tuple(
            int(round((r[3 + i] - r[i]) / self.voxel_size[i])) for i in range(3)
        )


def block_filter_mask(points, valid, grid: VoxelGrid):
    """Ground-removal mask ``(…, N)``: true for valid points at least
    ``height_threshold`` above the lowest in-range valid point of their BEV
    block (``voxel_size·block_factor·block_size`` metres square). Points
    outside the x/y range take no part in a block's minimum and keep their
    validity (``voxelize`` drops them by range)."""
    r = grid.point_cloud_range
    dev = points.device
    bw = (
        grid.voxel_size[0] * grid.block_factor * grid.block_size,
        grid.voxel_size[1] * grid.block_factor * grid.block_size,
    )
    nbx = max(int(round((r[3] - r[0]) / bw[0])), 1)
    nby = max(int(round((r[4] - r[1]) / bw[1])), 1)
    # float32 arithmetic with tensor divisors, as in voxelize.
    lo = torch.tensor(r[:2], dtype=torch.float32, device=dev)
    hi = torch.tensor(r[3:5], dtype=torch.float32, device=dev)
    width = torch.tensor(bw, dtype=torch.float32, device=dev)
    xy = points[..., :2].float()
    z = points[..., 2].float()
    cell = torch.floor((xy - lo) / width)
    bx = torch.nan_to_num(cell[..., 0]).clamp(0, nbx - 1).long()
    by = torch.nan_to_num(cell[..., 1]).clamp(0, nby - 1).long()
    ok = valid & ((xy >= lo) & (xy < hi)).all(dim=-1)
    # Points that take no part go to a dump block past the grid.
    bid = torch.where(ok, by * nbx + bx, nbx * nby)
    zmin = z.new_full((*z.shape[:-1], nbx * nby + 1), float("inf"))
    zmin.scatter_reduce_(-1, bid, torch.where(ok, z, float("inf")), "amin")
    keep = z >= torch.gather(zmin, -1, bid) + grid.height_threshold
    return valid & (keep | ~ok)


def voxelize(
    points,
    valid,
    grid: VoxelGrid,
    max_voxels: int = 20000,
    max_points_per_voxel: int = 5,
    need_point_voxel: bool = False,
):
    """Bin ``(…, N, D≥3)`` padded points into fixed-capacity voxels.

    Returns a dict (each with the points' leading batch shape):
        voxels:      (…, max_voxels, max_points_per_voxel, D) points
        coords:      (…, max_voxels, 3) int32 (ix, iy, iz)
        num_points:  (…, max_voxels) int32 points per voxel (0 = empty slot)
        voxel_valid: (…, max_voxels) bool
        point_voxel: (…, N) int32 slot of each point or −1, only with
                     ``need_point_voxel``
    """
    with span("voxelize"):
        if grid.block_filtering:
            valid = block_filter_mask(points, valid, grid)
        batched = points.dim() == 3
        pts = points if batched else points[None]
        ok = valid if batched else valid[None]
        b, n, d = pts.shape
        dev = pts.device
        nx, ny, nz = grid.grid_size
        mv, mp = max_voxels, max_points_per_voxel

        # Same float32 arithmetic as the JAX version. The range and voxel size
        # are tensors on the points' device so that the division is a true IEEE
        # division there (PyTorch's CUDA division by a host scalar multiplies by
        # the reciprocal). Bounds are tested in the float domain, so NaN and huge
        # coordinates never reach an integer conversion.
        lo = torch.tensor(grid.point_cloud_range[:3], dtype=torch.float32, device=dev)
        vs = torch.tensor(grid.voxel_size, dtype=torch.float32, device=dev)
        dims = torch.tensor((nx, ny, nz), dtype=torch.float32, device=dev)
        f = torch.floor((pts[..., :3].float() - lo) / vs)  # (B, N, 3)
        inb = ((f >= 0) & (f < dims)).all(dim=-1) & ok
        idx = torch.where(inb[..., None], f, 0.0).to(torch.int64)
        big = nx * ny * nz
        flat = (idx[..., 1] * nx + idx[..., 0]) * nz + idx[..., 2]
        flat = torch.where(inb, flat, big)

        sorted_ids, order = torch.sort(flat, dim=-1, stable=True)
        arange_n = torch.arange(n, device=dev)
        is_head = torch.ones_like(sorted_ids, dtype=torch.bool)
        is_head[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
        in_grid = sorted_ids < big
        is_head &= in_grid
        rank = torch.cumsum(is_head, dim=-1) - 1  # voxel rank of each sorted point
        num_unique = is_head.sum(dim=-1, keepdim=True)
        total_valid = in_grid.sum(dim=-1, keepdim=True)

        # Even-spread overflow policy: with more than mv voxels, keep ranks
        # k·s + min(k, rem) — rem slots at pitch s+1, the rest at pitch s.
        overflow = num_unique > mv
        s = torch.clamp(num_unique // mv, min=1)
        rem = torch.clamp(num_unique - s * mv, min=0)
        in_dense = rank < rem * (s + 1)
        spread = torch.where(in_dense, rank % (s + 1) == 0, (rank - rem) % s == 0)
        kept = torch.where(overflow, spread, torch.ones_like(spread)) & (rank < num_unique)
        slot = torch.where(in_dense, rank // (s + 1), (rank - rem) // s)
        slot = torch.where(overflow, slot, rank)
        kept &= slot < mv

        # Points of each segment: from a head to the next head of any kind (a
        # dropped neighbour's points never count for a kept voxel).
        head_pos = torch.where(is_head, arange_n, n)
        next_head = torch.full_like(head_pos, n)
        next_head[:, :-1] = torch.flip(torch.cummin(torch.flip(head_pos, [1]), dim=1).values, [1])[:, 1:]
        cnt = torch.clamp(torch.minimum(next_head, total_valid) - arange_n, 0, mp)

        # Compaction: kept heads go to their slot (slots ascend with the ids);
        # everything else lands in a dump column that is cut off.
        chosen = is_head & kept
        target = torch.where(chosen, slot, mv)

        def compact(values, fill):
            out = torch.full((b, mv + 1), fill, dtype=values.dtype, device=dev)
            return out.scatter_(1, target, values)[:, :mv]

        voxel_ids = compact(sorted_ids, big)
        voxel_valid = voxel_ids < big
        starts = compact(arange_n.expand(b, n), n)
        num_points = torch.where(voxel_valid, compact(cnt, 0), 0)

        # Each voxel's points are the rows [start, start + num_points) of the
        # sorted cloud.
        seg = torch.arange(mp, device=dev)
        take = seg < num_points[..., None]  # (B, mv, mp)
        rows = torch.clamp(starts[..., None] + seg, max=n - 1)
        src = torch.gather(order, 1, rows.reshape(b, -1))  # original point index
        voxels = torch.gather(pts, 1, src[..., None].expand(b, mv * mp, d)).reshape(b, mv, mp, d)
        voxels = torch.where(take[..., None], voxels, torch.zeros((), dtype=pts.dtype, device=dev))

        zero = torch.zeros((), dtype=voxel_ids.dtype, device=dev)
        coords = torch.stack(
            [
                torch.where(voxel_valid, (voxel_ids // nz) % nx, zero),
                torch.where(voxel_valid, voxel_ids // (nz * nx), zero),
                torch.where(voxel_valid, voxel_ids % nz, zero),
            ],
            dim=-1,
        ).to(torch.int32)

        out = {
            "voxels": voxels,
            "coords": coords,
            "num_points": num_points.to(torch.int32),
            "voxel_valid": voxel_valid,
        }
        if need_point_voxel:
            slot_sorted = torch.where(in_grid & kept, slot, -1)
            out["point_voxel"] = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted).to(torch.int32)
        if not batched:
            out = {k: v[0] for k, v in out.items()}
        return out
