"""Sparse 3D convolution over z-slab units of BEV columns (port of the unit
subset of ``lyft3d_tpu/ops/column_sparse.py``).

A **unit** is one fixed z-slab of a BEV column: id
``(y·nx + x)·NC + slab`` with ``NC = ceil(nz / z_slab)``; only active units
(and the empty *ghost* units that carry z halos across slab boundaries) are
stored, ``z_slab`` cells each, in a fixed-capacity :class:`ColumnSet` over the
virtual BEV grid ``(nx·NC, ny)``. A 3³ conv is then a 9-offset BEV stencil
whose z taps are folded into banded weights
(:func:`stencil_conv_batched`, CUDA kernel ``csrc/stencil_conv.cu``).

Every function takes one sample or a batch: leading dimensions are carried
where the JAX package ``vmap``s. Capacities, the even-spread overflow
policies and the ghost rules are the JAX package's integer arithmetic,
literally, because they decide which units survive. Not ported: the dense-z
column functions (kept in the JAX package for comparison) and the TPU
kernel's window machinery with its ``t_tile``/``w_win`` knobs.

The gradient of the stencil (:class:`StencilConv`) has two sides. ``d_src`` is
the stencil kernel itself, launched a second time on the cotangent rows with
the reverse queries ``rev_qids``/``rev_src_ids`` (for each source row and
offset, the id of the query that reads it: index arithmetic in
:func:`subm_conv_units_batched` and :func:`strided_conv_units_batched`) and
transposed band weights, as in the JAX package. ``d_wc`` is
the weight-gradient kernel of the same source file. bfloat16 tensors take the
tensor-core kernels (``mma.sync``), float32 tensors the float32 FMA kernels;
the host side of the former (padding, tile choice, the plain versions of the
small preparation kernels) is :func:`stencil_mma_variant` and its neighbours.
On a CPU tensor the plain versions run: :func:`stencil_conv_ref` on the reverse
queries, and :func:`stencil_conv_bwd_ref` (the plain forward differentiated by
autograd). Everything around the kernel (masks, halos, band weights, the fill)
is plain autograd.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops._wgrad import wgrad_buffers, wgrad_mma_variant
from lyft3d_tpu_torch.ops.dense_fill import fill_rows_by_id
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet, take_rows

__all__ = [
    "ColumnSet",
    "units_from_voxels",
    "unit_qids_subm",
    "subm_conv_units_batched",
    "downsample_units",
    "strided_conv_units_batched",
    "columns_to_dense_bev",
    "units_to_dense_bev",
    "stencil_conv_batched",
    "stencil_conv_ref",
    "stencil_conv_bwd_ref",
    "StencilConv",
    "rev_qids_strided",
    "stencil_mma_variant",
    "wgrad_mma_variant",
    "wgrad_buffers",
    "bf16_split",
    "stencil_weight_prep_ref",
    "stencil_rows_prep_ref",
    "stencil_positions_ref",
    "stencil_conv_mma_ref",
    "PAD_ID",
    "KERNEL_LAUNCHES",
    "DGRAD_KERNEL_LAUNCHES",
    "WGRAD_KERNEL_LAUNCHES",
]

# Number of times stencil_conv_batched launched the CUDA kernel in this process.
KERNEL_LAUNCHES = 0
# Number of times its backward launched the stencil kernel on the reverse
# queries (d_src) and the weight-gradient kernel (d_wc).
DGRAD_KERNEL_LAUNCHES = 0
WGRAD_KERNEL_LAUNCHES = 0

# Larger than any unit id (nx·ny·NC ≤ 2^25 at the FHD geometry).
PAD_ID = 2 ** 28

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

@dataclass(frozen=True)
class ColumnSet:
    """Fixed-capacity set of active BEV columns (or units over the virtual
    grid) with their dense-z activity masks."""

    col_ids: torch.Tensor  # (…, Vc) int32 flat ids y·nx + x, ascending; invalid
    #                        entries carry nx·ny at the tail
    valid: torch.Tensor  # (…, Vc) bool
    mask: torch.Tensor  # (…, Vc, nz) bool: active cells of each column
    bev_shape: Tuple[int, int]  # (nx, ny)
    nz: int

    @property
    def coords(self):
        """``(…, Vc, 2)`` int64 (x, y); undefined on invalid rows."""
        nx, _ = self.bev_shape
        ids = self.col_ids.long()
        return torch.stack([ids % nx, ids // nx], dim=-1)

    def replace(self, **changes) -> "ColumnSet":
        return dataclasses.replace(self, **changes)


def _bev_offsets2d(device=None):
    """``(9, 2)`` (dx, dy) in ``kernel_offsets(3)``'s outer order: the 3D offset
    (dx, dy, dz) is tap ``((dx+1)·3 + (dy+1))·3 + (dz+1)``, so a (27, C, C')
    weight reshaped (9, 3, C, C') pairs row j with the j-th offset here."""
    r = (-1, 0, 1)
    return torch.tensor(list(itertools.product(r, r)), dtype=torch.int64, device=device)


def _banded_weight(wj, nz_out: int, nz_pad: int, stride: int):
    """``(…, 3, C, Cout)`` z taps → ``(…, nz_pad·C, nz_out·Cout)`` block-banded
    matrix: output cell ``oz`` reads padded input row ``stride·oz + dz``."""
    cin, cout = wj.shape[-2:]
    iz = torch.arange(nz_pad, device=wj.device)[None, :, None]
    oz = torch.arange(nz_out, device=wj.device)[None, None, :]
    dz = torch.arange(3, device=wj.device)[:, None, None]
    sel = (iz == stride * oz + dz).to(wj.dtype)  # (3, nz_pad, nz_out)
    wb = torch.einsum("dio,...dce->...icoe", sel, wj)
    return wb.reshape(*wj.shape[:-3], nz_pad * cin, nz_out * cout)


def _unit_nc(nz: int, z_slab: int) -> int:
    return -(-nz // z_slab)


def _even_select(sorted_vals, num_unique, cap: int):
    """Positions ``(…, cap)`` of an evenly rank-spaced selection from the
    ``num_unique (…, 1)`` ascending entries at the front of ``sorted_vals``:
    the identity when they fit, else ``k·stride + min(k, rem)``."""
    k = torch.arange(cap, dtype=torch.int64, device=sorted_vals.device)
    stride = torch.clamp(num_unique // cap, min=1)
    rem = torch.clamp(num_unique - stride * cap, min=0)
    return torch.where(num_unique > cap, k * stride + torch.minimum(k, rem), k)


def _shift_right(x, fill):
    """``x`` moved one place towards the tail of its last dim."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def _shift_left(x, fill):
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], dim=-1)


def _scatter_dropping(length: int, fill, index, values):
    """``full(length, fill).at[index].set(values)`` along the last dim where an
    index of ``length`` means "drop": a buffer one longer, cut at the end."""
    out = values.new_full((*index.shape[:-1], length + 1), fill)
    return out.scatter_(-1, index, values)[..., :length]


def _ghost_emits(ids, need_lo, need_hi, big: int):
    """Which ghosts ``id−1`` / ``id+1`` an ascending id list really has to add:
    ``id−1`` is already there when the previous entry is ``id−1`` or emits it
    as its own ``+1`` ghost; ``id+1`` when the next entry is ``id+1``."""
    prev_ids = _shift_right(ids, big)
    next_ids = _shift_left(ids, big)
    prev_hi = _shift_right(need_hi, False)
    emit_lo = need_lo & ~((prev_ids == ids - 1) | ((prev_ids == ids - 2) & prev_hi))
    emit_hi = need_hi & ~(next_ids == ids + 1)
    return emit_lo, emit_hi


def _insert_ghosts(unit_ids, unit_valid, first_occ, last_occ, ncs: int, bigu: int, unit_cap: int):
    """Merge ascending unique unit ids with their ghost ids into ``unit_cap``
    rows. A unit whose first cell is active needs the (empty) unit one slab
    below to exist, one whose last cell is active the unit above: a
    cross-column read reaches a neighbour's boundary cells through that
    unit's halo rows. Returns ``(final_ids, final_valid, out_pos)``;
    ``out_pos[i]`` is the output row of input unit ``i`` (``unit_cap`` when
    the cap dropped it)."""
    v = unit_ids.shape[-1]
    dev = unit_ids.device
    slab = unit_ids % ncs
    need_lo = unit_valid & first_occ & (slab != 0)
    need_hi = unit_valid & last_occ & (slab != ncs - 1)
    emit_lo, emit_hi = _ghost_emits(unit_ids, need_lo, need_hi, bigu)
    cnt = torch.where(unit_valid, 1 + emit_lo.long() + emit_hi.long(), 0)
    pos = torch.cumsum(cnt, dim=-1) - cnt  # rank of each unit's first entry
    total = pos[..., -1:] + cnt[..., -1:]
    buf_len = max(3 * v, unit_cap)
    dest_real = torch.where(unit_valid, pos + emit_lo.long(), buf_len)
    dest_lo = torch.where(emit_lo, pos, buf_len)
    dest_hi = torch.where(emit_hi, pos + 1 + emit_lo.long(), buf_len)
    buf = unit_ids.new_full((*unit_ids.shape[:-1], buf_len + 1), bigu)
    buf.scatter_(-1, dest_real, unit_ids).scatter_(-1, dest_lo, unit_ids - 1)
    buf = buf.scatter_(-1, dest_hi, unit_ids + 1)[..., :buf_len]
    sel = _even_select(buf, total, unit_cap).expand(*unit_ids.shape[:-1], unit_cap)
    final_ids = torch.gather(buf, -1, sel)
    final_valid = final_ids < bigu
    inv_sel = sel.new_full((*unit_ids.shape[:-1], buf_len + 1), unit_cap)
    inv_sel.scatter_(-1, sel, torch.arange(unit_cap, device=dev).expand(sel.shape))
    out_pos = torch.gather(inv_sel, -1, dest_real)
    return final_ids, final_valid, out_pos


def units_from_voxels(features, active: ActiveSet, z_slab: int, assume_sorted: bool = False,
                      unit_cap: Optional[int] = None):
    """``(…, V, C)`` voxel features + 3D active set → (unit :class:`ColumnSet`
    over the ``(nx·NC, ny)`` virtual grid, ``(…, unit_cap, z_slab, C)`` unit
    features), ghost units included. ``assume_sorted``: the active set is in
    (bev id, z) order with invalid entries at the tail, as ``voxelize`` emits
    it. ``unit_cap`` defaults to ``V + V // 4``. The placement goes through
    :func:`~lyft3d_tpu_torch.ops.dense_fill.fill_rows_by_id`, with a ones
    channel that becomes the occupancy mask."""
    nx, ny, nz = active.spatial_shape
    ncs = _unit_nc(nz, z_slab)
    v, c = features.shape[-2:]
    if unit_cap is None:
        unit_cap = v + v // 4
    big2 = nx * ny
    bigu = big2 * ncs
    assert big2 * nz < 2 ** 30 and bigu < PAD_ID, (nx, ny, nz, ncs)
    x, y, z = (active.coords[..., i].long() for i in range(3))
    key = torch.where(active.valid, (y * nx + x) * nz + z, big2 * nz)
    if assume_sorted:
        skey, f_s = key, features
    else:
        skey, perm = torch.sort(key, dim=-1, stable=True)
        f_s = take_rows(features, perm)
    valid_s = skey < big2 * nz
    z_s = skey % nz
    uid_s = torch.where(valid_s, (skey // nz) * ncs + z_s // z_slab, bigu)
    zl_s = z_s - (z_s // z_slab) * z_slab
    head = (_shift_right(uid_s, -1) != uid_s) & valid_s
    urank = torch.cumsum(head, dim=-1) - 1
    target = torch.where(head, urank, v)
    unit_ids = _scatter_dropping(v, bigu, target, uid_s)
    unit_valid = unit_ids < bigu
    # Boundary occupancy for the ghost rule: within a unit the sorted z's
    # ascend, so the head voxel holds the smallest local z and the tail voxel
    # (the next row's id differs; padding rows park at bigu) the largest.
    tail = (_shift_left(uid_s, -1) != uid_s) & valid_s
    target_t = torch.where(tail, urank, v)
    first_occ = _scatter_dropping(v, False, target, zl_s == 0)
    last_occ = _scatter_dropping(v, False, target_t, zl_s == z_slab - 1)
    final_ids, final_valid, out_pos = _insert_ghosts(
        unit_ids, unit_valid, first_occ, last_occ, ncs, bigu, unit_cap
    )
    # Each sorted voxel lands in one (output unit row, local z) cell. Voxels of
    # a unit the cap dropped carry the sentinel between ascending ids, so the
    # fill sorts its ids (the kernel's window search needs them ascending).
    row = torch.gather(out_pos, -1, urank.clamp(0, v - 1))
    place_ok = valid_s & (row < unit_cap)
    canvas = unit_cap * z_slab
    dest = torch.where(place_ok, row * z_slab + zl_s, canvas)
    f_aug = torch.cat([f_s, torch.ones_like(f_s[..., :1])], dim=-1)
    filled = fill_rows_by_id(f_aug, dest, place_ok, canvas, assume_sorted=False)
    f_out = filled[..., :c].unflatten(-2, (unit_cap, z_slab))
    m_out = (filled[..., c] > 0).unflatten(-1, (unit_cap, z_slab))
    cols = ColumnSet(col_ids=final_ids.to(torch.int32), valid=final_valid, mask=m_out,
                     bev_shape=(nx * ncs, ny), nz=z_slab)
    return cols, f_out


def _unit_halo_rows(fm, ids, valid, ncs: int, bottom: bool):
    """``(…, Vu, zs, C)`` masked unit features → ``(…, Vu, zs + 1 + bottom, C)``
    with the z halo prepended (and appended when ``bottom``). Ids are
    ascending unique, so the slab below is the previous row iff its id is one
    less and this slab is not the column's first."""
    ids = ids.long()
    zero = torch.zeros_like(fm[..., :1, :1, :])
    below = torch.cat([zero, fm[..., :-1, -1:, :]], dim=-3)
    ok_b = (_shift_right(ids, -2) == ids - 1) & (ids % ncs != 0) & valid
    rows = [below * ok_b[..., None, None].to(fm.dtype), fm]
    if bottom:
        above = torch.cat([fm[..., 1:, :1, :], zero], dim=-3)
        ok_a = (_shift_left(ids, -2) == ids + 1) & (ids % ncs != ncs - 1) & valid
        rows.append(above * ok_a[..., None, None].to(fm.dtype))
    return torch.cat(rows, dim=-2)


def _lane_pad(kz: int) -> int:
    return -(-kz // 128) * 128


def _unit_rows_padded(fm, ids, valid, ncs: int, bottom: bool):
    """Halo'd unit rows flattened and zero-padded to a multiple of 128 lanes,
    the row layout the JAX package's band weights are built for: ``(…, Vu,
    kzp)`` with ``kz = (zs + 1 + bottom)·C``."""
    rows = _unit_halo_rows(fm, ids, valid, ncs, bottom).flatten(-2)
    return F.pad(rows, (0, _lane_pad(rows.shape[-1]) - rows.shape[-1]))


def _unit_band_weights(w, zs_out: int, kzrows: int, stride: int, kzp: int):
    """``(27, C, Cout)`` → ``(9, kzp, zs_out·Cout)`` band weights; row 0 of the
    halo'd unit rows is local z −1."""
    cin, cout = w.shape[1], w.shape[2]
    wb = _banded_weight(w.reshape(9, 3, cin, cout), zs_out, kzrows, stride)
    return F.pad(wb, (0, 0, 0, kzp - wb.shape[1]))


def _in_grid_ids(valid, qx, qy, nx: int, ny: int, ids):
    inb = valid[..., None, :] & (qx >= 0) & (qx < nx) & (qy >= 0) & (qy < ny)
    return torch.where(inb, ids, -1).to(torch.int32)


def unit_qids_subm(cols: ColumnSet, ncs: int):
    """``(…, 9, Vu)`` int32 submanifold neighbour ids: the constant virtual-grid
    shift ``(dy·nx + dx)·NC`` per BEV offset; −1 where absent."""
    nxv, ny = cols.bev_shape
    offs = _bev_offsets2d(cols.col_ids.device)
    coords = cols.coords
    qx = coords[..., None, :, 0] + offs[:, None, 0] * ncs
    qy = coords[..., None, :, 1] + offs[:, None, 1]
    return _in_grid_ids(cols.valid, qx, qy, nxv, ny, qy * nxv + qx)


def subm_conv_units_batched(colf, cols: ColumnSet, w, ncs: int):
    """Submanifold 3³ conv over z-slab units. ``colf`` ``(…, Vu, zs, C)``, ``w``
    ``(27, C, Cout)`` → ``(…, Vu, zs, Cout)`` float32, to be masked and
    normalised by the caller."""
    zs, cin = colf.shape[-2:]
    cout = w.shape[-1]
    fm = colf * cols.mask[..., None].to(colf.dtype)
    src = _unit_rows_padded(fm, cols.col_ids, cols.valid, ncs, bottom=True)
    wc = _unit_band_weights(w, zs, zs + 2, 1, _lane_pad((zs + 2) * cin))
    qids = unit_qids_subm(cols, ncs)
    # The nine BEV offsets are symmetric under j ↦ 8 − j: the query that reads
    # row v at offset j is v's own neighbour at the opposite offset.
    out = stencil_conv_batched(src, qids, cols.col_ids, wc, 1,
                               rev_qids=qids.flip(-2), rev_src_ids=cols.col_ids)
    return out.unflatten(-1, (zs, cout))


def downsample_units(cols: ColumnSet, ncs: int, max_out: int) -> ColumnSet:
    """Output unit set of a k=3 s=2 p=1 strided conv over z-slab units, its
    cell mask left empty (``strided_conv_units_batched`` fills it).

    Candidates per input unit: its ≤ 4 BEV parent columns at its own slab;
    the slab above when any of its last 3 cells is active (activity spills
    into output slab c+1, or makes the last output cell active, which needs
    the unit above as a halo carrier), the slab below when any of its first
    2 cells is. Output slabs are half as tall; NC stays. More parents than
    ``max(2·max_out, 3·Vu)`` lose every ``d``-th rank, more outputs than
    ``max_out`` are spread evenly (:func:`_even_select`)."""
    nxv, ny = cols.bev_shape
    nx = nxv // ncs
    onx = (nx + 2 - 3) // 2 + 1
    ony = (ny + 2 - 3) // 2 + 1
    zso = max(1, cols.nz // 2)
    obig = onx * ony * ncs
    dev = cols.col_ids.device
    lead = cols.col_ids.shape[:-1]
    vu = cols.col_ids.shape[-1]
    coords = cols.coords
    x = coords[..., 0] // ncs
    slab = coords[..., 0] - x * ncs
    num = torch.stack([x, coords[..., 1]], dim=-1) + 1  # + padding
    o_hi = num // 2
    o_lo = -((-(num - 2)) // 2)
    up = cols.mask[..., -3:].any(dim=-1) & (slab < ncs - 1)
    down = cols.mask[..., :2].any(dim=-1) & (slab > 0)

    combos4 = torch.tensor(list(itertools.product(range(2), range(2))), dtype=torch.int64, device=dev)
    o = o_lo[..., None, :, :] + combos4[:, None, :]  # (…, 4, Vu, 2)
    ok = (cols.valid[..., None, :] & (o <= o_hi[..., None, :, :]).all(dim=-1)
          & (o[..., 0] >= 0) & (o[..., 0] < onx) & (o[..., 1] >= 0) & (o[..., 1] < ony))
    oid = (o[..., 1] * onx + o[..., 0]) * ncs + slab[..., None, :]
    flags = (up.long() * 2 + down.long())[..., None, :]
    # One sort with the two flag bits packed under the id.
    skey = torch.sort(torch.where(ok, oid * 4 + flags, obig * 4).flatten(-2), dim=-1).values
    n4 = skey.shape[-1]
    cand = skey // 4
    cfl = skey - cand * 4
    head = (_shift_right(cand, -1) != cand) & (cand < obig)
    seg = torch.cumsum(head, dim=-1) - 1  # segment of each row
    total = seg[..., -1:] + 1
    # OR of the flag bits over each segment (a maximum per bit), read at the
    # segment's tail row.
    segc = seg.clamp(min=0)
    bits = torch.stack([cfl & 1, cfl >> 1], dim=0)
    seg_or = torch.zeros_like(bits).scatter_reduce_(-1, segc.expand(bits.shape), bits, "amax")
    flag_or = torch.gather(seg_or[0] + 2 * seg_or[1], -1, segc)
    tail = (_shift_left(cand, -1) != cand) & (cand < obig)

    p_cap = min(n4, max(2 * max_out, 3 * vu))
    overflow = total > p_cap
    den = torch.clamp(total - p_cap, min=1)
    d_period = torch.clamp(total // den, min=2)
    kept = ~overflow | (seg % d_period != d_period - 1)
    slot = torch.where(overflow, seg - (seg + 1) // d_period, seg)
    keep_row = tail & kept & (slot < p_cap)
    packed = torch.sort(torch.where(keep_row, cand * 4 + flag_or, obig * 4), dim=-1).values[..., :p_cap]
    par = packed // 4
    pvalid = par < obig
    pfl = torch.where(pvalid, packed - par * 4, 0)
    need_hi = (pfl >= 2) & pvalid
    need_lo = (pfl % 2 > 0) & pvalid
    emit_lo, emit_hi = _ghost_emits(par, need_lo, need_hi, obig)
    total2 = (pvalid.sum(-1, keepdim=True) + emit_lo.sum(-1, keepdim=True)
              + emit_hi.sum(-1, keepdim=True))
    buf = torch.sort(torch.cat([
        torch.where(pvalid, par, obig),
        torch.where(emit_lo, par - 1, obig),
        torch.where(emit_hi, par + 1, obig),
    ], dim=-1), dim=-1).values
    if buf.shape[-1] < max_out:
        buf = torch.cat([buf, buf.new_full((*lead, max_out - buf.shape[-1]), obig)], dim=-1)
    out_ids = torch.gather(buf, -1, _even_select(buf, total2, max_out).expand(*lead, max_out))
    return ColumnSet(
        col_ids=out_ids.to(torch.int32), valid=out_ids < obig,
        mask=torch.zeros((*lead, max_out, zso), dtype=torch.bool, device=dev),
        bev_shape=(onx * ncs, ony), nz=zso,
    )


def rev_qids_strided(in_cols: ColumnSet, out_cols: ColumnSet, ncs: int):
    """``(…, 9, Vu)`` int32 reverse queries of the strided conv: for input unit
    v at (ix, iy, slab) and offset j = (dx, dy), the id of the output unit at
    ``((ix − dx)/2, (iy − dy)/2, slab)`` where both are even and inside the
    output grid, else −1. Floor division, as Python's ``//`` on negatives."""
    nxv, _ = in_cols.bev_shape
    onxv, ony = out_cols.bev_shape
    onx = onxv // ncs
    offs = _bev_offsets2d(in_cols.col_ids.device)
    ic_ids = in_cols.col_ids.long()
    vx = ic_ids % nxv
    ix = vx // ncs
    slab = vx - ix * ncs
    iy = ic_ids // nxv
    tx = ix[..., None, :] - offs[:, None, 0]
    ty = iy[..., None, :] - offs[:, None, 1]
    even = (torch.remainder(tx, 2) == 0) & (torch.remainder(ty, 2) == 0)
    qx = torch.div(tx, 2, rounding_mode="floor")
    qy = torch.div(ty, 2, rounding_mode="floor")
    inb = (in_cols.valid[..., None, :] & even
           & (qx >= 0) & (qx < onx) & (qy >= 0) & (qy < ony))
    return torch.where(inb, (qy * onx + qx) * ncs + slab[..., None, :], -1).to(torch.int32)


def strided_conv_units_batched(colf, in_cols: ColumnSet, out_cols: ColumnSet, w, ncs: int):
    """k=3 s=2 p=1 strided conv over z-slab units: output slab c reads input
    slab c plus one top halo row. Returns (``(…, Vuo, zso, Cout)`` float32,
    ``(…, Vuo, zso)`` bool output activity). The activity rides as one extra
    channel through the same stencil pass (input channel ``cin`` holds the
    mask, a block-diagonal weight routes its window count to output channel
    ``cout``)."""
    zs, cin = colf.shape[-2:]
    zso = out_cols.nz
    cout = w.shape[-1]
    nxv, ny = in_cols.bev_shape
    nx = nxv // ncs
    onxv, _ = out_cols.bev_shape
    offs = _bev_offsets2d(colf.device)

    oc_ids = out_cols.col_ids.long()
    vx = oc_ids % onxv
    ox = vx // ncs
    slab = vx - ox * ncs
    oy = oc_ids // onxv
    qx = ox[..., None, :] * 2 + offs[:, None, 0]
    qy = oy[..., None, :] * 2 + offs[:, None, 1]
    qids = _in_grid_ids(out_cols.valid, qx, qy, nx, ny, (qy * nx + qx) * ncs + slab[..., None, :])

    m = in_cols.mask[..., None].to(colf.dtype)
    src = _unit_rows_padded(torch.cat([colf * m, m], dim=-1), in_cols.col_ids, in_cols.valid,
                            ncs, bottom=False)
    # [w 0; 0 1] without writing into a tensor, so that the gradient reaches w.
    corner = torch.zeros(27, cin + 1, cout + 1, dtype=w.dtype, device=w.device)
    corner[:, cin, cout] = 1
    w_aug = F.pad(w, (0, 1, 0, 1)) + corner
    wc = _unit_band_weights(w_aug, zso, zs + 1, 2, _lane_pad((zs + 1) * (cin + 1)))
    out_full = stencil_conv_batched(
        src, qids, in_cols.col_ids, wc, 1,
        rev_qids=rev_qids_strided(in_cols, out_cols, ncs), rev_src_ids=out_cols.col_ids,
    ).unflatten(-1, (zso, cout + 1))
    omask = (out_full[..., cout] > 0.5) & out_cols.valid[..., None]
    return out_full[..., :cout], omask


def columns_to_dense_bev(colf, cols: ColumnSet):
    """``(…, Vc, nz, C)`` columns → ``(…, ny, nx, nz·C)`` dense BEV (z-major,
    then C) through :func:`~lyft3d_tpu_torch.ops.dense_fill.fill_rows_by_id`."""
    nx, ny = cols.bev_shape
    rows = (colf * cols.mask[..., None].to(colf.dtype)).flatten(-2)
    dense = fill_rows_by_id(rows, cols.col_ids, cols.valid, ny * nx, assume_sorted=True)
    return dense.unflatten(-2, (ny, nx))


def units_to_dense_bev(colf, cols: ColumnSet, ncs: int, nz: int):
    """``(…, Vu, zs, C)`` units → ``(…, ny, nx, nz·C)`` dense BEV: a column's
    slabs concatenate along z."""
    c = colf.shape[-1]
    dense = columns_to_dense_bev(colf, cols)  # (…, ny, nx·NC, zs·C)
    nx = cols.bev_shape[0] // ncs
    dense = dense.unflatten(-2, (nx, ncs)).unflatten(-1, (cols.nz, c)).flatten(-3, -2)
    return dense[..., :nz, :].flatten(-2)


# ---------------------------------------------------------------------------
# The 9-offset stencil conv: kernel wrapper and plain version.
# ---------------------------------------------------------------------------


def stencil_conv_ref(src, qids, src_ids, wc, nc: int):
    """Plain version: ``torch.searchsorted`` positions → row gather → one
    einsum in float32."""
    kzp, n = wc.shape[1:]
    vq = qids.shape[-1]
    pos = stencil_positions_ref(qids, src_ids).long().flatten(-2)
    g = take_rows(src, pos.clamp(min=0)) * (pos >= 0)[..., None].to(src.dtype)
    g = g.reshape(*qids.shape[:-2], 9, vq, nc, kzp).float()
    out = torch.einsum("...jvck,jkn->...vcn", g, wc.to(src.dtype).float())
    return out.reshape(*qids.shape[:-2], vq, nc * n)


def stencil_conv_bwd_ref(src, qids, src_ids, wc, nc: int, grad_out):
    """Plain backward: :func:`stencil_conv_ref` differentiated by autograd.
    Returns ``(d_src, d_wc)`` in the dtypes of ``src`` and ``wc``."""
    with torch.enable_grad():
        s = src.detach().requires_grad_(True)
        w = wc.detach().requires_grad_(True)
        out = stencil_conv_ref(s, qids, src_ids, w, nc)
        return torch.autograd.grad(out, (s, w), grad_out)


def _check_args(src, qids, src_ids, wc, nc: int):
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"src must be float32 or bfloat16, got {src.dtype}")
    if qids.dtype != torch.int32 or src_ids.dtype != torch.int32:
        raise TypeError(f"qids and src_ids must be int32, got {qids.dtype} and {src_ids.dtype}")
    if src.dim() not in (2, 3) or qids.dim() != src.dim() or src_ids.dim() != src.dim() - 1:
        raise ValueError(
            f"src (…, Vs, nc·kzp), qids (…, 9, Vq) and src_ids (…, Vs) expected, got "
            f"{tuple(src.shape)}, {tuple(qids.shape)}, {tuple(src_ids.shape)}"
        )
    if wc.dim() != 3 or wc.shape[0] != 9 or qids.shape[-2] != 9:
        raise ValueError(f"wc (9, kzp, N) and 9 offsets expected, got {tuple(wc.shape)}, {tuple(qids.shape)}")
    if src.shape[-1] != nc * wc.shape[1]:
        raise ValueError(f"src width {src.shape[-1]} is not nc·kzp = {nc}·{wc.shape[1]}")
    if src_ids.shape != src.shape[:-1] or qids.shape[:-2] != src.shape[:-2]:
        raise ValueError(
            f"src {tuple(src.shape)}, qids {tuple(qids.shape)}, src_ids {tuple(src_ids.shape)} disagree"
        )
    if not (qids.device == src_ids.device == wc.device == src.device):
        raise ValueError(
            f"src on {src.device}, qids on {qids.device}, src_ids on {src_ids.device}, wc on {wc.device}"
        )


# Host side of the bfloat16 (tensor-core) route: what the kernels are told, and
# plain versions of the small preparation kernels.

MMA_SLICE = 64   # contraction lanes a pipeline stage of the kernel holds
MMA_MAX_K = 256  # widest contraction (16 steps of 16 lanes)
MMA_MAX_N = 256  # most output columns a block owns


def stencil_mma_variant(k: int, n: int) -> dict:
    """What the stencil launches ``conv_mma_kernel`` (``csrc/conv_mma.cuh``)
    with for a contraction of ``k`` lanes and ``n`` output columns: ``kp``
    (``k`` padded to whole 64-lane slices), ``n_pad`` (``n`` padded to pairs
    of 8-column tiles), the warps, queries and pipeline stages of a block and
    its dynamic shared memory. Up to 128 columns a block is 8 warps (4 x 2, a warp 32 queries x
    64 columns); up to 256 it is 16 warps (8 x 2, a warp 16 queries x 128
    columns). Raises for shapes the kernel does not take."""
    if k < 1 or n < 1:
        raise ValueError(f"the stencil kernel needs k ≥ 1 and n ≥ 1, got {k} and {n}")
    kp = -(-k // MMA_SLICE) * MMA_SLICE
    n_pad = -(-n // 16) * 16
    if kp > MMA_MAX_K or n_pad > MMA_MAX_N:
        raise ValueError(
            f"the bfloat16 stencil kernel takes up to {MMA_MAX_K} contraction lanes and "
            f"{MMA_MAX_N} output columns, got {k} and {n}"
        )
    warps, stages = (8, 3) if n_pad <= 128 else (16, 2)
    cols = 128 if n_pad <= 128 else 256
    return dict(kp=kp, n_pad=n_pad, warps=warps, queries=128, cols=cols, stages=stages,
                smem_bytes=stages * (128 + cols) * (MMA_SLICE + 8) * 2)


def bf16_split(x):
    """``x`` float32 → ``(hi, lo)`` bfloat16 with ``hi + lo`` within 2^-16 of
    ``x``: what the weight-gradient kernel does to a float32 cotangent (two
    MMAs) instead of rounding it once."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def stencil_weight_prep_ref(wc, kp: int, n_pad: int, dtype=torch.bfloat16):
    """Plain version of ``weight_prep_kernel`` (``csrc/conv_mma.cuh``): ``wc`` ``(9, k, n)`` →
    ``wt`` ``(9, n_pad, kp)`` bfloat16 (contraction index last, zero-padded)
    and ``wmask`` ``(9, 16)`` int64 whose bit ``o // 8`` of entry ``[j, k //
    16]`` says that the 16 x 8 block holds a non-zero. ``dtype`` float32 keeps
    the values unrounded (for tests of the layout alone)."""
    k, n = wc.shape[1:]
    wt = F.pad(wc.to(dtype).transpose(1, 2), (0, kp - k, 0, n_pad - n))
    blocks = (wt.float() != 0).reshape(9, n_pad // 8, 8, kp // 16, 16).any(dim=4).any(dim=2)
    bits = (blocks.long() << torch.arange(n_pad // 8, device=wc.device)[None, :, None]).sum(dim=1)
    return wt.contiguous(), F.pad(bits, (0, 16 - kp // 16))


def stencil_rows_prep_ref(rows, nc: int, k: int, kp: int, dtype=torch.bfloat16):
    """Plain version of ``rows_prep_kernel`` (``csrc/conv_mma.cuh``): ``rows`` ``(…, nc·k)`` →
    ``(…, nc·kp)`` bfloat16 (or ``dtype``), each chunk zero-padded, and a uint8
    flag a row (1: the row holds a non-zero)."""
    padded = F.pad(rows.unflatten(-1, (nc, k)), (0, kp - k)).flatten(-2).to(dtype)
    return padded, (rows != 0).any(dim=-1).to(torch.uint8)


def stencil_positions_ref(qids, src_ids, src_flags=None):
    """Plain version of ``stencil_positions_kernel``: ``(…, 9, Vq)`` int32
    positions of ``qids`` in the ascending ``src_ids``; −1 where absent or
    where the source row's flag is 0."""
    vs = src_ids.shape[-1]
    if vs == 0:
        return torch.full_like(qids, -1)
    ids = src_ids.long().contiguous()
    flat = qids.long().flatten(-2)
    pos = torch.searchsorted(ids, flat.contiguous()).clamp_(max=vs - 1)
    hit = (torch.gather(ids, -1, pos) == flat) & (flat >= 0)
    if src_flags is not None:
        hit = hit & (torch.gather(src_flags, -1, pos) != 0)
    return torch.where(hit, pos, -1).to(torch.int32).reshape(qids.shape)


def stencil_conv_mma_ref(src, qids, src_ids, wc, nc: int, dtype=torch.bfloat16):
    """Plain version of the bfloat16 route as a whole, step by step as the
    kernels take it: rows rounded to bfloat16 and padded, zero rows flagged
    and turned into misses, weights transposed, padded and only their
    non-zero 16 x 8 blocks multiplied, float32 sums. Equal to
    :func:`stencil_conv_ref` on bfloat16 inputs up to summation order.
    ``dtype`` float32 skips the rounding (for tests of the route's padding,
    flags and block masks alone)."""
    k, n = wc.shape[1:]
    var = stencil_mma_variant(k, n)
    kp, n_pad = var["kp"], var["n_pad"]
    rows, flags = stencil_rows_prep_ref(src, nc, k, kp, dtype)
    pos = stencil_positions_ref(qids, src_ids, flags)
    wt, wmask = stencil_weight_prep_ref(wc, kp, n_pad, dtype)
    keep = (wmask[:, : kp // 16, None] >> torch.arange(n_pad // 8, device=wc.device)) & 1
    keep = keep.repeat_interleave(16, dim=1).repeat_interleave(8, dim=2)  # (9, kp, n_pad)
    w = wt.float().transpose(1, 2) * keep.to(torch.float32)
    vq = qids.shape[-1]
    flat = pos.long().flatten(-2)
    g = take_rows(rows, flat.clamp(min=0)) * (flat >= 0)[..., None].to(rows.dtype)
    g = g.reshape(*qids.shape[:-2], 9, vq, nc, kp).float()
    out = torch.einsum("...jvck,jkn->...vcn", g, w)[..., :n]
    return out.reshape(*qids.shape[:-2], vq, nc * n)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The launch functions of csrc/stencil_conv.cu; the last argument is the stream.
_SIGNATURES = {
    "stencil_conv_launch": [_P] * 5 + [_I] * 7,
    "stencil_wgrad_launch": [_P] * 5 + [_I] * 7,
    "stencil_positions_launch": [_P] * 4 + [_I] * 4,
    "stencil_weight_prep_launch": [_P] + [_LL] * 3 + [_P] * 2 + [_I] * 5,
    "stencil_rows_prep_launch": [_P] * 3 + [_LL] + [_I] * 5,
    "stencil_conv_mma_launch": [_P, _I] + [_P] * 6 + [_LL] * 3 + [_P] * 3 + [_I] * 10,
    "stencil_wgrad_mma_launch": [_P] * 5 + [_I] + [_P] * 3 + [_I] * 8,
}


def _kernel_library(entry: str = "stencil_conv_launch"):
    """The launch function ``entry`` of ``csrc/stencil_conv.cu`` (built at
    first use)."""
    fn = getattr(_build.load_library("stencil_conv"), entry)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[entry] + [_P]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, tensor, *args):
    """Call ``entry`` of ``csrc/stencil_conv.cu`` on PyTorch's current stream
    of ``tensor``'s device; tensors become pointers (``None`` a null pointer),
    the device index and the stream are appended. Raises on a CUDA error."""
    fn = _kernel_library(entry)
    dev = tensor.device.index if tensor.device.index is not None else torch.cuda.current_device()
    values = [_P(a.data_ptr()) if isinstance(a, torch.Tensor) else (_P(None) if a is None else a)
              for a in args]
    err = fn(*values, dev, _P(torch.cuda.current_stream(tensor.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")


def _rows_prep_cuda(rows, nc: int, k: int, kp: int, want_rows: bool = True):
    """``rows_prep_kernel``: ``rows`` (b, v, nc·k) float32 or bfloat16 →
    ((b, v, nc·kp) bfloat16 or None, (b, v) uint8 flags)."""
    b, v, _ = rows.shape
    out = torch.empty((b, v, nc * kp), dtype=torch.bfloat16, device=rows.device) if want_rows else None
    flags = torch.empty((b, v), dtype=torch.uint8, device=rows.device)
    _launch("stencil_rows_prep_launch", rows, rows, out, flags, b * v, nc, k, kp, _DTYPE_CODES[rows.dtype])
    return out, flags


def _positions_cuda(qids, src_ids, src_flags=None):
    """``stencil_positions_kernel``: (b, 9, vq) int32 positions."""
    b, _, vq = qids.shape
    pos = torch.empty_like(qids)
    _launch("stencil_positions_launch", qids, qids, src_ids, src_flags, pos, b, src_ids.shape[-1], vq)
    return pos


def _weight_prep_cuda(wc, kp: int, n_pad: int):
    """``weight_prep_kernel``: ``wc`` (9, k, n) bfloat16 of any strides →
    (9, n_pad, kp) bfloat16 and the (9, 16) int32 block bitmap."""
    k, n = wc.shape[1:]
    wt = torch.empty((9, n_pad, kp), dtype=torch.bfloat16, device=wc.device)
    wmask = torch.empty((9, 16), dtype=torch.int32, device=wc.device)
    _launch("stencil_weight_prep_launch", wc, wc, *wc.stride(), wt, wmask, k, n, kp, n_pad)
    return wt, wmask


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels' vector accesses)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scratch(device, *sizes):
    """One uninitialised allocation cut into 16-byte aligned uint8 views of
    ``sizes`` bytes (0: ``None``)."""
    starts, total = [], 0
    for size in sizes:
        starts.append(total)
        total += -(-size // 16) * 16
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return [buf[o:o + n] if n else None for o, n in zip(starts, sizes)]


def _check_not_empty(what: str, **sizes):
    """The kernels take no empty shape (nothing would be launched)."""
    if min(sizes.values()) < 1:
        raise ValueError(f"{what} takes no empty shape on a CUDA tensor, got "
                         + ", ".join(f"{k} = {v}" for k, v in sizes.items()))


def _stencil_conv_mma(s, q, ids, wc, nc: int, dgrad: bool, out_dtype):
    """The bfloat16 route on batched, contiguous arguments: one call launches
    the row preparation (where ``s`` is not bfloat16 rows of whole 64-lane
    slices, or is the cotangent of ``d_src``, ``dgrad``, whose zero rows are
    worth flagging), the positions, the weight preparation and the
    tensor-core kernel, and is counted as one launch of the forward or of
    ``d_src``. Returns the output and the rows' flags (b, vs) uint8 (``None``
    without preparation)."""
    global KERNEL_LAUNCHES, DGRAD_KERNEL_LAUNCHES
    b, vs, _ = s.shape
    vq = q.shape[-1]
    k, n = wc.shape[1:]
    var = stencil_mma_variant(k, n)
    kp, n_pad = var["kp"], var["n_pad"]
    _check_not_empty("the stencil kernel", b=b, vs=vs, vq=vq, nc=nc)
    prep = dgrad or kp != k or s.dtype != torch.bfloat16
    w = wc.to(torch.bfloat16)
    pos, wt, wmask, flags, rows = _scratch(
        s.device, 4 * b * 9 * vq, 2 * 9 * n_pad * kp, 4 * 9 * 16, b * vs if prep else 0,
        2 * b * vs * nc * kp if prep else 0)
    out = torch.empty((b, vq, nc * n), dtype=out_dtype, device=s.device)
    _launch("stencil_conv_mma_launch", s, _aligned(s), _DTYPE_CODES[s.dtype], rows, flags,
            q, ids, pos, w, *w.stride(), wt, wmask, out, _DTYPE_CODES[out_dtype],
            b, vs, vq, nc, k, n, kp, n_pad)
    if dgrad:
        DGRAD_KERNEL_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1
    return out, (flags.view(b, vs) if prep else None)


def _stencil_conv_cuda(src, qids, src_ids, wc, nc: int, dgrad: bool = False, out_dtype=torch.float32):
    """Launch the stencil kernel of ``csrc/stencil_conv.cu`` on PyTorch's
    current stream: the float32 FMA kernel for float32 ``src``, the bfloat16
    tensor-core kernel (with its preparation kernels) for bfloat16 ``src``;
    ``wc`` may have any strides there. ``dgrad`` says that this is the
    backward's launch on the reverse queries, counted apart. The output is
    float32; the bfloat16 route can also round its float32 sums to bfloat16
    itself (``out_dtype``), which saves ``d_src`` a pass."""
    global KERNEL_LAUNCHES, DGRAD_KERNEL_LAUNCHES
    batched = src.dim() == 3
    s = (src if batched else src[None]).contiguous()
    q = (qids if batched else qids[None]).contiguous()
    ids = (src_ids if batched else src_ids[None]).contiguous()
    if s.dtype == torch.float32:
        if out_dtype != torch.float32:
            raise ValueError("the float32 stencil kernel writes float32")
        b, vs, _ = s.shape
        k, n = wc.shape[1:]
        _check_not_empty("the stencil kernel", b=b, vs=vs, vq=q.shape[-1], nc=nc, k=k, n=n)
        out = torch.empty((b, q.shape[-1], nc * n), dtype=torch.float32, device=s.device)
        _launch("stencil_conv_launch", s, s, q, ids, wc.to(s.dtype).contiguous(), out,
                b, vs, q.shape[-1], nc, k, n)
        if dgrad:
            DGRAD_KERNEL_LAUNCHES += 1
        else:
            KERNEL_LAUNCHES += 1
    else:
        out, _ = _stencil_conv_mma(s, q, ids, wc, nc, dgrad, out_dtype)
    return out if batched else out[0]


def _stencil_wgrad_cuda(src, qids, src_ids, grad_out, nc: int, kzp: int, n: int, flags=None):
    """Launch the weight-gradient kernel on PyTorch's current stream: ``(9,
    kzp, n)`` float32 from the source rows and the float32 cotangent; the FMA
    tile for float32 ``src``, the tensor-core tile for bfloat16 ``src``, which
    skips queries whose cotangent row is zero by ``flags`` (b, vq) uint8
    (computed in the same call when not given)."""
    global WGRAD_KERNEL_LAUNCHES
    batched = src.dim() == 3
    s = (src if batched else src[None]).contiguous()
    q = (qids if batched else qids[None]).contiguous()
    ids = (src_ids if batched else src_ids[None]).contiguous()
    g = (grad_out if batched else grad_out[None]).float().contiguous()
    b, vs, _ = s.shape
    vq = q.shape[-1]
    _check_not_empty("the stencil's weight-gradient kernel", b=b, vs=vs, vq=vq, nc=nc, kzp=kzp, n=n)
    out, queues, tiles = wgrad_buffers(9, kzp, n, s.device)
    if s.dtype == torch.float32:
        _launch("stencil_wgrad_launch", s, s, q, ids, g, out, b, vs, vq, nc, kzp, n)
    else:
        pos, own_flags = _scratch(s.device, 4 * b * 9 * vq, b * vq if flags is None else 0)
        _launch("stencil_wgrad_mma_launch", s, _aligned(s), q, ids, _aligned(g),
                own_flags if flags is None else flags, int(flags is not None), pos, out, queues, tiles,
                b, vs, vq, nc, kzp, n)
    WGRAD_KERNEL_LAUNCHES += 1
    return out


class StencilConv(torch.autograd.Function):
    """The stencil with its gradient; ``wc`` in ``src``'s dtype. ``rev_qids``
    ``(…, 9, Vs)`` and ``rev_src_ids`` ``(…, Vq)`` are the reverse queries (for
    source row v and offset j the id of the query that reads v, and the
    ascending ids of the queries). On a CUDA tensor ``d_src`` is the stencil
    kernel on them and ``d_wc`` the weight-gradient kernel; without reverse
    queries the backward raises there. On a CPU tensor the plain versions run
    (without reverse queries, autograd of the plain forward).

    In bfloat16 on the card ``d_src``'s call first rounds the float32
    cotangent to bfloat16 rows padded to whole 64-lane slices (the strided
    layers' 65, 66 and 68 lanes are not 16-byte aligned) and flags its
    non-zero rows (``rows_prep_kernel``, one pass); both kernels skip
    the zero rows the capacity caps leave."""

    @staticmethod
    def forward(ctx, src, qids, src_ids, wc, nc, rev_qids, rev_src_ids):
        ctx.save_for_backward(src, qids, src_ids, wc, rev_qids, rev_src_ids)
        ctx.nc = nc
        if src.device.type == "cuda":
            return _stencil_conv_cuda(src, qids, src_ids, wc, nc)
        return stencil_conv_ref(src, qids, src_ids, wc, nc)

    @staticmethod
    def backward(ctx, grad_out):
        src, qids, src_ids, wc, rev_qids, rev_src_ids = ctx.saved_tensors
        nc = ctx.nc
        grad_out = grad_out.contiguous()
        need_src, need_wc = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        on_card = grad_out.device.type == "cuda"
        if rev_qids is None:
            if on_card:
                raise ValueError(
                    "the stencil's backward on a CUDA tensor needs rev_qids and rev_src_ids"
                )
            d_src, d_wc = stencil_conv_bwd_ref(src, qids, src_ids, wc, nc, grad_out)
            return (d_src if need_src else None), None, None, (d_wc if need_wc else None), None, None, None
        kzp, n = wc.shape[1:]
        d_src = d_wc = None
        flags = None
        if need_src:
            # The transposed conv is a 9-offset stencil over the cotangent
            # rows (chunk width N, output width kzp), picked by the reverse
            # queries; the cotangent rows' ids are the forward's query ids.
            wct = wc.transpose(1, 2)
            if on_card and src.dtype == torch.bfloat16:
                batched = grad_out.dim() == 3
                d_src, flags = _stencil_conv_mma(
                    grad_out if batched else grad_out[None],
                    (rev_qids if batched else rev_qids[None]).contiguous(),
                    (rev_src_ids if batched else rev_src_ids[None]).contiguous(),
                    wct, nc, True, src.dtype)
                d_src = d_src if batched else d_src[0]
            elif on_card:
                d_src = _stencil_conv_cuda(grad_out.to(src.dtype), rev_qids, rev_src_ids, wct, nc, dgrad=True)
            else:
                d_src = stencil_conv_ref(grad_out.to(src.dtype), rev_qids, rev_src_ids, wct.contiguous(), nc)
            d_src = d_src.to(src.dtype)
        if need_wc:
            if on_card:
                d_wc = _stencil_wgrad_cuda(src, qids, src_ids, grad_out, nc, kzp, n, flags=flags).to(wc.dtype)
            else:
                d_wc = stencil_conv_bwd_ref(src, qids, src_ids, wc, nc, grad_out)[1]
        return d_src, None, None, d_wc, None, None, None


def stencil_conv_batched(src, qids, src_ids, wc, nc: int, rev_qids=None, rev_src_ids=None):
    """9-offset stencil conv over chunked column rows, matched by id:
    ``out[…, q, c·N:(c+1)·N] = Σ_j src[…, pos(qids[…, j, q])][c·kzp:(c+1)·kzp] @ wc[j]``.

    ``src`` ``(…, Vs, nc·kzp)`` float32 or bfloat16 source rows; ``qids``
    ``(…, 9, Vq)`` int32 neighbour ids per offset (−1 absent); ``src_ids``
    ``(…, Vs)`` int32 ascending source ids (the invalid tail above every
    query id); ``wc`` ``(9, kzp, N)`` band weights, cast to ``src``'s dtype.
    ``rev_qids`` ``(…, 9, Vs)`` / ``rev_src_ids`` ``(…, Vq)`` int32: the
    optional reverse queries the backward's ``d_src`` runs on
    (:class:`StencilConv`). Returns ``(…, Vq, nc·N)`` float32: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor, an error
    otherwise. Differentiable with respect to ``src`` and ``wc``.
    """
    kind = src.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"stencil_conv_batched runs on cuda or cpu tensors, not {kind!r}")
    _check_args(src, qids, src_ids, wc, nc)
    if (rev_qids is None) != (rev_src_ids is None):
        raise ValueError("rev_qids and rev_src_ids come together")
    if rev_qids is not None and (
        rev_qids.dtype != torch.int32 or rev_src_ids.dtype != torch.int32
        or rev_qids.shape != (*src.shape[:-2], 9, src.shape[-2])
        or rev_src_ids.shape != (*qids.shape[:-2], qids.shape[-1])
    ):
        raise ValueError(
            f"rev_qids (…, 9, Vs) and rev_src_ids (…, Vq) int32 expected, got "
            f"{tuple(rev_qids.shape)} {rev_qids.dtype}, {tuple(rev_src_ids.shape)} {rev_src_ids.dtype}"
        )
    return StencilConv.apply(src, qids, src_ids, wc.to(src.dtype), nc, rev_qids, rev_src_ids)
