"""The z-slab unit middle's index rules and its plain convolution, for the
plain reference (a frozen copy of the port's plain path: the port's
``ops/column_sparse.py`` at the time the benchmark was written).

The unit rules (which units exist, the ghost units that carry z halos, the
even-spread caps) are integer arithmetic that decides which sites a stage
keeps; the reference has to keep the same ones, so they are copied
literally. The convolution is :func:`stencil_conv_ref`, a row gather and one
float32 einsum, with no kernel and no batching rule of the port's. Imports
nothing of the port.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Larger than any unit id (nx·ny·NC ≤ 2^25 at the FHD geometry).
PAD_ID = 2 ** 28


@dataclass(frozen=True)
class ActiveSet:
    coords: torch.Tensor  # (…, V, 3) int32 (ix, iy, iz)
    valid: torch.Tensor  # (…, V) bool
    spatial_shape: Tuple[int, int, int]  # (nx, ny, nz)


@dataclass(frozen=True)
class ColumnSet:
    """Fixed-capacity set of active units over the virtual BEV grid, with
    their dense-z activity masks."""

    col_ids: torch.Tensor  # (…, Vc) int32 ascending ids; invalid entries at the tail
    valid: torch.Tensor  # (…, Vc) bool
    mask: torch.Tensor  # (…, Vc, nz) bool: active cells of each unit
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


def take_rows(x, idx):
    """``x[…, idx[…, i], :]`` for ``x (…, V, C)`` and ``idx (…, I)``."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def fill_rows_plain(features, row_ids, valid, num_rows: int, assume_sorted: bool = False):
    """``(…, V, C)`` rows summed into a ``(…, num_rows, C)`` canvas at their ids
    (``index_add_``); invalid entries and ids outside ``[0, num_rows)`` are
    dropped. ``assume_sorted`` is accepted and ignored."""
    del assume_sorted
    lead = features.shape[:-1]
    c = features.shape[-1]
    ok = valid & (row_ids >= 0) & (row_ids < num_rows)
    ids = torch.where(ok, row_ids, num_rows).reshape(-1, lead[-1]).long()
    feats = features.reshape(-1, lead[-1], c)
    b = feats.shape[0]
    base = torch.arange(b, device=feats.device, dtype=torch.int64)[:, None] * (num_rows + 1)
    canvas = torch.zeros(b * (num_rows + 1), c, dtype=features.dtype, device=features.device)
    canvas = canvas.index_add(0, (base + ids).reshape(-1), feats.reshape(-1, c))
    return canvas.view(b, num_rows + 1, c)[:, :num_rows].reshape(*lead[:-1], num_rows, c)


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
    :func:`fill_rows_plain`, with a ones
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
    filled = fill_rows_plain(f_aug, dest, place_ok, canvas, assume_sorted=False)
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
    out = stencil_conv_ref(src, qids, cols.col_ids, wc, 1)
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
    out_full = stencil_conv_ref(src, qids, in_cols.col_ids, wc, 1).unflatten(-1, (zso, cout + 1))
    omask = (out_full[..., cout] > 0.5) & out_cols.valid[..., None]
    return out_full[..., :cout], omask


def columns_to_dense_bev(colf, cols: ColumnSet):
    """``(…, Vc, nz, C)`` columns → ``(…, ny, nx, nz·C)`` dense BEV (z-major,
    then C) through :func:`fill_rows_plain`."""
    nx, ny = cols.bev_shape
    rows = (colf * cols.mask[..., None].to(colf.dtype)).flatten(-2)
    dense = fill_rows_plain(rows, cols.col_ids, cols.valid, ny * nx, assume_sorted=True)
    return dense.unflatten(-2, (ny, nx))


def units_to_dense_bev(colf, cols: ColumnSet, ncs: int, nz: int):
    """``(…, Vu, zs, C)`` units → ``(…, ny, nx, nz·C)`` dense BEV: a column's
    slabs concatenate along z."""
    c = colf.shape[-1]
    dense = columns_to_dense_bev(colf, cols)  # (…, ny, nx·NC, zs·C)
    nx = cols.bev_shape[0] // ncs
    dense = dense.unflatten(-2, (nx, ncs)).unflatten(-1, (cols.nz, c)).flatten(-3, -2)
    return dense[..., :nz, :].flatten(-2)


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
