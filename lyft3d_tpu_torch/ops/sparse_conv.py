"""Sparse 3D convolution on fixed-capacity active-voxel lists (port of
``lyft3d_tpu/ops/sparse_conv.py``).

An active set is ``coords (…, V, 3)`` int32 ``(ix, iy, iz)`` with a
``valid (…, V)`` mask over a static spatial shape; every function takes one
sample or a batch (leading dimensions are carried where the JAX package
``vmap``s). Neighbours of all K kernel offsets are resolved to ranks in the
sorted id order (−1 where absent); a conv is then
``out[v] = Σ_k f_sorted[rank[k, v]] @ W[k]``. The fused form of that sum is
:func:`lyft3d_tpu_torch.ops.subm_conv_kernel.subm_conv`.

Id resolution is one ``torch.searchsorted`` over the sorted ids
(:func:`resolve_ids`). The JAX package's packed merge-sort
(``lookup_batch``, ``match_slots``) and dense rank table
(``resolve_ids_table``) exist because binary searches are slow on a TPU,
and are not ported.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

__all__ = ["ActiveSet", "kernel_offsets", "build_hash", "lookup", "resolve_ids", "subm_neighbors",
           "take_rows", "gather_by_rank", "subm_conv3d_gather", "downsample_coords",
           "sparse_conv3d_gather"]


@dataclass(frozen=True)
class ActiveSet:
    coords: torch.Tensor  # (…, V, 3) int32 (ix, iy, iz)
    valid: torch.Tensor  # (…, V) bool
    spatial_shape: Tuple[int, int, int]  # (nx, ny, nz)


def _volume(spatial_shape) -> int:
    nx, ny, nz = spatial_shape
    assert nx * ny * nz < 2 ** 30, f"spatial volume {nx}x{ny}x{nz} overflows int32 ids"
    return nx * ny * nz


def _flat_query_ids(q_coords, q_ok, spatial_shape):
    """``(…, 3)`` coords → flat ids ``(z·ny + y)·nx + x`` with out-of-range and
    not-ok entries forced to ``big = nx·ny·nz``; also returns the in-range mask."""
    nx, ny, nz = spatial_shape
    big = _volume(spatial_shape)
    x, y, z = q_coords[..., 0].long(), q_coords[..., 1].long(), q_coords[..., 2].long()
    inb = q_ok & (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
    ids = (z * ny + y) * nx + x
    return torch.where(inb, ids, big), inb


def build_hash(active: ActiveSet):
    """Sorted-id lookup structure ``(sorted_ids, perm, big)``: invalid entries
    carry ``big`` and sort to the tail."""
    ids, _ = _flat_query_ids(active.coords, active.valid, active.spatial_shape)
    # Invalid rows need no range test in the JAX version; coords of a valid
    # row are in range by contract, so the two agree.
    sorted_ids, perm = torch.sort(ids, dim=-1, stable=True)
    return sorted_ids, perm, _volume(active.spatial_shape)


def resolve_ids(sorted_ids, big: int, qids):
    """``(…, K, Q)`` query flat ids → ranks in ``sorted_ids (…, V)`` (−1 where
    absent or ``>= big``)."""
    v = sorted_ids.shape[-1]
    flat = qids.reshape(*qids.shape[:-2], -1)
    pos = torch.searchsorted(sorted_ids.contiguous(), flat.contiguous()).clamp_(max=v - 1)
    hit = (torch.gather(sorted_ids, -1, pos) == flat) & (flat < big)
    return torch.where(hit, pos, -1).reshape(qids.shape)


def lookup(sorted_ids, perm, big: int, query_coords, query_ok, spatial_shape):
    """Row indices of ``query_coords (…, Q, 3)`` in the hashed active set
    (:func:`build_hash`), −1 where absent, out of range or not
    ``query_ok``."""
    qids, _ = _flat_query_ids(query_coords, query_ok, spatial_shape)
    rank = resolve_ids(sorted_ids, big, qids[..., None, :])[..., 0, :]
    return torch.where(rank >= 0, torch.gather(perm, -1, rank.clamp(min=0)), -1)


def kernel_offsets(kernel_size: int = 3, device=None):
    """``(K, 3)`` integer offsets centred at 0 (27 for 3³), x slowest."""
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return torch.tensor(list(itertools.product(r, r, r)), dtype=torch.int32, device=device)


def subm_neighbors(active: ActiveSet, hash_, offsets):
    """``(…, K, V)`` sorted-order neighbour ranks of a submanifold stencil,
    computed once per active set and shared by every conv on it."""
    sorted_ids, _, big = hash_
    q = active.coords[..., None, :, :] + offsets[:, None, :]  # (…, K, V, 3)
    qids, _ = _flat_query_ids(q, active.valid[..., None, :], active.spatial_shape)
    return resolve_ids(sorted_ids, big, qids)


def take_rows(x, idx):
    """``x[…, idx[…, i], :]`` for ``x (…, V, C)`` and ``idx (…, I)``."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def gather_by_rank(features, perm, rank):
    """``(…, V, C)`` features + ``(…, K, Q)`` sorted-order ranks → ``(…, K, Q, C)``
    neighbour rows (zeros where absent)."""
    v = features.shape[-2]
    f_sorted = take_rows(features, perm)
    k, q = rank.shape[-2:]
    rows = take_rows(f_sorted, rank.clamp(0, v - 1).reshape(*rank.shape[:-2], k * q))
    rows = rows.reshape(*rank.shape, features.shape[-1])
    return rows * (rank >= 0)[..., None].to(features.dtype)


def subm_conv3d_gather(features, active: ActiveSet, hash_, offsets):
    """``(…, K, V, C)`` neighbour rows of a submanifold conv over ``offsets``
    (zeros where absent): ``out[v] = Σ_k rows[k, v] @ W[k]`` is the conv."""
    return gather_by_rank(features, hash_[1], subm_neighbors(active, hash_, offsets))


def downsample_coords(
    active: ActiveSet,
    max_out: int,
    kernel_size: int = 3,
    stride: Sequence[int] = (2, 2, 2),
    padding: Sequence[int] = (1, 1, 1),
) -> ActiveSet:
    """Active output set of a strided sparse conv (every output site that
    receives at least one active input), ascending by flat id and cut at
    ``max_out``."""
    dev = active.coords.device
    out_shape = tuple(
        (d + 2 * p - kernel_size) // s + 1
        for d, s, p in zip(active.spatial_shape, stride, padding)
    )
    onx, ony, onz = out_shape
    obig = onx * ony * onz
    s = torch.tensor(stride, dtype=torch.int64, device=dev)
    p = torch.tensor(padding, dtype=torch.int64, device=dev)
    dims = torch.tensor(out_shape, dtype=torch.int64, device=dev)

    # Output sites along one dim that read input i: o·s ≤ i+p ≤ o·s+k−1, so
    # o ∈ [ceil((i+p−k+1)/s), floor((i+p)/s)]: at most ceil(k/s) of them.
    spans = tuple(-(-kernel_size // st) for st in stride)
    num = active.coords.long() + p
    o_hi = num // s
    o_lo = -((-(num - (kernel_size - 1))) // s)  # ceil division
    combos = torch.tensor(list(itertools.product(*(range(sp) for sp in spans))),
                          dtype=torch.int64, device=dev)  # (P, 3)
    o = o_lo[..., None, :, :] + combos[:, None, :]  # (…, P, V, 3)
    ok = (active.valid[..., None, :]
          & (o <= o_hi[..., None, :, :]).all(-1) & (o >= 0).all(-1) & (o < dims).all(-1))
    ids = (o[..., 2] * ony + o[..., 1]) * onx + o[..., 0]
    cand = torch.where(ok, ids, obig).flatten(-2)  # (…, P·V)
    cand = torch.sort(cand, dim=-1).values
    is_head = torch.ones_like(cand, dtype=torch.bool)
    is_head[..., 1:] = cand[..., 1:] != cand[..., :-1]
    is_head &= cand < obig
    out_ids = torch.sort(torch.where(is_head, cand, obig), dim=-1).values
    if out_ids.shape[-1] < max_out:
        pad = out_ids.new_full((*out_ids.shape[:-1], max_out - out_ids.shape[-1]), obig)
        out_ids = torch.cat([out_ids, pad], dim=-1)
    out_ids = out_ids[..., :max_out]
    out_valid = out_ids < obig
    zero = torch.zeros((), dtype=out_ids.dtype, device=dev)
    coords = torch.stack(
        [torch.where(out_valid, c, zero)
         for c in (out_ids % onx, (out_ids % (ony * onx)) // onx, out_ids // (ony * onx))],
        dim=-1,
    ).to(torch.int32)
    return ActiveSet(coords=coords, valid=out_valid, spatial_shape=out_shape)


def sparse_conv3d_gather(
    features,
    in_active: ActiveSet,
    out_active: ActiveSet,
    kernel_size: int = 3,
    stride: Sequence[int] = (2, 2, 2),
    padding: Sequence[int] = (1, 1, 1),
):
    """``(…, K, V_out, C)`` input rows feeding each output site of a strided
    sparse conv: input coord = s·o + kk − p."""
    dev = features.device
    sorted_ids, perm, big = build_hash(in_active)
    kk = kernel_offsets(kernel_size, dev).long() + kernel_size // 2
    s = torch.tensor(stride, dtype=torch.int64, device=dev)
    p = torch.tensor(padding, dtype=torch.int64, device=dev)
    q = out_active.coords.long()[..., None, :, :] * s + kk[:, None, :] - p  # (…, K, V_out, 3)
    qids, _ = _flat_query_ids(q, out_active.valid[..., None, :], in_active.spatial_shape)
    return gather_by_rank(features, perm, resolve_ids(sorted_ids, big, qids))
