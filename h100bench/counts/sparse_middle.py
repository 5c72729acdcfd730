"""The work of the sparse middle's convolutions, counted from the sites the
reference keeps, independently of how the program computes them.

A convolution's useful multiply-adds are its (output site, offset, active
input site) pairs times ``Cin × Cout``: every active cell of a submanifold
layer with each active cell of its 3³ neighbourhood; every active output
cell of a strided layer (k3, s2, p1) with each active cell of its input
window. Its bytes are each active input row, each output row and the
weights read or written once, in bfloat16. Its least time is the larger of
the operations over the bfloat16 peak and the bytes over the memory rate.
"""

from __future__ import annotations

import itertools
from typing import List

import torch

from h100bench.counts.peaks import BF16_PEAK, bound

BYTES = 2  # bfloat16


def unit_cells(cols, ncs: int):
    """``(n, 3)`` int64 (x, y, z) of the active cells of one sample's unit set,
    and the grid ``(nx, ny, nz)``."""
    nxv, ny = cols.bev_shape
    zs = cols.nz
    ids = cols.col_ids.reshape(-1).long()
    mask = cols.mask.reshape(ids.shape[0], zs) & cols.valid.reshape(-1, 1)
    r, l = torch.nonzero(mask, as_tuple=True)
    u = ids[r]
    vx, y = u % nxv, u // nxv
    x, slab = vx // ncs, vx % ncs
    return torch.stack([x, y, slab * zs + l], dim=-1), (nxv // ncs, ny, ncs * zs)


def _hits(cells, dims, queries):
    """How many of ``queries (…, 3)`` are among ``cells``."""
    nx, ny, nz = dims
    key = lambda c: (c[..., 2] * ny + c[..., 1]) * nx + c[..., 0]  # noqa: E731
    table = torch.sort(key(cells)).values
    ok = ((queries >= 0) & (queries < torch.tensor(dims, device=queries.device))).all(-1)
    q = key(queries.clamp(min=0))
    pos = torch.searchsorted(table, q).clamp(max=max(table.numel() - 1, 0))
    return int((ok & (table.numel() > 0) & (table[pos] == q)).sum()) if table.numel() else 0


def layer_work(record, rcfg) -> List[dict]:
    """Per convolution of one sample (``record`` of the reference's
    ``unit_middle``): pairs, active input and output rows, widths."""
    ncs = -(-rcfg.grid.grid_size[2] // rcfg.middle_z_slab)
    offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)))
    out = []
    for kind, cin_set, cout_set, cin, cout in record:
        a, dims = unit_cells(cin_set, ncs)
        o = a if kind == "subm" else unit_cells(cout_set, ncs)[0]
        base = o if kind == "subm" else 2 * o
        q = base[:, None, :] + offs.to(a.device)[None]
        out.append({"kind": kind, "pairs": _hits(a, dims, q.reshape(-1, 3)), "in_rows": a.shape[0],
                    "out_rows": o.shape[0], "cin": cin, "cout": cout})
    return out


def layer_least_seconds(layer: dict) -> float:
    ops = 2.0 * layer["pairs"] * layer["cin"] * layer["cout"]
    n_bytes = BYTES * (layer["in_rows"] * layer["cin"] + layer["out_rows"] * layer["cout"]
                       + 27 * layer["cin"] * layer["cout"])
    return bound(n_bytes, ops, BF16_PEAK)[0]


def least_seconds(layers) -> float:
    """The middle's least time: its layers run one after another."""
    return sum(layer_least_seconds(x) for x in layers)
