"""Host side of the tensor-core weight-gradient kernel
(``csrc/wgrad_tile.cuh::wgrad_mma_kernel``), shared by its two callers,
``ops/column_sparse.py`` (the stencil's ``d_wc``) and
``ops/subm_conv_kernel.py`` (the rank gather's ``dW``): which tile a weight
matrix takes, and the buffers a launch needs. The launch is told the number
of tiles the buffers were sized for and refuses one that differs from its
own choice.
"""

from __future__ import annotations

import torch

__all__ = ["WGRAD_TILES", "wgrad_mma_variant", "wgrad_buffers"]

WGRAD_TILES = ((32, 32), (64, 64), (128, 128))  # weight-gradient tiles, smallest first
WGRAD_WIDE_TILES = ((128, 256), (256, 128))      # the dense-z column middle's, 16 warps
WGRAD_WIDE_MAX = 640                             # its widest contraction and output


def wgrad_mma_variant(k: int, n: int) -> dict:
    """The weight-gradient tile ``wgrad_mma_kernel`` takes for one offset's
    ``k x n`` matrix. Above 128 columns (the dense-z column middle's outputs,
    at most 640 lanes and 640 columns) a 16-warp block, one warp a 32 x 64
    part: 128 x 256 where ``k ≤ 128`` (the 640-column layer: three tiles, so
    a hit's source row is gathered three times and its float32 cotangent row
    read once), else 256 x 128 (a whole 256-lane contraction: the cotangent
    row read once). Otherwise, on 8 warps (two blocks an SM), the smallest of
    32 x 32, 64 x 64 (whole in every warp, the warps split the hits) and
    128 x 128 (one warp a 32 x 64 part; larger matrices in several tiles)."""
    if k < 1 or n < 1:
        raise ValueError(f"the weight-gradient kernel needs k ≥ 1 and n ≥ 1, got {k} and {n}")
    if n > 128 and max(k, n) <= WGRAD_WIDE_MAX:
        tk, tn = WGRAD_WIDE_TILES[0] if k <= 128 else WGRAD_WIDE_TILES[1]
    else:
        tk, tn = next((t for t in WGRAD_TILES if k <= t[0] and n <= t[1]), WGRAD_TILES[-1])
    k_tiles, n_tiles = -(-k // tk), -(-n // tn)
    if k_tiles * n_tiles > 65535:
        raise ValueError(f"a {k} x {n} weight matrix has too many tiles for one launch")
    hit_split = {32: 8, 64: 4}.get(tk, 1)
    return dict(tile=(tk, tn), k_tiles=k_tiles, n_tiles=n_tiles, hit_split=hit_split)


def wgrad_buffers(offsets: int, k: int, n: int, device):
    """The weight-gradient kernel's zeroed output ``(offsets, k, n)`` float32
    and its zeroed work-queue heads (one int32 a tile and offset), as two
    views of one allocation (one memset), and the number of tiles of one
    weight matrix the heads were sized for."""
    var = wgrad_mma_variant(k, n)
    tiles = var["k_tiles"] * var["n_tiles"]
    buf = torch.zeros(offsets * k * n + offsets * tiles, dtype=torch.float32, device=device)
    return buf[: offsets * k * n].view(offsets, k, n), buf[offsets * k * n:].view(torch.int32), tiles
