"""Connected components on a batch of binary grids
(port of ``lyft3d_tpu/ops/connected_components.py``).

Iterated min-label propagation with 8-connectivity. Inputs carry an explicit
leading batch dimension, ``(B, H, W)``, where the JAX version is vmapped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["morph_open", "connected_components"]


def _plus_pool(x, op, fill: float):
    """``op`` over the pixel and its 4 neighbours; out-of-grid neighbours read ``fill``."""
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    out = x
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        out = op(out, p[:, dy : dy + x.shape[1], dx : dx + x.shape[2]])
    return out


def morph_open(mask, iterations: int = 1):
    """Binary opening of a ``(B, H, W)`` mask with the 3x3 ellipse (plus-shaped)
    structuring element, the border read as foreground by the erosion."""
    x = mask.to(torch.float32)
    for _ in range(iterations):
        x = _plus_pool(x, torch.minimum, 1.0)  # erode
    for _ in range(iterations):
        x = _plus_pool(x, torch.maximum, 0.0)  # dilate
    return x > 0.5


def connected_components(fg, sweeps: int = 64, compress_rounds: int = 0):
    """Label the 8-connected components of a boolean ``(B, H, W)`` grid.

    Returns int32 labels: each foreground pixel gets the min flat index of its
    component (a stable component id); background pixels get ``H*W``.

    The 3x3 min sweep runs as ``-max_pool2d(-labels)`` on float32 labels,
    which is exact while ``H*W < 2**24`` (112,896 for the Lyft grid); the
    pool's -inf padding reads as +inf, which never beats a label.

    Args:
        sweeps: min-pooling propagation sweeps (reach ≈ sweeps px of path
            diameter without compression).
        compress_rounds: optional pointer-jumping steps (label = label[label])
            interleaved evenly between sweep blocks.
    """
    b, h, w = fg.shape
    if h * w >= 2 ** 24:
        raise ValueError(f"grid {h}x{w} too large for exact float32 labels")
    big = float(h * w)
    flat_idx = torch.arange(h * w, device=fg.device, dtype=torch.float32).reshape(h, w)
    labels = torch.where(fg, flat_idx, big)

    def sweep_block(labels, n):
        for _ in range(n):
            neigh = -F.max_pool2d(-labels[:, None], 3, stride=1, padding=1)[:, 0]
            labels = torch.where(fg, torch.minimum(labels, neigh), big)
        return labels

    def compress(labels):
        flat = labels.reshape(b, h * w).long()
        ext = torch.cat([flat, flat.new_full((b, 1), h * w)], dim=1)
        jumped = torch.gather(ext, 1, flat.clamp(0, h * w)).reshape(b, h, w)
        return torch.where(fg, torch.minimum(labels, jumped.to(torch.float32)), big)

    if compress_rounds <= 0:
        labels = sweep_block(labels, sweeps)
    else:
        per_block = max(sweeps // (compress_rounds + 1), 1)
        for _ in range(compress_rounds):
            labels = compress(sweep_block(labels, per_block))
        labels = sweep_block(labels, per_block)
    return labels.to(torch.int32)
