"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit), and the least time a piece of work could take on
it: bytes over the memory rate against operations over the peak rate (the
``bound`` and ``fill_bound`` arithmetic of the port's ``chip_smoke.py``)."""

from __future__ import annotations

import torch

BF16_PEAK = 989e12  # bfloat16 / float16 tensor-core operations a second
F32_PEAK = 67e12  # float32 operations a second outside the tensor cores
HBM_RATE = 3.35e12  # bytes a second


def bound(n_bytes, n_ops, peak=F32_PEAK):
    """The least seconds: ``(seconds, "bytes" or "operations")``."""
    by_bytes, by_ops = n_bytes / HBM_RATE, n_ops / peak
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fill_bound(ids, num_rows, c, size, backward):
    """The bound of the row fill (kernel B2) or, with ``backward``, of its
    backward, from masked ``(b, v)`` ids: the ids read once, the canvas
    (forward) or the rows (backward) written once, and a feature row
    (forward) or a distinct cotangent row (backward) read only for an id
    below ``num_rows``. Returns ``(seconds, which, share of ids below
    num_rows)``."""
    b, v = ids.shape
    hit = (ids >= 0) & (ids < num_rows)
    n_hit = int(hit.sum())
    if backward:
        keys = (ids.long() + torch.arange(b, device=ids.device)[:, None] * num_rows)[hit]
        read, written = int(torch.unique(keys).numel()), b * v
    else:
        read, written = n_hit, b * num_rows
    return (*bound((read + written) * c * size + 4 * b * v, 0), n_hit / max(1, b * v))
