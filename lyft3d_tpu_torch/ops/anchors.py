"""Anchor generation (port of ``lyft3d_tpu/ops/anchors.py``).

Anchors are built with the JAX package's float32 operations in the same
order (``(arange + 0.5) · (x1 − x0) / nx + x0``), with every constant a
float32 tensor on the target device, so they are bit-equal to the JAX
anchors on any device. Anchor masks and target assignment serve training
and come with the training port.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = ["AnchorSpec", "create_anchors_3d_range", "generate_anchors"]


class AnchorSpec(NamedTuple):
    """One class's anchor config (the JAX package's ``AnchorSpec``)."""

    size: Tuple[float, float, float]  # (w, l, h)
    z_center: float
    matched_threshold: float
    unmatched_threshold: float
    rotations: Tuple[float, ...] = (0.0, 1.5707963267948966)
    class_id: int = 1  # 1-based


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def create_anchors_3d_range(
    feature_size: Tuple[int, int],
    point_range: Sequence[float],
    size: Tuple[float, float, float],
    z_center: float,
    rotations: Sequence[float] = (0.0, 1.5707963267948966),
    device=None,
):
    """(ny, nx) grid × rotations of one anchor size → ``(ny·nx·R, 7)`` float32."""
    ny, nx = feature_size
    x0, y0, x1, y1 = point_range[0], point_range[1], point_range[3], point_range[4]

    def centres(n, lo, hi):
        i = torch.arange(n, dtype=torch.float32, device=device)
        return (i + 0.5) * _f32(hi - lo, device) / _f32(n, device) + _f32(lo, device)

    gy, gx = torch.meshgrid(centres(ny, y0, y1), centres(nx, x0, x1), indexing="ij")
    rots = _f32(tuple(rotations), device)
    r = rots.shape[0]
    gx = gx[..., None].expand(ny, nx, r).reshape(-1)
    gy = gy[..., None].expand(ny, nx, r).reshape(-1)
    rot = rots.expand(ny, nx, r).reshape(-1)
    w, l, h = size
    cols = [gx, gy] + [torch.full_like(gx, float(v)) for v in (z_center, w, l, h)] + [rot]
    return torch.stack(cols, dim=-1)


def generate_anchors(
    feature_size: Tuple[int, int],
    point_range: Sequence[float],
    specs: Sequence[AnchorSpec],
    device=None,
):
    """All classes' anchors, position-major ``(ny, nx, spec, rotation)`` as
    the RPN heads flatten.

    Returns ``(anchors (A, 7), matched_thr (A,), unmatched_thr (A,),
    anchor_class (A,) int32)``.
    """
    ny, nx = feature_size
    per_spec, mt, ut, cls = [], [], [], []
    for spec in specs:
        r = len(spec.rotations)
        a = create_anchors_3d_range(
            feature_size, point_range, spec.size, spec.z_center, spec.rotations, device
        )
        per_spec.append(a.reshape(ny, nx, r, 7))
        mt += [spec.matched_threshold] * r
        ut += [spec.unmatched_threshold] * r
        cls += [spec.class_id] * r
    anchors = torch.stack(per_spec, dim=2).reshape(-1, 7)
    n_loc = ny * nx
    return (
        anchors,
        _f32(mt, device).repeat(n_loc),
        _f32(ut, device).repeat(n_loc),
        torch.tensor(cls, dtype=torch.int32, device=device).repeat(n_loc),
    )
