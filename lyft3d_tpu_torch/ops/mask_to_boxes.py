"""Segmentation mask → rotated detection boxes
(port of ``lyft3d_tpu/ops/mask_to_boxes.py``).

Threshold + opening → connected components → one oriented box per component
from an exhaustive angle sweep → per-class scores at the component centroid.
Everything is fixed-capacity (``max_components`` boxes of up to
``max_pixels`` member pixels) and batched over an explicit leading ``B``.

The results are held equal to the JAX version, so its rounding is kept where
a decision depends on it:

- one stable sort of the flat labels gives the pixel order
  ``jax.lax.sort((labels, idx), num_keys=1)`` gives, which picks the pixels
  of a component larger than ``max_pixels``;
- the angle table is cos/sin evaluated in float64 and rounded to float32
  (what XLA's float32 cos/sin return on these angles), built on the CPU so
  every device sees the same table;
- the projection onto the rotated frames, ``u = c·cos + r·sin``, rounds as
  XLA's dot does, ``fma(r, sin, round(c·cos))``: the product with the second
  term is exact in float64 and the sum is rounded once to float32. That
  keeps the argmin over the box area, which picks the angle, the same;
- ``argmin`` ties go to the first index.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from lyft3d_tpu_torch.ops.connected_components import connected_components, morph_open

__all__ = ["mask_to_rotated_boxes", "extract_detections",
           "extract_detections_from_logits"]


def _angle_table(n_angles: int, device):
    angles = torch.arange(n_angles, dtype=torch.float32) * (math.pi / 2.0 / n_angles)
    cos = torch.cos(angles.double()).float()
    sin = torch.sin(angles.double()).float()
    return angles.to(device), cos.to(device), sin.to(device)


def _project(a, b, wa, wb):
    """``a·wa + b·wb`` over a trailing angle axis, rounded as
    ``fma(b, wb, round_f32(a·wa))``."""
    first = (a[..., None] * wa).double()
    return (b[..., None].double() * wb.double() + first).float()


def mask_to_rotated_boxes(
    fg,
    max_components: int = 64,
    max_pixels: int = 1024,
    n_angles: int = 90,
    min_pixels: int = 2,
    cc_sweeps: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boolean ``(B, H, W)`` masks → up to ``max_components`` oriented boxes each.

    Returns:
        boxes_px: (B, max_components, 5) [cx, cy, w, l, angle] in pixel coords.
        valid: (B, max_components) bool.
        counts: (B, max_components) int32 pixel counts.
        centroids: (B, max_components, 2) (cx, cy) mean pixel coords.
    """
    b, h, w = fg.shape
    dev = fg.device
    k_cap = min(max_components, h * w)
    p_cap = min(max_pixels, h * w)
    labels = connected_components(fg, sweeps=cc_sweeps).reshape(b, h * w)

    # One stable sort groups each component's pixels, in pixel order.
    sorted_labels, order = torch.sort(labels, dim=1, stable=True)
    is_fg = sorted_labels < h * w
    is_new = torch.cat(
        [is_fg[:, :1], (sorted_labels[:, 1:] != sorted_labels[:, :-1]) & is_fg[:, 1:]], dim=1
    )
    rank = torch.cumsum(is_new.long(), dim=1) - 1
    n_roots = is_new.sum(dim=1)
    rank_c = torch.where(is_fg, rank.clamp(max=k_cap), k_cap)
    ks = torch.arange(k_cap, device=dev).expand(b, k_cap).contiguous()
    starts = torch.searchsorted(rank_c, ks)
    ends = torch.searchsorted(rank_c, ks, right=True)
    root_valid = ks < n_roots[:, None]
    counts = torch.where(root_valid, ends - starts, 0)

    # Each component's window of the sort permutation: (B, K, P) pixel ids.
    order_pad = torch.cat([order, order.new_zeros((b, p_cap))], dim=1)
    seg = torch.arange(p_cap, device=dev)
    idx = starts[:, :, None] + seg
    order_win = torch.gather(order_pad, 1, idx.reshape(b, -1)).reshape(b, k_cap, p_cap)
    c_all = (order_win % w).to(torch.float32) + 0.5
    r_all = (order_win // w).to(torch.float32) + 0.5
    weight = ((seg < counts[:, :, None]) & root_valid[:, :, None]).to(torch.float32)

    angles, cos, sin = _angle_table(n_angles, dev)
    u = _project(c_all, r_all, cos, sin)  # (B, K, P, A) along the angle axis
    v = _project(c_all, r_all, -sin, cos)  # perpendicular
    inv = ((1.0 - weight) * 1e9)[..., None]
    u_min = (u + inv).amin(dim=2)
    u_max = (u - inv).amax(dim=2)
    v_min = (v + inv).amin(dim=2)
    v_max = (v - inv).amax(dim=2)
    # +1: a single pixel spans one cell.
    du = u_max - u_min + 1.0  # (B, K, A)
    dv = v_max - v_min + 1.0
    k = torch.argmin(du * dv, dim=2, keepdim=True)  # (B, K, 1)

    def pick(t):
        return torch.gather(t, 2, k)[..., 0]

    ang = angles[k[..., 0]]
    cos_k, sin_k = cos[k[..., 0]], sin[k[..., 0]]
    cu = (pick(u_min) + pick(u_max)) / 2.0
    cv = (pick(v_min) + pick(v_max)) / 2.0
    cx = cos_k * cu - sin_k * cv
    cy = sin_k * cu + cos_k * cv
    boxes = torch.stack([cx, cy, pick(dv), pick(du), ang], dim=-1)  # w ⟂, l along

    wsum = weight.sum(dim=2).clamp(min=1.0)
    centroids = torch.stack(
        [(c_all * weight).sum(dim=2), (r_all * weight).sum(dim=2)], dim=-1
    ) / wsum[..., None]
    valid = root_valid & (counts >= min_pixels)
    return boxes, valid, counts.to(torch.int32), centroids


def extract_detections(
    probs,
    bg_threshold: float = 80.0 / 255.0,
    class_score_threshold: float = 0.01,
    max_components: int = 64,
    max_pixels: int = 1024,
    n_angles: int = 90,
    open_iterations: int = 1,
):
    """``(B, H, W, C)`` softmax probabilities (channel 0 = background) →
    per-(component, class) detections; see :func:`_finish_extraction`."""
    fg = (1.0 - probs[..., 0]) > bg_threshold
    return _finish_extraction(
        fg, lambda bi, ri, ci: probs[bi, ri, ci, 1:],
        class_score_threshold, max_components, max_pixels, n_angles, open_iterations,
    )


def extract_detections_from_logits(
    logits,
    bg_threshold: float = 80.0 / 255.0,
    class_score_threshold: float = 0.01,
    max_components: int = 64,
    max_pixels: int = 1024,
    n_angles: int = 90,
    open_iterations: int = 1,
):
    """:func:`extract_detections` from raw ``(B, H, W, C)`` logits, without the
    full-grid softmax: ``1 − P(bg) > t`` is ``logit_bg − logsumexp < log1p(−t)``,
    and class probabilities are read only at the component centroids."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    # log1p(-t) in float32, as the JAX version evaluates it.
    thresh = float(torch.log1p(torch.tensor(-bg_threshold, dtype=torch.float32)))
    fg = (lf[..., 0] - lse) < thresh

    def cls_probs_at(bi, ri, ci):
        return torch.softmax(lf[bi, ri, ci, :], dim=-1)[..., 1:]

    return _finish_extraction(
        fg, cls_probs_at, class_score_threshold, max_components, max_pixels,
        n_angles, open_iterations,
    )


def _finish_extraction(fg, cls_probs_at, class_score_threshold,
                       max_components, max_pixels, n_angles, open_iterations):
    """Returns a dict of fixed-shape tensors, per sample of the batch:
    boxes_px (K, 5) [cx, cy, w, l, angle] in pixels, box_valid (K,),
    counts (K,), centroids (K, 2), scores (K, C−1) class probabilities at the
    centroid pixel, detect (K, C−1) — emit this (box, class)?"""
    b, h, w = fg.shape
    fg = morph_open(fg, iterations=open_iterations)
    boxes, valid, counts, centroids = mask_to_rotated_boxes(
        fg, max_components=max_components, max_pixels=max_pixels, n_angles=n_angles
    )
    # Nearest-pixel class probabilities at the centroid (truncation, as astype).
    ci = centroids[..., 0].to(torch.int64).clamp(0, w - 1)
    ri = centroids[..., 1].to(torch.int64).clamp(0, h - 1)
    bi = torch.arange(b, device=fg.device)[:, None]
    cls_probs = cls_probs_at(bi, ri, ci)  # (B, K, C-1)
    detect = (cls_probs >= class_score_threshold) & valid[..., None]
    return {
        "boxes_px": boxes,
        "box_valid": valid,
        "counts": counts,
        "centroids": centroids,
        "scores": cls_probs,
        "detect": detect,
    }
