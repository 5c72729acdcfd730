"""Loss functions (port of ``lyft3d_tpu/train/losses.py``), plain tensor ops
differentiated by autograd.

- weighted CE + SIZE·BCE + SoftDice BEV segmentation loss;
- sigmoid focal classification loss, weighted smooth-L1 localization loss,
  weighted softmax CE (the SECOND / PointRCNN losses).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lyft3d_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = [
    "weighted_softmax_ce",
    "soft_dice_loss",
    "bce_with_logits",
    "bev_segmentation_loss",
    "sigmoid_focal_loss",
    "smooth_l1",
    "weighted_smooth_l1",
]


def _stable_bce(logits, targets):
    """``max(x, 0) − x·t + log1p(exp(−|x|))`` with JAX's subgradients at
    ``x = 0`` (``maximum`` 1/2, ``abs`` 1, so the log term gives −1/2), so
    that the gradient there is ``−t`` as in the JAX package, not the
    ``1 − t`` of torch's ``clamp`` and ``abs``. Logits exactly 0 are common at init, where a pixel's head
    input is all ReLU zeros."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, logits.new_zeros(())) - logits * targets + torch.log1p(torch.exp(-abs_x))


def weighted_softmax_ce(logits, labels, class_weights=None, group=None):
    """Mean softmax cross-entropy with per-class weights. ``logits``
    ``(…, C)``, ``labels`` ``(…)`` integer, ``class_weights`` ``(C,)`` or None.

    ``group`` (a data-parallel :class:`~lyft3d_tpu_torch.parallel.mesh.DataGroup`):
    the normaliser ``Σ w`` is the global batch's, summed over the ranks, and
    this rank's value is its share of the global loss times the rank count,
    so that the mean over the ranks is the global batch's loss. (A mean over
    the ranks of each rank's own ratio would be another loss.)"""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if class_weights is None:
        return -ll.mean()
    wts = torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)[labels.long()]
    if group is None:
        return -(ll * wts).sum() / torch.clamp(wts.sum(), min=1e-12)
    total = all_reduce_sum(group, wts.sum().detach())
    return -(ll * wts).sum() / (torch.clamp(total, min=1e-12) / group.size)


def bce_with_logits(logits, targets, weights=None):
    """Mean binary cross-entropy on logits (numerically stable)."""
    loss = _stable_bce(logits, targets)
    if weights is not None:
        loss = loss * weights
    return loss.mean()


def soft_dice_loss(logits, targets_onehot, eps: float = 1.0, skip_background: bool = True):
    """1 − mean soft Dice over (batch, class) on sigmoid probabilities."""
    probs = torch.sigmoid(logits)
    if skip_background:
        probs = probs[..., 1:]
        targets_onehot = targets_onehot[..., 1:]
    axes = tuple(range(1, probs.dim() - 1))
    inter = (probs * targets_onehot).sum(dim=axes)
    denom = probs.sum(dim=axes) + targets_onehot.sum(dim=axes)
    return 1.0 - ((2.0 * inter + eps) / (denom + eps)).mean()


def bev_segmentation_loss(logits, aux_logits, labels, class_weights=None, size_weight: float = 336.0,
                          group=None):
    """The UNet training objective: weighted CE + SIZE·BCE(one-hot) +
    SoftDice, plus BCE on the auxiliary image-level head against per-image
    class presence. ``logits`` ``(B, H, W, C)`` (channels last). Returns
    ``(total, components)``. Under a data-parallel ``group`` the CE's
    normaliser spans the global batch (:func:`weighted_softmax_ce`); the
    other terms are means over elements or samples, which equal shards
    average to the global value as they stand."""
    n_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n_classes).to(logits.dtype)
    ce = weighted_softmax_ce(logits, labels, class_weights, group)
    bce = bce_with_logits(logits, onehot)
    dice = soft_dice_loss(logits, onehot)
    present = (onehot.amax(dim=tuple(range(1, onehot.dim() - 1))) > 0).to(logits.dtype)
    aux = bce_with_logits(aux_logits, present)
    total = ce + size_weight * bce + dice + aux
    return total, {"ce": ce, "bce": bce, "dice": dice, "aux": aux}


def sigmoid_focal_loss(logits, targets_onehot, alpha: float = 0.25, gamma: float = 2.0, weights=None):
    """Per-element sigmoid focal loss; the caller normalises (SECOND divides
    by the positives)."""
    p = torch.sigmoid(logits)
    ce = _stable_bce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    a_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    loss = a_t * torch.pow(1.0 - p_t, gamma) * ce
    if weights is not None:
        loss = loss * weights
    return loss


def smooth_l1(diff, sigma: float = 3.0):
    """Per-element smooth L1 (Huber) with SECOND's sigma parameterisation."""
    s2 = sigma * sigma
    absd = torch.abs(diff)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * diff * diff, absd - 0.5 / s2)


def weighted_smooth_l1(pred, target, weights=None, sigma: float = 3.0, code_weights=None):
    """``(…, D)`` box-regression loss with optional per-dim and per-anchor
    weights."""
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    loss = smooth_l1(diff, sigma).sum(dim=-1)
    if weights is not None:
        loss = loss * weights
    return loss
