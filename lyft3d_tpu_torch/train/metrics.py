"""Running classification metrics as dicts of counters (port of
``lyft3d_tpu/train/metrics.py``).

Precision / recall at several thresholds and accuracy, each an ``*_init``
that makes the counters, an ``*_update`` that returns new counters with a
batch added, and a ``*_compute`` that reads them. The counters are float32
tensors on the inputs' device; no update changes its argument.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["prec_recall_init", "prec_recall_update", "prec_recall_compute",
           "accuracy_init", "accuracy_update", "accuracy_compute"]


def prec_recall_init(thresholds: Sequence[float], device=None) -> Dict[str, torch.Tensor]:
    k = len(thresholds)
    return {
        "thresholds": torch.tensor(list(thresholds), dtype=torch.float32, device=device),
        "tp": torch.zeros(k, dtype=torch.float32, device=device),
        "fp": torch.zeros(k, dtype=torch.float32, device=device),
        "fn": torch.zeros(k, dtype=torch.float32, device=device),
    }


def prec_recall_update(state, scores, labels, weights: Optional[torch.Tensor] = None):
    """``scores``: ``(…,)`` predicted foreground probability; ``labels``:
    ``(…,)`` 0/1; a prediction is positive above a threshold."""
    scores = scores.reshape(-1)
    labels = labels.reshape(-1).float()
    w = torch.ones_like(scores) if weights is None else weights.reshape(-1)
    pred = (scores[None, :] > state["thresholds"][:, None]).float()
    return {
        "thresholds": state["thresholds"],
        "tp": state["tp"] + (pred * labels[None, :] * w).sum(dim=1),
        "fp": state["fp"] + (pred * (1 - labels)[None, :] * w).sum(dim=1),
        "fn": state["fn"] + ((1 - pred) * labels[None, :] * w).sum(dim=1),
    }


def prec_recall_compute(state) -> Tuple[torch.Tensor, torch.Tensor]:
    prec = state["tp"] / torch.clamp(state["tp"] + state["fp"], min=1.0)
    rec = state["tp"] / torch.clamp(state["tp"] + state["fn"], min=1.0)
    return prec, rec


def accuracy_init(device=None) -> Dict[str, torch.Tensor]:
    return {"correct": torch.zeros((), dtype=torch.float32, device=device),
            "total": torch.zeros((), dtype=torch.float32, device=device)}


def accuracy_update(state, preds, labels, weights: Optional[torch.Tensor] = None):
    ok = (preds.reshape(-1) == labels.reshape(-1)).float()
    w = torch.ones_like(ok) if weights is None else weights.reshape(-1)
    return {"correct": state["correct"] + (ok * w).sum(), "total": state["total"] + w.sum()}


def accuracy_compute(state) -> torch.Tensor:
    return state["correct"] / torch.clamp(state["total"], min=1.0)
