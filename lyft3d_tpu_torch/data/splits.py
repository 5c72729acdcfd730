"""Deterministic scene splits.

Capability of the reference's split scripts
(``generating-dataset/generate-lyft-train-val-secnes.py:7-51``: shuffle scene
names with a fixed seed, 5/6 train + 1/6 val; the ``*-kitti`` variant
additionally splits train into 4 round-robin parts and blacklists known-bad
samples).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["train_val_split", "split_parts"]


def train_val_split(
    scene_names: Sequence[str], val_fraction: float = 1.0 / 6.0, seed: int = 42
) -> Dict[str, List[str]]:
    """Shuffle scene names with ``seed``; last ``val_fraction`` become val."""
    names = list(scene_names)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(names))
    n_val = max(int(round(len(names) * val_fraction)), 1) if names else 0
    shuffled = [names[i] for i in perm]
    return {
        "train": sorted(shuffled[: len(names) - n_val]),
        "val": sorted(shuffled[len(names) - n_val :]),
    }


def split_parts(items: Sequence[str], num_parts: int = 4) -> List[List[str]]:
    """Round-robin partition of a list (PointRCNN's 4-part training split)."""
    parts: List[List[str]] = [[] for _ in range(num_parts)]
    for i, item in enumerate(items):
        parts[i % num_parts].append(item)
    return parts
