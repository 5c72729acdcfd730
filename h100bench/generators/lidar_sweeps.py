"""LiDAR-like sweeps, and ground-truth boxes on their objects, made on the
device from a seed.

A sweep (the ball-query rule's cloud of the port's ``chip_smoke.py``,
``lidar_cloud``, moved onto the device): ``ground_share`` of the points on a
ground plane at ``ground_z`` with ``ground_noise`` metres of noise, the rest
in ``objects`` Gaussian blobs (``object_spread`` metres in x, y, z) at
``object_z``. Ranges are log-uniform (ground in ``range_ground``, object
centres in ``range_objects``), so the density falls as 1 / range²: most of a
cloud lies near the sensor, as in a real sweep. Each point carries a fourth
channel, its sweep's time lag (one of ``sweeps`` sweeps, ``sweep_seconds``
apart), as the port's sample loader aggregates sweeps. The last
``invalid_share`` of the points are padding.

With ``gt_boxes`` > 0 each sample also carries that many boxes in
``gt_slots`` padded slots, centred on its first objects: a class drawn
uniformly, that class's anchor size within ±10%, its anchor height ±0.2 m,
a uniform yaw.

Every seed gives the same sizes (points, boxes, slots); only the values
change. A pool of ``pool`` distinct batches is made in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch


def _sweep_batch(t: dict, g: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, n, k = t["batch"], t["points"], t["objects"]

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    def around(count, lo, hi):
        rng = lo * (hi / lo) ** rand(b, count)
        az = rand(b, count) * (2 * math.pi)
        return rng * torch.cos(az), rng * torch.sin(az)

    n_ground = int(n * t["ground_share"])
    gx, gy = around(n_ground, *t["range_ground"])
    ground = torch.stack([gx, gy, t["ground_z"] + t["ground_noise"] * randn(b, n_ground)], -1)
    ox, oy = around(k, *t["range_objects"])
    centre = torch.stack([ox, oy, torch.full_like(ox, t["object_z"])], -1)
    which = torch.randint(0, k, (b, n - n_ground), generator=g, device=device)
    blobs = torch.gather(centre, 1, which[..., None].expand(-1, -1, 3))
    spread = torch.tensor(t["object_spread"], device=device)
    blobs = blobs + randn(b, n - n_ground, 3) * spread
    pts = torch.cat([ground, blobs], 1)
    pts = torch.gather(pts, 1, torch.argsort(rand(b, n), 1)[..., None].expand(-1, -1, 3))
    lag = torch.randint(0, t["sweeps"], (b, n, 1), generator=g, device=device).float() * t["sweep_seconds"]
    valid = (torch.arange(n, device=device) < n - int(n * t["invalid_share"])).expand(b, n).contiguous()
    return torch.cat([pts, lag], -1).contiguous(), valid, centre


def _gt_boxes(t: dict, centre, anchors: Sequence[Tuple[Sequence[float], float]], g, device):
    b, slots, count = t["batch"], t["gt_slots"], t["gt_boxes"]
    sizes = torch.tensor([a[0] for a in anchors], dtype=torch.float32, device=device)
    zs = torch.tensor([a[1] for a in anchors], dtype=torch.float32, device=device)
    cls = torch.randint(0, len(anchors), (b, count), generator=g, device=device)
    size = sizes[cls] * (0.9 + 0.2 * torch.rand(b, count, 3, generator=g, device=device))
    z = zs[cls] + (torch.rand(b, count, generator=g, device=device) - 0.5) * 0.4
    yaw = (torch.rand(b, count, generator=g, device=device) * 2 - 1) * math.pi
    boxes = torch.zeros(b, slots, 7, device=device)
    boxes[:, :count] = torch.cat([centre[:, :count, :2], z[..., None], size, yaw[..., None]], -1)
    classes = torch.zeros(b, slots, dtype=torch.int32, device=device)
    classes[:, :count] = (cls + 1).to(torch.int32)
    valid = (torch.arange(slots, device=device) < count).expand(b, slots).contiguous()
    return boxes, classes, valid


def make_pool(traffic: dict, anchors: Sequence[Tuple[Sequence[float], float]], seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` batches: ``points (B, N, 4)``, ``points_valid (B,
    N)`` and, with ``gt_boxes``, ``gt_boxes (B, S, 7)``, ``gt_classes (B, S)``
    int32 (1-based), ``gt_valid (B, S)``. ``anchors``: each class's ``(size,
    z_center)``."""
    if traffic["gt_boxes"] > min(traffic["objects"], traffic["gt_slots"]):
        raise ValueError("gt_boxes needs as many objects and slots")
    g = torch.Generator(device=device).manual_seed(seed)
    pool = []
    for _ in range(traffic["pool"]):
        pts, valid, centre = _sweep_batch(traffic, g, device)
        batch = {"points": pts, "points_valid": valid}
        if traffic["gt_boxes"]:
            batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"] = _gt_boxes(
                traffic, centre, anchors, g, device)
        pool.append(batch)
    return pool
