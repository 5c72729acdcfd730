#!/usr/bin/env python3
"""End-to-end two-stage PointRCNN learning demo on the port: the KITTI
export of a synthetic Lyft tree (cars only) → RPN training (4-part
round-robin) → online RCNN training (frozen RPN, live proposals) → the
joint net a frame at a time, where the RCNN's refined boxes are held
against the raw proposals (recall by IoU, BEV AP). Prints one JSON line.
The port's counterpart of ``scripts/demo_pointrcnn_e2e.py``: the same
dataset (seed 7), ``PointRCNNConfig(num_proposals=32, nms_pre=128)``, 4,096
points a frame, RPN batch 2 at lr 2e-3, RCNN ``max(steps // 2, 50)`` steps at
lr 1e-3.

    python3 tools/demo_pointrcnn_e2e.py --steps 300 [--device cpu]
        [--inputs build/demo_inputs] [--num-points 4096]

The KITTI tree comes from ``tools/demo_inputs.py`` (built here when it is
missing and PIL and cv2 are installed); the loader reads it with numpy
alone, so the same command runs on the card's machine. The models train in
float32, as the JAX trainers do. The JAX demo's ``LYFT3D_GRID_BQ`` has no
counterpart: the ball-query kernel is the one ``ops/pointnet2.py``'s rule
picks for each call's shape. ``--set key=value`` overrides a field of the ``PointRCNNConfig``. The last
line is the JAX demo's JSON object plus ``step_ms`` and ``rcnn_step_ms``,
each trainer's wall time over its steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import demo_inputs  # noqa: E402


def frames(joint, loader, device):
    """The joint net on every frame of ``loader``, one frame a call: the
    ground truth, proposal and refined frames of the KITTI evaluator."""
    import torch

    gt_frames, prop_frames, ref_frames = [], [], []
    joint.eval()
    for stem in loader.stems:
        s = loader.sample(stem)
        xyz, valid = (torch.from_numpy(s[k][None]).to(device) for k in ("points", "points_valid"))
        with torch.inference_mode():
            out = joint(xyz, None, valid)
        props = {k: v[0].float().cpu().numpy() if v.is_floating_point() else v[0].cpu().numpy()
                 for k, v in out["proposals"].items()}
        refined = out["refined"][0].float().cpu().numpy()
        rcnn_score = 1.0 / (1.0 + np.exp(-out["rcnn"]["cls"][0].float().cpu().numpy()))
        ok = props["roi_valid"] & ~out["roi_empty"][0].cpu().numpy()
        prop_frames.append({"boxes": props["rois"], "names": np.asarray(["car"] * len(props["rois"])),
                            "scores": np.where(props["roi_valid"], props["roi_scores"], 0.0)})
        ref_frames.append({"boxes": refined, "names": np.asarray(["car"] * len(refined)),
                           "scores": np.where(ok, rcnn_score, 0.0)})
        g = s["gt_boxes"][s["gt_valid"]]
        gt_frames.append({"boxes": g, "names": np.asarray(["car"] * len(g)),
                          "difficulty": np.zeros(len(g), np.int64)})
    return gt_frames, prop_frames, ref_frames


def run(steps: int, inputs=demo_inputs.DEFAULT_OUT, device="cuda", overrides=(), num_points: int = 4096,
        rcnn_steps=None, root=None, stage=None) -> dict:
    """Train both stages, run the joint net and score; returns the JSON
    line's object. ``rcnn_steps`` defaults to the JAX demo's ``max(steps //
    2, 50)``; ``root`` (a KITTI tree) replaces the one under ``inputs``;
    ``stage(name, fn)`` runs each of the three stages (``"rpn"``,
    ``"rcnn"``, ``"joint"``: ``fn()``) and returns its result."""
    from lyft3d_tpu_torch.config import apply_overrides
    from lyft3d_tpu_torch.eval.kitti_eval import kitti_ap, recall_at
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNN, PointRCNNConfig
    from lyft3d_tpu_torch.pipelines.pointrcnn import KittiLoaderConfig, KittiPointRCNNLoader
    from lyft3d_tpu_torch.pipelines.pointrcnn_train import (
        assemble_joint_params,
        train_pointrcnn_rpn,
        train_rcnn_online,
    )

    t0 = time.time()
    stage = stage or (lambda name, fn: fn())
    device = demo_inputs.torch_device(device) if isinstance(device, str) else device
    if root is None:
        root = demo_inputs.card_tree(demo_inputs.ensure(inputs, "pointrcnn"), "pointrcnn")
    cfg = apply_overrides(PointRCNNConfig(num_proposals=32, nms_pre=128), list(overrides))
    loader = KittiPointRCNNLoader(root, KittiLoaderConfig(num_points=num_points))
    demo_inputs.synchronize(device)
    t1 = time.time()
    rpn, losses = stage("rpn", lambda: train_pointrcnn_rpn(loader, cfg, steps=steps, batch_size=2, lr=2e-3,
                                                           device=device, n_devices=1))
    demo_inputs.synchronize(device)
    t2 = time.time()
    rcnn_steps = rcnn_steps or max(steps // 2, 50)
    rcnn, rcnn_losses = stage("rcnn", lambda: train_rcnn_online(rpn, loader, cfg, steps=rcnn_steps, lr=1e-3,
                                                                device=device, n_devices=1))
    demo_inputs.synchronize(device)
    t3 = time.time()
    joint = assemble_joint_params(PointRCNN(cfg, device=device), rpn, rcnn)
    gt_frames, prop_frames, ref_frames = stage("joint", lambda: frames(joint, loader, device))
    recalls = {}
    for t in (0.1, 0.3, 0.5, 0.7):
        recalls[f"proposal_recall@{t}"] = round(recall_at(gt_frames, prop_frames, "car", t), 4)
        recalls[f"refined_recall@{t}"] = round(recall_at(gt_frames, ref_frames, "car", t), 4)
    ap_bev = kitti_ap(gt_frames, prop_frames, "car", 0.5, "bev")
    ap_bev_ref = kitti_ap(gt_frames, ref_frames, "car", 0.5, "bev")
    return {
        "demo": "pointrcnn_two_stage_train_recall",
        "steps": steps,
        "frames": len(loader.stems),
        "num_gt": int(sum(len(g["boxes"]) for g in gt_frames)),
        "loss_first": round(float(np.mean(losses[:10])), 4),
        "loss_last": round(float(np.mean(losses[-10:])), 4),
        "rcnn_loss_first": round(float(np.mean(rcnn_losses[:10])), 4),
        "rcnn_loss_last": round(float(np.mean(rcnn_losses[-10:])), 4),
        **recalls,
        "ap_bev@0.5_proposals": round(float(ap_bev), 4),
        "ap_bev@0.5_refined": round(float(ap_bev_ref), 4),
        "wall_s": round(time.time() - t0, 1),
        "backend": device.type,
        "step_ms": round((t2 - t1) * 1e3 / max(steps, 1), 2),
        "rcnn_step_ms": round((t3 - t2) * 1e3 / rcnn_steps, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--inputs", default=str(demo_inputs.DEFAULT_OUT))
    ap.add_argument("--out", default=None, help="unused: the trainers write no files (the JAX demo's flag)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--num-points", type=int, default=4096)
    ap.add_argument("--rcnn-steps", type=int, default=None, help="default max(steps // 2, 50)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="dotted overrides of the PointRCNNConfig")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.inputs, args.device, args.set, args.num_points,
                         args.rcnn_steps)), flush=True)


if __name__ == "__main__":
    main()
