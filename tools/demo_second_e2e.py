#!/usr/bin/env python3
"""End-to-end SECOND learning demo on the port: the synthetic Lyft tree →
infos → ``train_second`` (PointPillars-style pillars, or with ``--sparse``
the z-slab unit sparse middle) → ``evaluate_second`` → world-frame records
→ the official mAP. Prints one JSON line. The port's counterpart of
``scripts/demo_second_e2e.py``: the same dataset (seed 321), experiment and
hyper-parameters (adam 1.5e-3, clip 10, batch 4), overfit by design.

    python3 tools/demo_second_e2e.py --steps 300 [--sparse [--middle sparse]]
        [--device cpu] [--inputs build/demo_inputs] [--out build/demo_second]

The tree comes from ``tools/demo_inputs.py`` (built here when it is missing
and PIL is installed); the loader reads its JSON tables and lidar sweeps
with numpy alone, so the same command runs on the card's machine. The
model trains in bfloat16 with float32 masters on the card, in float32 on
the CPU. ``--middle`` picks the sparse middle under ``--sparse``:
``sparse_units`` (the production path, stencil kernel), ``sparse_columns``
(dense-z BEV columns, the same stencil kernel over 1 to 5 z chunks) or
``sparse`` (the per-voxel middle, rank-gather kernel). ``--set key=value`` overrides a
field of the experiment (the CLI's dotted overrides; the tests narrow the
RPN with it). The last line is the JAX demo's JSON object plus
``step_ms``, the training's wall time over its steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import demo_inputs  # noqa: E402

MIDDLES = ("sparse_units", "sparse_columns", "sparse")


def experiment(steps: int, model_dir, sparse: bool = False, middle: str = "sparse_units"):
    """The JAX demo's ``SecondExperiment``."""
    from lyft3d_tpu_torch.config import AnchorConfig, OptimizerConfig, SecondExperiment

    if middle not in MIDDLES:
        raise ValueError(f"middle={middle!r}: the sparse middles are {MIDDLES}")
    # --sparse: the z-slab unit middle at a scaled-down geometry (3D voxels,
    # nz 16, 1 point a voxel, the simple encoder); up-strides (8, 16, 32)
    # put the anchor grid at 1.6 m, as the pillars demo's.
    middle_kw = dict(
        voxel_size=(0.8, 0.8, 0.5), max_voxels=8192, max_points_per_voxel=1, encoder="simple",
        middle=middle, middle_z_slab=8, middle_features=(16, 32, 64),
        middle_max_voxels=(8192, 4096, 2048), rpn_up_strides=(8, 16, 32),
    ) if sparse else dict(
        voxel_size=(0.4, 0.4, 8.0), max_voxels=8192, max_points_per_voxel=8, encoder="pillars",
    )
    return SecondExperiment(
        # The synthetic scene layout: x in [-20, 84], y in [-36, 28].
        point_cloud_range=(-20.0, -36.0, -3.0, 84.0, 28.0, 5.0),
        **middle_kw,
        anchors=(
            # z centres in the sensor frame: h/2 - the 1.8 m lidar mount.
            AnchorConfig("car", (1.93, 4.76, 1.72), -0.94, 0.45, 0.3),
            AnchorConfig("bus", (2.96, 12.34, 3.44), -0.08, 0.25, 0.15),
            AnchorConfig("truck", (2.84, 10.24, 3.44), -0.08, 0.25, 0.15),
        ),
        batch_size=4,
        num_sweeps=1,
        optimizer=OptimizerConfig(name="adam", lr=1.5e-3, grad_accum=1, clip_norm=10.0, total_steps=steps),
        model_dir=str(model_dir),
    )


def loader_of(root, classes):
    """``(db, infos, loader, tokens)`` of a Lyft tree, as the JAX demo
    builds them."""
    from lyft3d_tpu_torch.data.lyftdb import LyftDB
    from lyft3d_tpu_torch.pipelines.second_pipeline import LoaderConfig, SecondSampleLoader, create_infos

    db = LyftDB(root, Path(root) / "data")
    infos = create_infos(db, num_sweeps=1, classes=list(classes))
    loader = SecondSampleLoader(db, infos, list(classes),
                                LoaderConfig(max_points=24576, num_sweeps=1, augment=True, per_object_noise=False))
    return db, infos, loader, [i["token"] for i in infos]


def score(db, preds, tokens, classes):
    """``(mAP, AP@0.5 a class)`` of world-frame records against the tree's
    boxes, with the official evaluator."""
    from lyft3d_tpu_torch.eval.map_eval import evaluate_map, get_average_precisions
    from lyft3d_tpu_torch.pipelines.bev import gt_records

    gt = gt_records(db, tokens, classes=list(classes))
    overall, _ = evaluate_map(gt, preds)
    ap50 = get_average_precisions(gt, preds, list(classes), 0.5)
    return float(overall), {c: round(float(a), 4) for c, a in zip(classes, ap50)}


def run(steps: int, out, inputs=demo_inputs.DEFAULT_OUT, sparse: bool = False, middle: str = "sparse_units",
        device="cuda", overrides=(), log_every=None, root=None) -> dict:
    """Train, predict and score; returns the JSON line's object. ``root``
    (a Lyft tree) replaces the one under ``inputs``."""
    import torch

    from lyft3d_tpu_torch.config import apply_overrides
    from lyft3d_tpu_torch.pipelines.second import evaluate_second
    from lyft3d_tpu_torch.pipelines.second_train import train_second

    t0 = time.time()
    device = demo_inputs.torch_device(device) if isinstance(device, str) else device
    if root is None:
        root = demo_inputs.card_tree(demo_inputs.ensure(inputs, "second"), "second")
    classes = demo_inputs.CLASSES
    db, _, loader, tokens = loader_of(root, classes)
    exp = apply_overrides(experiment(steps, Path(out) / "run", sparse, middle), list(overrides))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    demo_inputs.synchronize(device)
    t1 = time.time()
    state, model, vcfg = train_second(exp, loader, tokens, n_devices=1, log_every=log_every or max(steps // 5, 1),
                                      dtype=dtype, device=device)
    demo_inputs.synchronize(device)
    step_ms = (time.time() - t1) * 1e3 / max(steps, 1)
    preds = evaluate_second(model, vcfg, loader, tokens, list(classes), measure_time=True)
    overall, ap50 = score(db, preds, tokens, classes)
    return {
        "demo": "second_sparse_train_predict_map" if sparse else "second_train_predict_map",
        "steps": steps,
        "train_samples": len(tokens),
        "mAP": round(overall, 4),
        "AP@0.5_per_class": ap50,
        "num_pred_records": len(preds),
        "wall_s": round(time.time() - t0, 1),
        "backend": device.type,
        "step_ms": round(step_ms, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=str(ROOT / "build" / "demo_second"))
    ap.add_argument("--inputs", default=str(demo_inputs.DEFAULT_OUT))
    ap.add_argument("--sparse", action="store_true", help="the sparse middle (SpMiddleFHD path)")
    ap.add_argument("--middle", default="sparse_units", help="under --sparse: sparse_units, sparse_columns or sparse")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="dotted overrides of the experiment")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.out, args.inputs, args.sparse, args.middle, args.device, args.set)),
          flush=True)


if __name__ == "__main__":
    main()
