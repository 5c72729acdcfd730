#!/usr/bin/env python3
"""End-to-end BEV learning demo on the port: the synthetic Lyft tree →
BEV samples → train a UNet → infer → submission CSV → the official mAP.
Prints one JSON line. The port's counterpart of ``scripts/demo_bev_e2e.py``:
the same dataset (seed 123), ``unet_resnet34``, batch 4, adam 1e-3, clip 5,
overfit by design.

    python3 tools/demo_bev_e2e.py --steps 300 [--device cpu]
        [--inputs build/demo_inputs] [--out build/demo_bev]

Two routes to the same training and the same detections:

- where cv2 is installed, the JAX demo's: ``generate_bev_dataset`` into
  ``--out`` and ``train_bev``; inference reads the map raster;
- elsewhere (the card's machine has no cv2, PIL or pyyaml): the samples
  decoded beforehand (``tools/demo_inputs.py``'s ``card/bev/arrays.npz``)
  in a :class:`BEVArrayDataset`, which draws its flips and cutouts as
  ``BEVImageDataset`` does, trained by ``train_bev`` (its ``dataset_fn``);
  inference takes each sample's map channel from the same file
  (:class:`PrecomputedMapGenerator`).

The model trains in bfloat16 with float32 masters on the card, in float32
on the CPU. ``--set key=value`` overrides a field of the experiment
(``--set model=unet_reference model_kwargs.wf=3``). The last line is the JAX
demo's JSON object plus ``step_ms``, the training's wall time over its
steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import demo_inputs  # noqa: E402
from lyft3d_tpu_torch.data.bev_pipeline import BEVSampleGenerator  # noqa: E402


def experiment(steps: int, model_dir):
    """The JAX demo's ``BEVExperiment``."""
    from lyft3d_tpu_torch.config import BEVExperiment, OptimizerConfig

    return BEVExperiment(
        model="unet_resnet34",
        batch_size=4,
        class_weights=(0.2,) + (1.0,) * 9,
        optimizer=OptimizerConfig(name="adam", lr=1e-3, grad_accum=1, clip_norm=5.0, total_steps=steps),
        model_dir=str(model_dir),
    )


class BEVArrayDataset:
    """``BEVImageDataset`` over decoded arrays: ``arrays`` maps ``input``
    and ``map`` to uint8 ``(N, H, W, 3)`` and ``target`` to ``(N, H, W)``,
    in the order of ``all_tokens``. The same interface (``__len__``,
    ``assemble``, ``load``), the same values and the same hflip and cutout
    draws from the same ``RandomState``."""

    def __init__(self, arrays: Dict[str, np.ndarray], all_tokens: Sequence[str], tokens: Sequence[str],
                 with_map: bool = True, augment: bool = False, cutout_holes: int = 8, cutout_size: int = 16,
                 seed: int = 0):
        self.arrays = arrays
        row = {t: i for i, t in enumerate(all_tokens)}
        self.rows = [row[t] for t in tokens]
        self.tokens = list(tokens)
        self.with_map = with_map
        self.augment = augment
        self.cutout_holes = cutout_holes
        self.cutout_size = cutout_size
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.tokens)

    def assemble(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        xs, ys = zip(*(self.load(i) for i in idxs))
        return {"image": np.stack(xs), "label": np.stack(ys)}

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        r = self.rows[idx]
        channels = [self.arrays["input"][r].astype(np.float32) / 255.0]
        if self.with_map:
            channels.append(self.arrays["map"][r].astype(np.float32) / 255.0)
        x = np.concatenate(channels, axis=-1)
        y = self.arrays["target"][r].astype(np.int32)
        if self.augment:
            if self.rng.rand() < 0.5:  # horizontal flip
                x = x[:, ::-1].copy()
                y = y[:, ::-1].copy()
            for _ in range(self.rng.randint(0, self.cutout_holes + 1)):
                h, w = x.shape[:2]
                cy = self.rng.randint(h)
                cx = self.rng.randint(w)
                s = self.cutout_size // 2
                x[max(cy - s, 0) : cy + s, max(cx - s, 0) : cx + s] = 0.0
        return x, y


class PrecomputedMapGenerator(BEVSampleGenerator):
    """A ``BEVSampleGenerator`` whose map channel is looked up in ``maps``
    (token → float32 ``(H, W)``) instead of cropped from the map raster."""

    def __init__(self, db, cfg, maps: Dict[str, np.ndarray]):
        super().__init__(db, cfg)
        self.maps = maps

    def map_channel(self, sample_token: str) -> np.ndarray:
        return self.maps[sample_token]


def load_arrays(path) -> Tuple[Dict[str, np.ndarray], list, Dict[str, np.ndarray]]:
    """``(arrays, tokens, maps)`` of ``card/bev/arrays.npz``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in ("input", "map", "target")}
        maps = dict(zip(z["infer_tokens"].tolist(), z["infer_map"]))
        return arrays, z["tokens"].tolist(), maps


def detect_and_score(db, model, bev_cfg, tokens, classes, out: Path, maps=None):
    """The JAX demo's inference and scoring: ``BEVInferencePipeline`` (32
    components, class scores above 0.05), the submission CSV, the records
    and the official mAP; ``maps`` (token → map channel) replaces the map
    raster. Returns ``(dets, mAP, AP@0.5 a class)``."""
    from lyft3d_tpu_torch.eval.map_eval import evaluate_map, get_average_precisions
    from lyft3d_tpu_torch.eval.submission import records_from_detections, write_submission
    from lyft3d_tpu_torch.pipelines.bev import BEVInferencePipeline, gt_records

    pipe = BEVInferencePipeline(db, [model], bev_cfg, max_components=32, class_score_threshold=0.05)
    if maps is not None:
        pipe.gen = PrecomputedMapGenerator(db, bev_cfg, maps)
    dets = pipe.detect_all(tokens)
    write_submission(out / "submission.csv", dets, tokens)
    preds = records_from_detections(dets)
    gt = gt_records(db, tokens, classes=list(classes))
    overall, _ = evaluate_map(gt, preds)
    ap50 = get_average_precisions(gt, preds, list(classes), 0.5)
    return dets, float(overall), {c: round(float(a), 4) for c, a in zip(classes, ap50)}


def has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def run(steps: int, out, inputs=demo_inputs.DEFAULT_OUT, device="cuda", overrides=()) -> dict:
    """Train, infer and score; returns the JSON line's object."""
    import torch

    from lyft3d_tpu_torch.config import apply_overrides
    from lyft3d_tpu_torch.data.bev_dataset import generate_bev_dataset
    from lyft3d_tpu_torch.data.lyftdb import LyftDB
    from lyft3d_tpu_torch.pipelines.bev_train import train_bev

    t0 = time.time()
    out = Path(out)
    device = demo_inputs.torch_device(device) if isinstance(device, str) else device
    inputs = demo_inputs.ensure(inputs, "bev")
    bev_cfg = demo_inputs.bev_config(demo_inputs.load_meta(inputs))
    classes = demo_inputs.CLASSES
    cfg = apply_overrides(experiment(steps, out / "run"), list(overrides))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    log_every = max(steps // 5, 1)
    if has_cv2():  # the JAX demo's route
        root = Path(inputs) / "bev" / "lyft"
        db = LyftDB(root, root / "data")
        tokens = [s["token"] for s in db.sample]
        generate_bev_dataset(db, out / "bev", bev_cfg, tokens)
        train_kw = dict(bev_dir=out / "bev")
        maps = None
    else:
        root = demo_inputs.card_tree(inputs, "bev")
        db = LyftDB(root, root / "data")
        tokens = [s["token"] for s in db.sample]
        arrays, array_tokens, maps = load_arrays(Path(inputs) / "card" / "bev" / "arrays.npz")
        train_kw = dict(bev_dir=None, tokens=array_tokens,
                        dataset_fn=partial(BEVArrayDataset, arrays, array_tokens, with_map=cfg.with_map))
    demo_inputs.synchronize(device)
    t1 = time.time()
    _, model = train_bev(cfg, n_devices=1, log_every=log_every, eval_every=0, dtype=dtype, device=device,
                         **train_kw)
    demo_inputs.synchronize(device)
    step_ms = (time.time() - t1) * 1e3 / max(steps, 1)
    _, overall, ap50 = detect_and_score(db, model, bev_cfg, tokens, classes, out, maps)
    return {
        "demo": "bev_train_infer_map",
        "steps": steps,
        "train_samples": len(tokens),
        "mAP": round(overall, 4),
        "AP@0.5_per_class": ap50,
        "wall_s": round(time.time() - t0, 1),
        "backend": device.type,
        "step_ms": round(step_ms, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default=str(ROOT / "build" / "demo_bev"))
    ap.add_argument("--inputs", default=str(demo_inputs.DEFAULT_OUT))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="dotted overrides of the experiment")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.out, args.inputs, args.device, args.set)), flush=True)


if __name__ == "__main__":
    main()
