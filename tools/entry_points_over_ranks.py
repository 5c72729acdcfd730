#!/usr/bin/env python3
"""The four trainers' entry points over ranks, at the learning demos' sizes
on trees written with numpy alone (``chip_smoke.py``'s phase 37 trees):

- ``train_bev`` (the BEV demo's ``unet_resnet34``, batch 4, on its card-route
  dataset) and ``train_second`` (the sparse demo's unit middle, batch 4)
  write their checkpoints from rank 0 and return the state this process
  restores from the last of them;
- ``train_pointrcnn_rpn`` (batch 4, or 2 on two ranks) and
  ``train_rcnn_online`` (a frame a rank) return rank 0's model, after their
  check that every rank holds it.

Each trains ``--steps`` steps; every loss must be finite, the checkpoint of
the last step written and restored. On a card (the default) the ranks are
``min(cards, 4)`` NCCL ranks, a card each (1, 2 or 4: every batch splits),
or on one card two gloo ranks sharing it; ``--device cpu`` runs two gloo
ranks on the CPU (float32). Prints one line with the card's name and power
limit, then its JSON.

    python3 tools/entry_points_over_ranks.py [--steps 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke  # noqa: E402
import demo_bev_e2e  # noqa: E402
import demo_inputs  # noqa: E402
import demo_second_e2e  # noqa: E402


def layout(device):
    """``(ranks, backend)`` of the run on ``device``."""
    import torch

    if device.type != "cuda":
        return 2, None
    cards = torch.cuda.device_count()
    if cards == 1:
        return 2, "gloo"
    return max(d for d in (1, 2, 4) if d <= min(cards, 4)), None


def run(device, card, tmp: Path, steps: int) -> dict:
    """Each entry point over :func:`layout`'s ranks; raises where one fails
    its check. Returns each run's seconds, losses and checkpoints."""
    import torch

    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNNConfig
    from lyft3d_tpu_torch.pipelines.bev_train import train_bev
    from lyft3d_tpu_torch.pipelines.pointrcnn import KittiLoaderConfig, KittiPointRCNNLoader
    from lyft3d_tpu_torch.pipelines.pointrcnn_train import train_pointrcnn_rpn, train_rcnn_online
    from lyft3d_tpu_torch.pipelines.second_train import train_second

    k, backend = layout(device)
    kw = dict(n_devices=k, backend=backend, device=device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32  # the demos' rule
    runs = {}

    def ran(name, fn, model_dir=None):
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        losses = chip_smoke.logged_losses(model_dir) if model_dir is not None else out[1]
        if len(losses) != steps or not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"{name} over {k} ranks: losses {losses}")
        runs[name] = dict(seconds=round(seconds, 2), losses=losses)
        if model_dir is not None:
            ckpts = sorted(p.name for p in Path(model_dir).glob("model-*.ckpt"))
            if not (Path(model_dir) / "checkpoints.json").is_file() or f"model-{steps}.ckpt" not in ckpts:
                raise AssertionError(f"{name}: no checkpoint of step {steps} in {model_dir} ({ckpts})")
            if out[0].step != steps:
                raise AssertionError(f"{name}: restored step {out[0].step}, not {steps}")
            runs[name].update(checkpoints=ckpts, restored_step=out[0].step)
        return out

    db = chip_smoke.learning_tree(tmp / "lyft", seed=38)
    arrays, tokens, _ = chip_smoke.learning_bev_arrays(db, BEVConfig(**demo_inputs.BEV_CONFIG), device)
    cfg = demo_bev_e2e.experiment(steps, tmp / "bev")
    dataset_fn = functools.partial(demo_bev_e2e.BEVArrayDataset, arrays, tokens, with_map=cfg.with_map)
    ran("train_bev", lambda: train_bev(cfg, None, tokens=tokens, log_every=1, eval_every=0, dtype=dtype,
                                       dataset_fn=dataset_fn, **kw), cfg.model_dir)
    _, _, loader, stokens = demo_second_e2e.loader_of(db.data_path, demo_inputs.CLASSES)
    exp = demo_second_e2e.experiment(steps, tmp / "second", sparse=True)
    ran("train_second", lambda: train_second(exp, loader, stokens, log_every=1, dtype=dtype, **kw), exp.model_dir)
    kitti = chip_smoke.kitti_training_tree(tmp / "kitti", chip_smoke.PRC_TRAIN_FRAMES, chip_smoke.PRC_FRAME_POINTS,
                                           chip_smoke.PRC_TRAIN_CARS, seed=38)
    pcfg = PointRCNNConfig(num_proposals=32, nms_pre=128)  # the PointRCNN demo's
    ploader = KittiPointRCNNLoader(kitti, KittiLoaderConfig(num_points=4096))
    rpn, _ = ran("train_pointrcnn_rpn", lambda: train_pointrcnn_rpn(
        ploader, pcfg, steps=steps, batch_size=max(2, k), num_parts=1, **kw))
    ran("train_rcnn_online", lambda: train_rcnn_online(rpn, ploader, pcfg, steps=steps, batch_size=k, **kw))
    chip_smoke.log(f"entry points over {k} ranks ({backend or ('nccl' if device.type == 'cuda' else 'gloo')}): "
                   + "; ".join(f"{n} {r['seconds']} s, losses {[round(l, 4) for l in r['losses']]}"
                               + (f", checkpoints {r['checkpoints']} from rank 0, step {r['restored_step']} "
                                  "restored in one process" if "checkpoints" in r
                                  else ", every rank holds rank 0's model")
                               for n, r in runs.items()) + f" [{card}]")
    return {"ranks": k, "backend": backend, "steps": steps, "runs": runs, "card": card}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = demo_inputs.torch_device(args.device)
    card = chip_smoke.card_line() if device.type == "cuda" else "CPU, float32"
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(run(device, card, Path(tmp), args.steps)), flush=True)


if __name__ == "__main__":
    main()
