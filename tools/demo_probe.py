#!/usr/bin/env python3
"""Where the learning demos' card time goes, on one card: the BEV demo's
training step split, and the pillars demo's spread over runs.

    python3 tools/demo_probe.py [--inputs build/demo_inputs] [--runs 3]

BEV (the demo's ``unet_resnet34`` at batch 4, bfloat16 with float32
masters, adam 1e-3): one host thread's assembly of a batch from the card
form (``BEVArrayDataset``, augmentation on); then on one fixed batch, after
three warm-up steps, the ``Trainer``'s whole ``step_fn`` and forward + loss
+ backward alone, 20 times each, with the model's GroupNorm and again
without norm ops (``norm_type="folded"``). Pillars: ``--runs`` runs of
``tools/demo_second_e2e.py --steps 300`` and one of 600 steps, each a fresh
process. Prints a line each, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import demo_bev_e2e  # noqa: E402
import demo_inputs  # noqa: E402
import regression_curves  # noqa: E402

REPEATS = 20


def bev_split(inputs, card: str, tmp: Path):
    import torch

    from lyft3d_tpu_torch.pipelines.bev_train import (
        build_bev_model,
        make_bev_loss_fn,
        make_bev_optimizer_fn,
        split_tokens,
    )
    from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = demo_inputs.torch_device("cuda")
    arrays, tokens, _ = demo_bev_e2e.load_arrays(Path(inputs) / "card" / "bev" / "arrays.npz")
    cfg = demo_bev_e2e.experiment(300, tmp / "bev")
    train, _ = split_tokens(tokens, cfg.data.seed)
    ds = demo_bev_e2e.BEVArrayDataset(arrays, tokens, train, augment=True)
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        host = ds.assemble([i % len(ds) for i in range(cfg.batch_size)])
    assemble_ms = (time.perf_counter() - t0) * 1e3 / REPEATS
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / REPEATS

    for norm in ("group", "folded"):
        cfg.model_kwargs = {"norm_type": norm}
        cfg.model_dir = str(tmp / f"bev_{norm}")
        trainer = Trainer(build_bev_model(cfg, torch.bfloat16, dev), make_bev_optimizer_fn(cfg),
                          make_bev_loss_fn(cfg, dev), TrainerConfig(model_dir=cfg.model_dir, total_steps=300,
                                                                    eval_every=0, ckpt_every=0))
        state = trainer.init_or_resume()
        for _ in range(3):
            trainer.step_fn(state, batch)
        step_ms = timed(lambda: trainer.step_fn(state, batch))
        fwd_bwd_ms = timed(lambda: trainer.loss_fn(state.module, batch)[0].backward())
        print(json.dumps({"probe": "bev step", "norm_type": norm, "assemble_ms_one_thread": round(assemble_ms, 2),
                          "step_fn_ms": round(step_ms, 2), "forward_loss_backward_ms": round(fwd_bwd_ms, 2),
                          "card": card}), flush=True)
        del trainer, state


def pillars_spread(inputs, runs: int, card: str, tmp: Path):
    for i, steps in enumerate([300] * runs + [600]):
        r = regression_curves.run_demo("demo_second_e2e.py", steps, tmp / f"pillars_{i}", (), inputs, "cuda")
        print(json.dumps({"probe": "pillars run", "run": i, "steps": steps, "mAP": r["mAP"],
                          "step_ms": r["step_ms"], "wall_s": r["wall_s"], "card": card}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", default=str(demo_inputs.DEFAULT_OUT))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    card = regression_curves.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        bev_split(args.inputs, card, Path(tmp))
        pillars_spread(args.inputs, args.runs, card, Path(tmp))


if __name__ == "__main__":
    main()
