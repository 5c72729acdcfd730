"""Command-line interface of the port: ``python -m lyft3d_tpu_torch.cli <command>``.

Commands:
    infer-bev   inference → submission CSV (+ optional mAP), the same
                arguments as the JAX package's ``infer-bev``

Runs on the first CUDA card (the trunk in bfloat16, as the JAX package's
default) and fails when there is none; ``--device cpu`` is the explicit CPU
run, in float32.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _db(args):
    from lyft3d_tpu_torch.data.lyftdb import LyftDB

    return LyftDB(args.data_root, Path(args.data_root) / args.json_dir)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: torch.cuda.is_available() is false; no CUDA card is "
            "visible. Pass --device cpu to run on the CPU."
        )
    return device


def cmd_infer_bev(args):
    import torch

    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch.eval.map_eval import evaluate_map
    from lyft3d_tpu_torch.eval.submission import records_from_detections, write_submission
    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.pipelines.bev import BEVInferencePipeline, gt_records

    device = _device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    models = []
    for spec in args.model:  # "name[:model_dir]" → logit-mean ensemble
        name, _, model_dir = spec.partition(":")
        if model_dir:
            raise SystemExit(
                f"{spec!r}: restoring a model directory needs the port of "
                "train/checkpoint.py, which lyft3d_tpu_torch does not have yet; "
                "pass a bare model name to run with the default initialisation"
            )
        models.append(
            build_model(name, n_classes=10, device=device, dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
        )

    db = _db(args)
    cfg = BEVConfig(num_sweeps=args.sweeps)
    pipe = BEVInferencePipeline(db, models, cfg, device=device)
    tokens = [s["token"] for s in db.sample]
    dets = pipe.detect_all(tokens)
    write_submission(args.out, dets, tokens)
    print(f"wrote {args.out}")
    if args.eval:
        gt = gt_records(db, tokens)
        overall, per_class = evaluate_map(gt, records_from_detections(dets))
        print(json.dumps({"mAP": overall, "per_class": per_class}, indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lyft3d_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("infer-bev")
    sp.add_argument("--data-root", required=True)
    sp.add_argument("--json-dir", default="data")
    sp.add_argument("--model", nargs="+", required=True,
                    help="name[:model_dir] — multiple for an ensemble")
    sp.add_argument("--out", required=True)
    sp.add_argument("--sweeps", type=int, default=1)
    sp.add_argument("--eval", action="store_true")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (bfloat16 trunk; fails without a card) or cpu (float32)")
    sp.set_defaults(fn=cmd_infer_bev)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
