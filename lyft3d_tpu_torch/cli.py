"""Command-line interface of the port: ``python -m lyft3d_tpu_torch.cli <command>``.

Commands (the JAX package's 13, with its arguments, plus ``--device``):
    synth-data      generate a synthetic Lyft-format dataset (host only; PIL)
    generate-bev    rasterize BEV PNGs from a Lyft DB (host only; cv2)
    train-bev       train a BEV segmentation model
    run-experiments train a queue of BEV configs, surviving failed jobs
    infer-bev       inference → submission CSV (+ optional mAP)
    create-infos    build SECOND training infos from a Lyft DB (host only)
    create-gtdb     build the copy-paste GT database (host only)
    train-second    train the voxelnet detector
    train-pointrcnn train PointRCNN's RPN, then its RCNN online or offline
    serve           the dataset/detection viewer over HTTP
    eval-map        score a submission CSV with the official Lyft mAP (host only)
    export-kitti    write a KITTI-layout dataset (host only; cv2)
    import-weights  a torch backbone checkpoint → a snapshot of the named model
                    (host only)

Device commands run on the first CUDA card (``train-bev`` and
``train-second`` on every card, below), the trunk in bfloat16, as the JAX
package's default (PointRCNN trains in float32, as the JAX trainers do), and
fail when there is none; ``--device cpu`` is the explicit CPU run, in
float32. Reading a ``--config`` yaml needs pyyaml.

``train-bev`` and ``train-second`` train data-parallel over every visible
card, as the JAX CLI trains over every chip: the largest count of cards that
divides the batch size, one process a card (NCCL), each loading its slice of
every global batch. ``train-pointrcnn`` trains on one card, and ``--device
cpu`` is always one process.
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


def cmd_synth_data(args):
    from lyft3d_tpu_torch.data.synthetic import make_synthetic_lyft

    root = make_synthetic_lyft(args.out, num_scenes=args.scenes, samples_per_scene=args.samples,
                               seed=args.seed)
    print(f"synthetic dataset at {root}")


def cmd_generate_bev(args):
    from lyft3d_tpu_torch.data.bev_dataset import generate_bev_dataset
    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig

    done = generate_bev_dataset(_db(args), args.out, BEVConfig(num_sweeps=args.sweeps),
                                overwrite=args.overwrite)
    print(f"generated {len(done)} samples into {args.out}")


def _train_dtype(device):
    import torch

    return torch.bfloat16 if device.type == "cuda" else torch.float32


def cmd_train_bev(args):
    from lyft3d_tpu_torch.config import BEVExperiment, apply_overrides, load_yaml
    from lyft3d_tpu_torch.pipelines.bev_train import train_bev

    device = _device(args.device)
    cfg = load_yaml(BEVExperiment, args.config) if args.config else BEVExperiment()
    if args.set:
        cfg = apply_overrides(cfg, args.set)
    if args.model_dir:
        cfg.model_dir = args.model_dir
    train_bev(cfg, args.bev_dir, dtype=_train_dtype(device), device=device)


def cmd_run_experiments(args):
    """Sequential experiment queue over BEV config files: run each
    (config, model_dir) job, keep going after a failed one, record outcomes."""
    import time
    import traceback

    from lyft3d_tpu_torch.config import BEVExperiment, apply_overrides, load_yaml
    from lyft3d_tpu_torch.pipelines.bev_train import train_bev

    device = _device(args.device)
    results = []
    for cfg_path in args.configs:
        t0 = time.time()
        rec = {"config": str(cfg_path)}
        try:
            cfg = load_yaml(BEVExperiment, cfg_path)
            if args.set:
                cfg = apply_overrides(cfg, args.set)
            rec["model_dir"] = cfg.model_dir
            state, _ = train_bev(cfg, args.bev_dir, dtype=_train_dtype(device), device=device)
            rec.update(status="ok", steps=int(state.step))
        except Exception as e:  # keep the queue going
            traceback.print_exc()
            rec.update(status="failed", error=f"{type(e).__name__}: {e}")
        rec["wall_s"] = round(time.time() - t0, 1)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(results, f, indent=2)
        print(f"summary → {args.summary}")


def cmd_infer_bev(args):
    import torch

    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch.eval.map_eval import evaluate_map
    from lyft3d_tpu_torch.eval.submission import records_from_detections, write_submission
    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.pipelines.bev import BEVInferencePipeline, gt_records
    from lyft3d_tpu_torch.train import checkpoint as ckpt

    device = _device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    models = []
    for spec in args.model:  # "name[:model_dir]" → logit-mean ensemble
        name, _, model_dir = spec.partition(":")
        model = build_model(name, n_classes=10, device=device, dtype=dtype,
                            generator=torch.Generator().manual_seed(0))
        if model_dir:  # the latest checkpoint, if any; else the initialisation
            snapshot, step = ckpt.restore_latest(model_dir)
            if step is not None:
                ckpt.load_trained_weights(model, snapshot)
                print(f"{name}: restored step {step} from {model_dir}")
        models.append(model)

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


def cmd_create_infos(args):
    from lyft3d_tpu_torch.pipelines.second_pipeline import create_infos, save_infos

    infos = create_infos(_db(args), num_sweeps=args.sweeps)
    save_infos(infos, args.out)
    print(f"wrote {len(infos)} infos to {args.out}")


def cmd_create_gtdb(args):
    from lyft3d_tpu_torch.data.augment import create_gt_database
    from lyft3d_tpu_torch.pipelines.second_pipeline import (
        LoaderConfig,
        SecondSampleLoader,
        load_infos,
    )

    infos = load_infos(args.infos)
    loader = SecondSampleLoader(
        _db(args), infos, args.classes.split(","), LoaderConfig(num_sweeps=1, augment=False)
    )
    samples = [
        {"points": loader.load_points(info), "gt_boxes": info["gt_boxes"], "gt_names": info["gt_names"]}
        for info in infos
    ]
    create_gt_database(args.out, samples)
    print(f"gt database at {args.out}")


def cmd_train_second(args):
    from lyft3d_tpu_torch.config import SecondExperiment, apply_overrides, load_yaml
    from lyft3d_tpu_torch.pipelines.second_pipeline import (
        LoaderConfig,
        SecondSampleLoader,
        load_infos,
    )
    from lyft3d_tpu_torch.pipelines.second_train import train_second

    device = _device(args.device)
    exp = load_yaml(SecondExperiment, args.config) if args.config else SecondExperiment()
    if args.set:
        exp = apply_overrides(exp, args.set)
    infos = load_infos(args.infos)
    class_names = [a.class_name for a in exp.anchors]
    db_sampler = None
    if args.gtdb and exp.db_sampler_quota:
        from lyft3d_tpu_torch.data.augment import DataBaseSampler, GTDatabase

        db_sampler = DataBaseSampler(GTDatabase(args.gtdb), exp.db_sampler_quota)
    loader = SecondSampleLoader(
        _db(args), infos, class_names,
        LoaderConfig(num_sweeps=exp.num_sweeps, max_points=exp.data.max_points),
        db_sampler=db_sampler,
    )
    train_second(exp, loader, [i["token"] for i in infos], dtype=_train_dtype(device), device=device)


def cmd_train_pointrcnn(args):
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNNConfig, lyft_pointrcnn_config
    from lyft3d_tpu_torch.pipelines.pointrcnn import KittiLoaderConfig, KittiPointRCNNLoader
    from lyft3d_tpu_torch.pipelines.pointrcnn_train import (
        cache_rcnn_samples,
        train_pointrcnn_rpn,
        train_rcnn_offline,
        train_rcnn_online,
    )

    device = _device(args.device)
    classes = tuple(args.classes.split(","))
    loader = KittiPointRCNNLoader(
        args.kitti_root,
        KittiLoaderConfig(num_points=args.num_points, classes=classes, augment=args.augment),
    )
    # One class per run: the first --classes entry selects the mean size the
    # coders regress against.
    cfg = lyft_pointrcnn_config("train", class_name=classes[0]) if args.preset == "lyft" else PointRCNNConfig()
    rpn, losses = train_pointrcnn_rpn(loader, cfg, steps=args.steps, batch_size=args.batch_size,
                                      device=device)
    print(f"final rpn loss: {losses[-1]:.4f}")
    if args.mode == "rcnn_offline":
        # Staged training: the frozen RPN's proposals and features cached,
        # then the RCNN trained on the cache.
        cache = cache_rcnn_samples(rpn, loader, cfg)
        _, rcnn_losses = train_rcnn_offline(cache, cfg, steps=args.rcnn_steps, device=device)
        print(f"final rcnn loss: {rcnn_losses[-1]:.4f}")
    elif args.mode == "rcnn":
        # Online: the frozen RPN runs every step, live proposals with RoI noise.
        _, rcnn_losses = train_rcnn_online(rpn, loader, cfg, steps=args.rcnn_steps, device=device)
        print(f"final rcnn loss: {rcnn_losses[-1]:.4f}")


def cmd_serve(args):
    from lyft3d_tpu_torch.serve.viewer import serve

    serve(args.port, _device(args.device))


def cmd_eval_map(args):
    from lyft3d_tpu_torch.eval.map_eval import evaluate_map
    from lyft3d_tpu_torch.eval.submission import read_submission, records_from_detections
    from lyft3d_tpu_torch.pipelines.bev import gt_records

    db = _db(args)
    preds = records_from_detections(read_submission(args.submission))
    tokens = sorted({p["sample_token"] for p in preds}) or [s["token"] for s in db.sample]
    overall, per_class = evaluate_map(gt_records(db, tokens), preds)
    print(json.dumps({"mAP": overall, "per_class": per_class}, indent=2))


def cmd_export_kitti(args):
    from lyft3d_tpu_torch.data.kitti import export_kitti

    out = export_kitti(_db(args), args.out)
    print(f"KITTI tree at {out}")


def cmd_import_weights(args):
    """Torch ImageNet checkpoint → a snapshot of the named model with the
    backbone's weights copied in (the reference's transfer-learning path,
    modelzoo hub weights → models/model.py:50-60 load_pretrain). The snapshot
    is a float32 ``state_dict`` with no masters, registered under the model's
    name (what ``train-bev --set init_from=<out>`` reads) and under
    ``model`` (what ``infer-bev <model>:<out>`` reads)."""
    import torch

    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.train import checkpoint as ckpt
    from lyft3d_tpu_torch.utils.torch_import import load_pretrained_backbone, load_torch_state_dict

    sd = load_torch_state_dict(args.torch_ckpt)
    model_name = args.model or f"unet_{args.backbone}"
    model = build_model(model_name, n_classes=args.n_classes, in_features=args.in_channels,
                        generator=torch.Generator().manual_seed(0))
    load_pretrained_backbone(model, sd, args.backbone, in_channels=args.in_channels, verbose=True)
    snapshot = {"model": model.state_dict(), "masters": []}
    path = ckpt.save(args.out, snapshot, name=model_name)
    ckpt.save(args.out, snapshot, name="model")
    print(f"imported {args.backbone} weights → {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lyft3d_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def add_db_args(sp):
        sp.add_argument("--data-root", required=True)
        sp.add_argument("--json-dir", default="data")

    def add_device_arg(sp):
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (bfloat16 trunk; fails without a card) or cpu (float32)")

    sp = sub.add_parser("synth-data")
    sp.add_argument("--out", required=True)
    sp.add_argument("--scenes", type=int, default=2)
    sp.add_argument("--samples", type=int, default=3)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("generate-bev")
    add_db_args(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--sweeps", type=int, default=1)
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(fn=cmd_generate_bev)

    data_parallel = ("data-parallel over every visible card: one process a card, the largest card "
                     "count that divides the batch size (--device cpu: one process)")
    sp = sub.add_parser("train-bev", help="train a BEV segmentation model, " + data_parallel)
    sp.add_argument("--bev-dir", required=True)
    sp.add_argument("--config")
    sp.add_argument("--model-dir")
    sp.add_argument("--set", nargs="*", default=[])
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_train_bev)

    sp = sub.add_parser("run-experiments")
    sp.add_argument("--bev-dir", required=True)
    sp.add_argument("--configs", nargs="+", required=True)
    sp.add_argument("--set", nargs="*", default=None, help="overrides applied to every config")
    sp.add_argument("--summary", default=None, help="summary JSON path")
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_run_experiments)

    sp = sub.add_parser("infer-bev")
    add_db_args(sp)
    sp.add_argument("--model", nargs="+", required=True,
                    help="name[:model_dir] — multiple for an ensemble")
    sp.add_argument("--out", required=True)
    sp.add_argument("--sweeps", type=int, default=1)
    sp.add_argument("--eval", action="store_true")
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_infer_bev)

    sp = sub.add_parser("create-infos")
    add_db_args(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--sweeps", type=int, default=10)
    sp.set_defaults(fn=cmd_create_infos)

    sp = sub.add_parser("create-gtdb")
    add_db_args(sp)
    sp.add_argument("--infos", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--classes", default="car,truck,bus")
    sp.set_defaults(fn=cmd_create_gtdb)

    sp = sub.add_parser("train-second", help="train the voxelnet detector, " + data_parallel)
    add_db_args(sp)
    sp.add_argument("--infos", required=True)
    sp.add_argument("--gtdb", help="GT database dir for copy-paste augmentation")
    sp.add_argument("--config")
    sp.add_argument("--set", nargs="*", default=[])
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_train_second)

    sp = sub.add_parser("train-pointrcnn")
    sp.add_argument("--kitti-root", required=True)
    sp.add_argument("--num-points", type=int, default=16384)
    sp.add_argument("--classes", default="car")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--batch-size", type=int, default=2)
    sp.add_argument("--mode", choices=("rpn", "rcnn", "rcnn_offline"), default="rpn")
    sp.add_argument("--rcnn-steps", type=int, default=100)
    sp.add_argument("--preset", choices=("tiny", "lyft"), default="tiny",
                    help="lyft = the reference capacities (lyft_pointrcnn_config('train'))")
    sp.add_argument("--augment", action="store_true",
                    help="scene-level flip/rotation/scaling augmentation")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (fails without a card) or cpu; float32 on both")
    sp.set_defaults(fn=cmd_train_pointrcnn)

    sp = sub.add_parser("serve")
    sp.add_argument("--port", type=int, default=16666)
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("eval-map")
    add_db_args(sp)
    sp.add_argument("--submission", required=True)
    sp.set_defaults(fn=cmd_eval_map)

    sp = sub.add_parser("export-kitti")
    add_db_args(sp)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export_kitti)

    sp = sub.add_parser("import-weights")
    sp.add_argument("--torch-ckpt", required=True)
    sp.add_argument("--backbone", required=True)
    sp.add_argument("--model", default=None)
    sp.add_argument("--out", required=True)
    sp.add_argument("--n-classes", type=int, default=10)
    sp.add_argument("--in-channels", type=int, default=6)
    sp.add_argument("--image-size", type=int, default=336,
                    help="the JAX CLI's init shape; the port's modules build without one")
    sp.set_defaults(fn=cmd_import_weights)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
