#!/usr/bin/env python3
"""mAP-against-steps curves of the port's learning demos: each demo run in
a fresh work directory at 60, 150 and 300 steps (and 600 for the two sparse
middles), its final score recorded a point. The port's counterpart of
``scripts/regression_curves.py``; it writes ``tools/curves_h100.json``,
never ``docs/curves.json`` (the JAX package's TPU record).

    python3 tools/regression_curves.py [--only bev_unet,second_voxelnet]
        [--inputs build/demo_inputs] [--device cuda] [--commit SHA]

Work directories go under ``build/curves/``; a demo run may take 1,800 s.

Each point holds the steps, the mAP (for PointRCNN the BEV AP at 0.5 of
the refined boxes and of the proposals), the demo's wall seconds and its
training ms a step (``step_ms``; PointRCNN also ``rcnn_step_ms``). The file
also records the card's name and power limit (``nvidia-smi``), the torch
and CUDA versions and ``--commit`` (the code's commit, given since a copy of
the tree may hold no ``.git``). Keys of the file that ``--only`` leaves out are kept.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tools" / "curves_h100.json"
WORK = ROOT / "build" / "curves"
TIMEOUT = 1800  # seconds a demo run may take
STEPS = (60, 150, 300)
CURVES = (
    ("demo_bev_e2e.py", "bev_unet", (), STEPS),
    ("demo_second_e2e.py", "second_voxelnet", (), STEPS),
    ("demo_second_e2e.py", "second_voxelnet_sparse", ("--sparse",), STEPS + (600,)),
    # The per-voxel middle (the rank-gather kernel), which the JAX record lacks.
    ("demo_second_e2e.py", "second_voxelnet_sparse_per_voxel", ("--sparse", "--middle", "sparse"),
     STEPS + (600,)),
    ("demo_pointrcnn_e2e.py", "pointrcnn_refined", (), STEPS),
)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "no card"


def run_demo(script: str, steps: int, work: Path, extra, inputs, device, timeout: int = TIMEOUT) -> dict:
    """One demo in a fresh ``work`` directory (the trainers resume from an
    existing model directory); returns its JSON line."""
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, str(ROOT / "tools" / script), "--steps", str(steps), "--out", str(work),
           "--inputs", str(inputs), "--device", device, *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    for line in reversed(proc.stdout.strip().splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"{script} --steps {steps} printed no JSON line (exit {proc.returncode})\n"
                       f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def point_of(steps: int, r: dict) -> dict:
    point = {"steps": steps, "mAP": r.get("mAP"), "wall_s": r.get("wall_s"), "step_ms": r.get("step_ms")}
    if "ap_bev@0.5_refined" in r:
        point.update(ap_refined=r["ap_bev@0.5_refined"], ap_proposals=r["ap_bev@0.5_proposals"],
                     rcnn_step_ms=r["rcnn_step_ms"])
    return point


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, help="comma-separated curve keys to (re)run")
    ap.add_argument("--inputs", default=str(ROOT / "build" / "demo_inputs"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--commit", default=None)
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    curves = json.loads(OUT.read_text()) if OUT.exists() else {}
    curves.update(card=card_line(), torch=torch.__version__, cuda=torch.version.cuda, device=args.device,
                  commit=args.commit)
    for script, key, extra, steps_list in CURVES:
        if only is not None and key not in only:
            continue
        curves[key] = []
        for steps in steps_list:
            try:
                point = point_of(steps, run_demo(script, steps, WORK / f"{key}_{steps}", extra, args.inputs,
                                                 args.device))
            except Exception as e:  # record and keep the sweep going
                point = {"steps": steps, "error": f"{type(e).__name__}: {e}"[-1500:]}
            print(f"{key} @ {steps} steps: {json.dumps(point)}", flush=True)
            curves[key].append(point)
            OUT.write_text(json.dumps(curves, indent=2) + "\n")
    print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
    main()
