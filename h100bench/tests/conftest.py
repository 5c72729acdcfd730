"""Fixtures of the benchmark's tests: a copy of the benchmark's directory with
small cells added as files (the harness finds them by name), and a runner
that drives ``harness.main`` on the CPU.

Tests that need the card carry the ``cuda`` marker and skip inside the test
where there is none.
"""

from __future__ import annotations

import copy
import io
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH.parent))

SMALL_CELLS = {
    # cell: (config, traffic, entry)
    "tiny_pillars_infer": ("tiny_pillars", "tiny_lidar", "infer"),
    "tiny_pillars_train": ("tiny_pillars", "tiny_lidar_gt", "train"),
    "tiny_units_infer": ("tiny_units", "tiny_lidar", "infer"),
    "tiny_units_train": ("tiny_units", "tiny_lidar_gt", "train"),
}


def _write(path: Path, doc):
    path.write_text(json.dumps(doc, indent=1) + "\n")


def small_files(base: Path):
    """Small configurations (the published widths on small grids), traffic
    and cells, as files beside the real ones."""
    pillars = json.loads((base / "configs" / "second_pillars_lyft9.json").read_text())
    e = pillars["experiment"]
    e.update(point_cloud_range=[-12.8, -12.8, -5.0, 12.8, 12.8, 3.0], voxel_size=[0.4, 0.4, 8.0],
             max_voxels=600, max_points_per_voxel=8)
    # The sparse family: the yaml's z-slab unit middle of 0.05 x 0.05 x 0.2 m
    # voxels (16/32/64 features) under the same RPN, on a small grid.
    units = copy.deepcopy(pillars)
    e = units["experiment"]
    e.update(point_cloud_range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], voxel_size=[0.1, 0.1, 0.2],
             max_voxels=1500, max_points_per_voxel=1, block_filtering=True, encoder="simple",
             middle="sparse_units", middle_max_voxels=[1024, 512, 256], rpn_up_strides=[1, 2, 4])
    # The CPU has no bfloat16 antialiased resize: the small cells run float32.
    pillars["dtype"] = units["dtype"] = "float32"
    _write(base / "configs" / "tiny_pillars.json", pillars)
    _write(base / "configs" / "tiny_units.json", units)
    traffic = json.loads((base / "traffic" / "lidar_gt_64x262k.json").read_text())
    traffic.update(batch=2, points=3000, pool=4, range_ground=[1.0, 6.0], range_objects=[1.5, 6.0],
                   gt_boxes=8, objects=8)
    _write(base / "traffic" / "tiny_lidar_gt.json", traffic)
    _write(base / "traffic" / "tiny_lidar.json", dict(traffic, gt_boxes=0))
    infer = {"entry": "infer", "check_sweeps": 2, "check_from_calls": 2, "warmup_calls": 1,
             "limits": {"maps_gap": 0.05, "detection_mismatches": 0}}
    train = {"entry": "train", "limits": {"maps_gap": 0.05, "loss_gap": 0.02, "grad_gap": 0.02, "step_gap": 0.2,
                                          "loss_heads_gap": 1e-4}}
    for cell, (_, _, entry) in SMALL_CELLS.items():
        _write(base / "workloads" / f"{cell}.json", infer if entry == "infer" else train)
    manifest = json.loads((base.parent / "BENCHMARK.json").read_text()) if (base.parent / "BENCHMARK.json").exists() \
        else json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest = copy.deepcopy(manifest)
    for cell, (config, traffic_name, entry) in SMALL_CELLS.items():
        manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic_name, "chips": 1,
                                      "why": "a small cell for the CPU tests"})
        kinds = ("sweeps_per_s",) if entry == "infer" else ("train_samples_per_s",)
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m and (m["name"] in kinds or m["name"].endswith("." + entry)):
                m["workloads"].append(cell)
    _write(base.parent / "BENCHMARK.json", manifest)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark's directory (``<tmp>/h100bench``) with the
    small cells, and its ``BENCHMARK.json`` beside it."""
    base = tmp_path / "h100bench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    small_files(base)
    return base


def run_cell(base: Path, cell: str, seed: int = 7, seconds: float = 0.5, trace: int = 0, fault=None):
    """``harness.main`` on the CPU; returns ``(exit code, result or None)``."""
    import torch

    from h100bench import harness

    out = io.StringIO()
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
            "--manifest", str(base.parent / "BENCHMARK.json")]
    if fault:
        argv += ["--fault", fault]
    rc = harness.main(argv, device=torch.device("cpu"), out=out, base=base)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
