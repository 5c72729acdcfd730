"""The benchmark's files: every cell of ``BENCHMARK.json`` finds its files by
name, the manifest keeps to the benchmark's contract, the configurations
are the repo's yaml as run, and a cell and a metric added as new files are
picked up with no edit to an existing file."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

from conftest import BENCH, run_cell

ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_its_files(cell):
    spec = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    config = json.loads((BENCH / "configs" / f"{spec['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{spec['traffic']}.json").read_text())
    workload = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert (BENCH / "generators" / f"{traffic['generator']}.py").exists()
    family = _load(BENCH / "families" / f"{config['family']}.py")
    assert workload["entry"] in family.ENTRIES
    for section in ("end_to_end", "per_layer"):
        for m in MANIFEST[section]:
            if cell in m.get("workloads", [cell]):
                assert callable(_load(BENCH / "metrics" / f"{m['name']}.py").read)


def test_manifest_keeps_to_the_contract():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "h100bench/run.py"] and MANIFEST["paths"] == ["h100bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    names = list(configs) + [w["name"] for w in MANIFEST["workloads"]]
    names += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/") and (ROOT / c["file"]).exists()
        doc = json.loads((ROOT / c["file"]).read_text())
        # Every key changed from the source is listed, with the source's value beside it.
        assert c["reduced"] == doc["reduced"] == sorted(doc["departures"]) and len(c["reduced"]) <= 16
        assert c["source"] == doc["source"] and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # Each cell that reads the metric reports the end-to-end metric it moves.
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        assert sum(w in m.get("workloads", [w]) for m in MANIFEST["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in MANIFEST["per_layer"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in MANIFEST["configs"]])
def test_configuration_is_the_repo_yaml_as_run(name):
    pytest.importorskip("yaml")
    from lyft3d_tpu_torch.config import SecondExperiment, load_yaml, to_dict

    doc = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    exp = to_dict(load_yaml(SecondExperiment, ROOT / doc["yaml"]))
    for key, value in doc["experiment"].items():
        if key in exp:
            got = exp[key]
            if key == "optimizer":
                got = {k: got[k] for k in value}
            if key == "anchors":
                got = [{k: a[k] for k in value[0]} for a in got]
            assert json.loads(json.dumps(got)) == value, key


def test_a_new_cell_and_metric_are_picked_up(bench_copy):
    """A cell (configuration, traffic and workload files) and a per-layer
    metric, each a new file plus a manifest entry, run with no edit to an
    existing file of the benchmark."""
    before = {p: p.read_bytes() for p in bench_copy.rglob("*") if p.is_file()}
    cfg = json.loads((bench_copy / "configs" / "tiny_units.json").read_text())
    cfg["experiment"]["middle_max_voxels"] = [512, 256, 128]
    (bench_copy / "configs" / "added_units.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_copy / "traffic" / "tiny_lidar.json").read_text())
    (bench_copy / "traffic" / "added_lidar.json").write_text(json.dumps(dict(traffic, points=2000, pool=2)))
    (bench_copy / "workloads" / "added_infer.json").write_text(
        (bench_copy / "workloads" / "tiny_units_infer.json").read_text())
    (bench_copy / "metrics" / "calls_per_s.added.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    manifest_path = bench_copy.parent / "BENCHMARK.json"
    manifest = json.loads(manifest_path.read_text())
    manifest["configs"].append({"name": "added_units", "source": "test", "file": "h100bench/configs/added_units.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "added_infer", "config": "added_units", "traffic": "added_lidar",
                                  "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "sweeps_per_s":
            m["workloads"].append("added_infer")
    manifest["per_layer"].append({"name": "calls_per_s.added", "unit": "1/s", "better": "higher",
                                  "source": "host_clock", "layer": "entry", "moves": "sweeps_per_s",
                                  "workloads": ["added_infer"]})
    manifest_path.write_text(json.dumps(manifest))
    rc, result = run_cell(bench_copy, "added_infer", seconds=0.1, trace=1)
    assert rc == 0 and result["correct"], result
    assert result["metrics"]["calls_per_s.added"]["value"] > 0
    rc, result = run_cell(bench_copy, "added_infer", seconds=0.1, trace=0)
    assert set(result["metrics"]) == {"sweeps_per_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
