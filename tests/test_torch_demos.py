"""The port's learning demos (``tools/demo_*_e2e.py``) and the config
snapshot they write, on the CPU at a tiny size:

(a) ``save_yaml`` where pyyaml is missing writes the bytes pyyaml writes, and
    ``load_yaml`` reads them back to the same experiment;
(b) each demo's card route (no cv2, PIL or pyyaml) runs end to end and
    prints the JAX demo's JSON keys (``scripts/demo_bev_e2e.py:74-83``,
    ``demo_second_e2e.py:108-120``, ``demo_pointrcnn_e2e.py:133-149``);
(c) the BEV card route equals the PNG route: batches with augmentation on,
    ``train_bev``'s parameters after two float32 steps on either dataset,
    detections.
"""

import copy
import json
import math
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import demo_bev_e2e  # noqa: E402
import demo_inputs  # noqa: E402

from lyft3d_tpu_torch.config import (  # noqa: E402
    BEVExperiment,
    SecondExperiment,
    dump_yaml,
    load_yaml,
    save_yaml,
    to_dict,
)

BLOCKED = "import sys\nfor m in ('cv2', 'PIL', 'yaml'):\n    sys.modules[m] = None\n"
NARROW_BEV = ["model=unet_reference", "model_kwargs.wf=3", "model_kwargs.depth=1", "batch_size=2"]
NARROW_SECOND = ["rpn_layer_nums=[1,1,1]", "rpn_filters=[8,8,8]", "rpn_up_filters=[8,8,8]",
                 "voxel_size=[0.8,0.8,8.0]"]
NARROW_PRC = ["sa_npoints=[64,32,16,8]", "sa_widths=[8,8,8,8]", "fp_width=8"]
JAX_KEYS = {
    "bev": {"demo", "steps", "train_samples", "mAP", "AP@0.5_per_class", "wall_s", "backend"},
    "second": {"demo", "steps", "train_samples", "mAP", "AP@0.5_per_class", "num_pred_records", "wall_s",
               "backend"},
    "pointrcnn": {"demo", "steps", "frames", "num_gt", "loss_first", "loss_last", "rcnn_loss_first",
                  "rcnn_loss_last", "ap_bev@0.5_proposals", "ap_bev@0.5_refined", "wall_s", "backend"}
    | {f"{k}_recall@{t}" for k in ("proposal", "refined") for t in (0.1, 0.3, 0.5, 0.7)},
}
EXTRA_KEYS = {"bev": {"step_ms"}, "second": {"step_ms"}, "pointrcnn": {"step_ms", "rcnn_step_ms"}}


def _python(code, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def _configs():
    cases = [("BEVExperiment", BEVExperiment()), ("SecondExperiment", SecondExperiment())]
    for path in sorted((REPO / "configs").glob("*.yaml")):
        cls = BEVExperiment if path.name.startswith("bev") else SecondExperiment
        cases.append((cls.__name__, load_yaml(cls, path)))
    return cases


def test_snapshot_without_pyyaml_is_pyyaml_bytes(tmp_path):
    """(a) The defaults of both experiments and the three ``configs/*.yaml``:
    ``snapshot_config`` with pyyaml blocked writes pyyaml's bytes, which
    ``load_yaml`` reads back to the same dataclass."""
    cases = _configs()
    assert len(cases) == 5
    spec = [(name, to_dict(cfg), str(tmp_path / str(i))) for i, (name, cfg) in enumerate(cases)]
    code = BLOCKED + f"""
import json
from lyft3d_tpu_torch import config
for name, data, out in json.loads({json.dumps(json.dumps(spec))}):
    cfg = config.from_dict(getattr(config, name), data)
    config.snapshot_config(cfg, out)
assert sys.modules["yaml"] is None
print("ok")
"""
    assert _finish(_python(code)).strip() == "ok"
    for i, (_, cfg) in enumerate(cases):
        written = (tmp_path / str(i) / "experiment.yaml").read_text()
        assert written == yaml.safe_dump(to_dict(cfg), sort_keys=False)
        assert load_yaml(type(cfg), tmp_path / str(i) / "experiment.yaml") == cfg
        # and the same file where pyyaml imports
        assert save_yaml(cfg, tmp_path / f"{i}.yaml").read_text() == written


AWKWARD = [
    "", " lead", "trail ", "yes", "No", "null", "~", "1.5", "012", "0x1F", "1_000", "2001-12-14", "<<", "=",
    "-", "- item", "---", "a: b", "a #b", "#c", "'quoted'", 'say "hi"', "tab\there", "line\nbreak",
    "x" * 100 + " " + "y" * 30, "word " * 40, "runs/bev seresnext101 map", "é", "\x85", " ", "🙂",
]


@pytest.mark.parametrize("value", AWKWARD + [1e-5, 1e16, -0.0, 1 / 3, math.inf, -math.inf, math.nan, True, None,
                                             10 ** 20, [], {}, [[1, [2]], {"k": []}]])
def test_dump_yaml_matches_pyyaml(value):
    """``dump_yaml`` against pyyaml on scalars that need quotes, escapes, a
    line fold or a float's spelling, at the root, in lists and in maps."""
    v = lambda: copy.deepcopy(value)  # noqa: E731  (no object twice: to_dict shares none, pyyaml would alias it)
    for data in ({"model_dir": v(), "nested": {"list": [v(), [v()]], "after": 1}}, [v(), {"k": v()}], v()):
        assert dump_yaml(data) == yaml.safe_dump(data, sort_keys=False)


@pytest.fixture(scope="module")
def tiny_inputs(tmp_path_factory):
    return demo_inputs.build(tmp_path_factory.mktemp("demo_inputs"), tiny=True)


def test_card_routes_run_without_image_libraries(tiny_inputs, tmp_path):
    """(b) The three demos' card routes, 2 steps each on narrow models, in
    processes where cv2, PIL and pyyaml cannot be imported: each prints the
    JAX demo's JSON keys (and its training ms a step) and writes what it
    should."""
    common = ["--steps", "2", "--device", "cpu", "--inputs", str(tiny_inputs)]
    runs = {
        "bev": ("demo_bev_e2e.py", ["--out", str(tmp_path / "bev"), "--set", *NARROW_BEV]),
        "second": ("demo_second_e2e.py", ["--out", str(tmp_path / "second"), "--set", *NARROW_SECOND]),
        "pointrcnn": ("demo_pointrcnn_e2e.py", ["--num-points", "1024", "--rcnn-steps", "2",
                                                "--set", *NARROW_PRC]),
    }
    # The SECOND test's NMS takes the 100 best boxes of a class, not 1,000:
    # the plain rotated IoU of an untrained head's boxes on the CPU is its cost.
    fewer_boxes = ("from lyft3d_tpu_torch.pipelines import second_train\n"
                   "make = second_train.voxelnet_config_from_experiment\n"
                   "second_train.voxelnet_config_from_experiment = lambda exp: make(exp, nms_pre=100)\n")
    procs = {}
    for family, (script, args) in runs.items():
        argv = [script, *common, *args]
        # Three processes side by side, two threads each.
        procs[family] = _python(BLOCKED + f"import torch\ntorch.set_num_threads(2)\nsys.argv = {argv!r}\n"
                                + (fewer_boxes if family == "second" else "") + "import runpy\n"
                                f"runpy.run_path({str(REPO / 'tools' / script)!r}, run_name='__main__')\n")
    for family, proc in procs.items():
        line = json.loads(_finish(proc).strip().splitlines()[-1])
        assert set(line) == JAX_KEYS[family] | EXTRA_KEYS[family], family
        assert line["backend"] == "cpu" and line["steps"] == 2
        assert all(math.isfinite(line[k]) for k in line if k.endswith("_ms") or k.startswith("loss"))
    for family in ("bev", "second"):
        run = tmp_path / family / "run"
        assert (run / "experiment.yaml").read_text().startswith(
            "model: unet_reference\n" if family == "bev" else "point_cloud_range:\n")
        assert (run / "checkpoints.json").exists() and list(run.glob("model-*.ckpt"))
    assert (tmp_path / "bev" / "submission.csv").exists()


def _png_dataset(inputs, tokens, augment):
    from lyft3d_tpu_torch.data.bev_dataset import BEVImageDataset

    return BEVImageDataset(Path(inputs) / "bev" / "png", tokens, augment=augment)


def test_array_dataset_equals_png_dataset(tiny_inputs):
    """(c) ``BEVArrayDataset`` over the decoded arrays gives the PNG
    dataset's batches, augmentation on (the same draws from the same seed)."""
    arrays, tokens, _ = demo_bev_e2e.load_arrays(Path(tiny_inputs) / "card" / "bev" / "arrays.npz")
    png = _png_dataset(tiny_inputs, tokens, augment=True)
    card = demo_bev_e2e.BEVArrayDataset(arrays, tokens, tokens, augment=True)
    flips = 0
    for take in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 1, 2, 0], [0, 2, 3, 1]):
        a, b = png.assemble(take), card.assemble(take)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        flips += int(not np.array_equal(b["label"], card.arrays["target"][take].astype(np.int32)))
    assert flips, "no batch was augmented"
    plain = demo_bev_e2e.BEVArrayDataset(arrays, tokens, tokens[1:])
    x, y = plain.load(0)
    xp, yp = _png_dataset(tiny_inputs, tokens[1:], augment=False).load(0)
    assert np.array_equal(x, xp) and np.array_equal(y, yp)


def _narrow(model_dir):
    from lyft3d_tpu_torch.config import apply_overrides

    return apply_overrides(demo_bev_e2e.experiment(2, model_dir), NARROW_BEV)


def test_card_loop_and_map_equal_png_route(tiny_inputs, tmp_path):
    """(c) Two float32 steps of ``train_bev`` on the card route's dataset
    equal its two on the PNGs (one loader thread, so the draws keep their order), and the
    precomputed map channel gives the detections of the map raster. (The
    synthetic map raster is drawn at 0.5 m a pixel and read at the BEV
    config's 0.1, so the demos' crops are zeros, the JAX demo's too.)"""
    from lyft3d_tpu_torch.data.lyftdb import LyftDB
    from lyft3d_tpu_torch.pipelines.bev import BEVInferencePipeline
    from lyft3d_tpu_torch.pipelines.bev_train import build_bev_model, train_bev

    arrays, tokens, maps = demo_bev_e2e.load_arrays(Path(tiny_inputs) / "card" / "bev" / "arrays.npz")
    kw = dict(log_every=1, eval_every=0, num_workers=1, dtype=torch.float32, device="cpu")
    _, png_model = train_bev(_narrow(tmp_path / "png"), Path(tiny_inputs) / "bev" / "png", n_devices=1, **kw)
    card_cfg = _narrow(tmp_path / "card")
    dataset_fn = partial(demo_bev_e2e.BEVArrayDataset, arrays, tokens, with_map=card_cfg.with_map)
    _, card_model = train_bev(card_cfg, None, tokens=tokens, n_devices=1, dataset_fn=dataset_fn, **kw)
    png_sd, card_sd = png_model.state_dict(), card_model.state_dict()
    assert png_sd.keys() == card_sd.keys()
    for k in png_sd:
        assert torch.equal(png_sd[k], card_sd[k]), k
    init = build_bev_model(_narrow(tmp_path / "init"), torch.float32, "cpu").state_dict()
    assert any(not torch.equal(init[k], card_sd[k]) for k in init), "two steps left the weights as they were"

    root = Path(tiny_inputs) / "bev" / "lyft"
    db = LyftDB(root, root / "data")
    bev_cfg = demo_inputs.bev_config(demo_inputs.load_meta(tiny_inputs))
    sample = [s["token"] for s in db.sample]
    kwargs = dict(max_components=32, class_score_threshold=0.0)
    raster = BEVInferencePipeline(db, [card_model], bev_cfg, **kwargs)
    looked_up = BEVInferencePipeline(db, [card_model], bev_cfg, **kwargs)
    looked_up.gen = demo_bev_e2e.PrecomputedMapGenerator(db, bev_cfg, maps)
    for tok in sample:
        assert np.array_equal(raster.gen.map_channel(tok), looked_up.gen.map_channel(tok))
    want, got = raster.detect_all(sample, batch_size=4), looked_up.detect_all(sample, batch_size=4)
    assert sum(len(v) for v in want.values()) > 0, "no detections to compare"
    assert got == want
