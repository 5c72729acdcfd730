"""Port parity for the SECOND pillars inference slice: synthetic Lyft
dataset → ``SecondSampleLoader`` → ``evaluate_second`` → world records, in
the JAX package and in the port, with the same float32 weights (flax init,
carried over by ``load_flax_params``); and the 9-class config that
``chip_smoke.py`` spells out, held to ``configs/second_lyft_9class.yaml``.

Preconditions, checked on the JAX run so that a failure means a real
difference and not a last-bit accident: no voxel holds more points than its
cap (which points an overflowing voxel keeps is not a contract); the score
at the pre-NMS top-k boundary is separated from the next by more than 1e-5;
no candidate pair's IoU lies within 1e-4 of the NMS threshold; and no two
overlapping candidates have scores within 1e-5 of each other (their greedy
order would be a coin toss).

Tolerances: scores 1e-5, yaw 1e-4 rad, translations and sizes 1e-4 m plus
1e-5 relative (float32 convolutions summed in another order; random weights
decode boxes up to hundreds of metres long, seen 5e-7 relative apart). Records are matched one to one by class and position, since
near-equal scores of distant boxes may list them in either order.
"""

import dataclasses
import runpy
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.config import SecondExperiment, load_yaml
from lyft3d_tpu.data.lyftdb import LyftDB
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.models.second.voxelnet import VoxelNetConfig as JConfig
from lyft3d_tpu.ops.anchors import AnchorSpec as JSpec
from lyft3d_tpu.ops.box_ops import decode_boxes
from lyft3d_tpu.ops.rotated_iou import rotated_iou_bev
from lyft3d_tpu.ops.voxelize import VoxelGrid as JGrid
from lyft3d_tpu.ops.voxelize import voxelize as jvoxelize
from lyft3d_tpu.pipelines import second_train as jsecond
from lyft3d_tpu.pipelines.second_pipeline import LoaderConfig, SecondSampleLoader, create_infos
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig
from lyft3d_tpu_torch.ops.anchors import AnchorSpec
from lyft3d_tpu_torch.ops.voxelize import VoxelGrid
from lyft3d_tpu_torch.pipelines import second as tsecond
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

REPO = Path(__file__).resolve().parent.parent
CLASSES = ["car", "bus", "truck"]
GRID = ((-40.0, -40.0, -3.0, 40.0, 40.0, 5.0), (0.5, 0.5, 8.0))
SPECS = [((2.0, 5.0, 1.8), 0.5, 0.45, 0.3), ((2.9, 12.0, 3.4), 0.9, 0.5, 0.35),
         ((2.8, 10.0, 3.4), 0.9, 0.5, 0.35)]
MODEL = dict(max_voxels=2048, max_points_per_voxel=48, encoder_features=(16,),
             rpn_layer_nums=(1, 1), rpn_strides=(2, 2), rpn_filters=(16, 32),
             rpn_up_strides=(1, 2), rpn_up_filters=(16, 16), nms_pre=96, nms_post=24)
JCFG = JConfig(grid=JGrid(*GRID), anchor_specs=tuple(JSpec(*s, class_id=i + 1)
                                                      for i, s in enumerate(SPECS)), **MODEL)
CFG = VoxelNetConfig(grid=VoxelGrid(*GRID), anchor_specs=tuple(AnchorSpec(*s, class_id=i + 1)
                                                                for i, s in enumerate(SPECS)), **MODEL)
SEED = 0
BATCH = 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = make_synthetic_lyft(tmp_path_factory.mktemp("lyft_second_port"), num_scenes=1,
                               samples_per_scene=3, boxes_per_sample=4, classes=CLASSES, seed=11)
    db = LyftDB(root, root / "data")
    return db, create_infos(db, num_sweeps=1, classes=CLASSES)


def loader(dataset):
    db, infos = dataset
    return SecondSampleLoader(db, infos, CLASSES,
                              LoaderConfig(max_points=8192, num_sweeps=1, augment=False))


def check_preconditions(model, params, samples):
    anchors, _, _, _ = JCFG.make_anchors()
    for s in samples:
        vox = jvoxelize(jnp.asarray(s["points"]), jnp.asarray(s["points_valid"]), JCFG.grid,
                        JCFG.max_voxels, JCFG.max_points_per_voxel)
        assert int(np.asarray(vox["num_points"]).max()) < JCFG.max_points_per_voxel
        preds = model.apply(params, *[vox[k][None] for k in
                                      ("voxels", "num_points", "coords", "voxel_valid")])
        scores = np.asarray(jax.nn.sigmoid(preds["cls"][0, :, 0]), np.float64)
        order = np.argsort(-scores, kind="stable")
        top = order[: JCFG.nms_pre]
        assert scores[order[JCFG.nms_pre - 1]] - scores[order[JCFG.nms_pre]] > 1e-5
        boxes = np.asarray(decode_boxes(preds["box"][0], anchors))[top]
        bev = jnp.asarray(boxes[:, [0, 1, 3, 4, 6]])
        iou = np.asarray(rotated_iou_bev(bev, bev))
        assert np.abs(iou - JCFG.nms_iou).min() > 1e-4
        close_scores = np.abs(scores[top][:, None] - scores[top][None, :]) < 1e-5
        np.fill_diagonal(close_scores, False)
        assert not (close_scores & (iou > JCFG.nms_iou)).any()


@pytest.fixture(scope="module")
def both_runs(dataset):
    tokens = [i["token"] for i in dataset[1]]
    ld = loader(dataset)
    samples = [ld.sample(t, train=False) for t in tokens]
    model = JVoxelNet(JCFG, dtype=jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(SEED), *_init_inputs(samples[0])))
    check_preconditions(model, params, samples)
    want = jsecond.evaluate_second(model, params, JCFG, loader(dataset), tokens, CLASSES,
                                   batch_size=BATCH)
    port = load_flax_params(VoxelNet(CFG, in_features=4), params)
    got = tsecond.evaluate_second(port, CFG, loader(dataset), tokens, CLASSES, batch_size=BATCH)
    return tokens, want, got


def _init_inputs(sample):
    vox = jvoxelize(jnp.asarray(sample["points"]), jnp.asarray(sample["points_valid"]), JCFG.grid,
                    JCFG.max_voxels, JCFG.max_points_per_voxel)
    return [vox[k][None] for k in ("voxels", "num_points", "coords", "voxel_valid")]


def test_jax_run_finds_detections_in_every_sample(both_runs):
    tokens, want, _ = both_runs
    for tok in tokens:
        n = sum(r["sample_token"] == tok for r in want)
        assert 3 <= n <= MODEL["nms_post"], (tok, n)
    assert len({r["name"] for r in want}) >= 2


def test_records_match(both_runs):
    tokens, want, got = both_runs
    assert len(got) == len(want)
    for tok in tokens:
        a = [r for r in want if r["sample_token"] == tok]
        b = [r for r in got if r["sample_token"] == tok]
        assert sorted(r["name"] for r in a) == sorted(r["name"] for r in b), tok
        unused = list(range(len(b)))
        for ra in a:
            dist = [np.abs(np.subtract(b[j]["translation"], ra["translation"])).max()
                    if b[j]["name"] == ra["name"] else np.inf for j in unused]
            rb = b[unused.pop(int(np.argmin(dist)))]
            np.testing.assert_allclose(rb["translation"], ra["translation"], atol=1e-4, rtol=1e-5)
            np.testing.assert_allclose(rb["size"], ra["size"], atol=1e-4, rtol=1e-5)
            np.testing.assert_allclose(rb["yaw"], ra["yaw"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(rb["score"], ra["score"], atol=1e-5, rtol=0)


def test_batch_size_does_not_change_records(dataset, both_runs):
    """One padded batch of 4 gives the same records as batches of 2."""
    tokens, _, got = both_runs
    port = VoxelNet(CFG, in_features=4, generator=torch.Generator().manual_seed(0))
    one = tsecond.evaluate_second(port, CFG, loader(dataset), tokens, CLASSES, batch_size=4)
    two = tsecond.evaluate_second(port, CFG, loader(dataset), tokens, CLASSES, batch_size=2)
    assert one == two and len(one) > 0


def test_measure_time_prints_sections_and_keeps_records(dataset, both_runs, capsys):
    """``measure_time=True`` gives the same records and prints the JAX
    package's ``sec_per_example`` line with its three sections."""
    tokens, _, got = both_runs
    port = VoxelNet(CFG, in_features=4, generator=torch.Generator().manual_seed(0))
    plain = tsecond.evaluate_second(port, CFG, loader(dataset), tokens, CLASSES, batch_size=BATCH)
    assert "sec_per_example" not in capsys.readouterr().out
    timed = tsecond.evaluate_second(port, CFG, loader(dataset), tokens, CLASSES, measure_time=True,
                                    batch_size=BATCH)
    assert timed == plain and len(timed) > 0
    (line,) = [l for l in capsys.readouterr().out.splitlines() if l.startswith("sec_per_example: ")]
    assert [part.split("=")[0] for part in line.split("(")[1].rstrip(")").split(", ")] == [
        "infer", "postprocess", "prep"]


def test_lyft9_config_matches_yaml():
    """chip_smoke.py's spelled-out 9-class config == the port's config of
    the shipped yaml, field by field; and the JAX config agrees on every
    shared field, the feature grid (62²) and the anchor count (69,192)."""
    exp = load_yaml(SecondExperiment, REPO / "configs" / "second_lyft_9class.yaml")
    from_yaml = tsecond.voxelnet_config_from_experiment(exp)
    spelled = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")["lyft9_config"]()
    for f in dataclasses.fields(VoxelNetConfig):
        assert getattr(spelled, f.name) == getattr(from_yaml, f.name), f.name
    jcfg = jsecond.voxelnet_config_from_experiment(exp)
    for f in dataclasses.fields(VoxelNetConfig):  # NamedTuples compare as tuples
        assert getattr(jcfg, f.name) == getattr(from_yaml, f.name), f.name
    assert from_yaml.feature_hw == jcfg.feature_hw == (62, 62)
    assert from_yaml.anchors_per_loc == 18
    assert from_yaml.make_anchors()[0].shape == (69192, 7)
