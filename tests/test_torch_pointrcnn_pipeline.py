"""Port parity of the PointRCNN host loop: on a KITTI tree exported from the
synthetic Lyft dataset, the port's loader gives the JAX loader's arrays, and
``eval_pointrcnn`` gives the JAX package's kept boxes, scores, recall table
and label files with the same weights (float32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyft3d_tpu.data import augment as jaug
from lyft3d_tpu.data.kitti import export_kitti
from lyft3d_tpu.data.lyftdb import LyftDB
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.pipelines import pointrcnn_train as jpipe
from lyft3d_tpu_torch.data import augment as taug
from lyft3d_tpu_torch.data.kitti import read_label_file
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.pipelines import pointrcnn as tpipe
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

TINY = dict(
    sa_npoints=(128, 32), sa_radii=((1.5,), (3.0,)), sa_nsamples=((8,), (8,)),
    sa_widths=(16, 32), fp_width=16, num_proposals=8, nms_pre=64, roi_points=16,
    rcnn_sa_npoints=(8,), rcnn_widths=(16,), rois_per_image=8,
)
LOADER = dict(num_points=1024, classes=("car",))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = make_synthetic_lyft(
        tmp_path_factory.mktemp("prcnn") / "lyft", num_scenes=1, samples_per_scene=3,
        boxes_per_sample=4, classes=["car"], seed=9, points_per_sweep=4096,
    )
    return export_kitti(LyftDB(root, root / "data"), tmp_path_factory.mktemp("prcnn") / "kitti")


@pytest.mark.parametrize("num_points", [1024, 8192])
def test_loader_gives_the_jax_loaders_arrays(kitti_root, num_points):
    """Below the cloud's size the subsampler draws from the seeded generator;
    above it the cloud is zero-padded."""
    kw = dict(LOADER, num_points=num_points, near_radius=15.0)
    jl = jpipe.KittiPointRCNNLoader(kitti_root, jpipe.KittiLoaderConfig(**kw), seed=3)
    tl = tpipe.KittiPointRCNNLoader(kitti_root, tpipe.KittiLoaderConfig(**kw), seed=3)
    assert tl.stems == jl.stems and len(tl.stems) == 3
    for stem in tl.stems:
        want, got = jl.sample(stem), tl.sample(stem)
        assert got.keys() == want.keys() and got["stem"] == stem
        for k in ("points", "points_valid", "gt_boxes", "gt_valid"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got["gt_valid"].sum() == 4
    want, got = jl.batch(jl.stems[:2]), tl.batch(tl.stems[:2])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    assert got["points"].shape == (2, num_points, 3)


@pytest.fixture(scope="module")
def gt_db(kitti_root, tmp_path_factory):
    """A sampler database (the JAX package's writer) of the tree's cars, crops
    of the raw (x, y, z, intensity) clouds."""
    jl = jpipe.KittiPointRCNNLoader(kitti_root, jpipe.KittiLoaderConfig(**LOADER))
    samples = []
    for stem in jl.stems:
        s = jl.sample(stem)
        boxes = s["gt_boxes"][s["gt_valid"]]
        samples.append({
            "points": np.fromfile(kitti_root / "velodyne" / f"{stem}.bin", np.float32).reshape(-1, 4),
            "gt_boxes": boxes, "gt_names": np.array(["car"] * len(boxes)),
        })
    root = tmp_path_factory.mktemp("gtdb")
    jaug.create_gt_database(root, samples, min_points=1)
    return root


@pytest.mark.parametrize("sampler,augment", [(False, True), (True, False), (True, True)],
                         ids=["augment", "sampler", "sampler-and-augment"])
def test_loader_augmenting_and_pasting_gives_the_jax_loaders_arrays(kitti_root, gt_db, sampler, augment):
    """With the same seeds and database, the port's training loader pastes
    the same objects into the same slots and draws the same flip, rotation
    and scaling as the JAX loader, over two passes of the tree."""
    kw = dict(LOADER, near_radius=15.0, augment=augment)
    samplers = [m.DataBaseSampler(m.GTDatabase(gt_db), {"car": 8}, seed=1) if sampler else None
                for m in (jaug, taug)]
    jl = jpipe.KittiPointRCNNLoader(kitti_root, jpipe.KittiLoaderConfig(**kw), seed=3,
                                    db_sampler=samplers[0])
    tl = tpipe.KittiPointRCNNLoader(kitti_root, tpipe.KittiLoaderConfig(**kw), seed=3,
                                    db_sampler=samplers[1])
    plain = tpipe.KittiPointRCNNLoader(kitti_root, tpipe.KittiLoaderConfig(**dict(kw, augment=False)), seed=3)
    changed = pasted = 0
    for _ in range(2):
        for stem in tl.stems:
            want, got, base = jl.sample(stem), tl.sample(stem), plain.sample(stem)
            for k in ("points", "points_valid", "gt_boxes", "gt_valid"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            changed += not np.array_equal(got["points"], base["points"])
            pasted += int(got["gt_valid"].sum()) - int(base["gt_valid"].sum())
    assert changed > 0 and (pasted > 0) == sampler


@pytest.fixture(scope="module")
def evaluated(kitti_root, tmp_path_factory):
    jcfg, tcfg = jnet.PointRCNNConfig(**TINY), tnet.PointRCNNConfig(**TINY)
    jl = jpipe.KittiPointRCNNLoader(kitti_root, jpipe.KittiLoaderConfig(**LOADER))
    tl = tpipe.KittiPointRCNNLoader(kitti_root, tpipe.KittiLoaderConfig(**LOADER))
    # A loader of its own for the init sample: drawing from jl would advance its generator.
    s = jpipe.KittiPointRCNNLoader(kitti_root, jpipe.KittiLoaderConfig(**LOADER)).sample(jl.stems[0])
    fm = jnet.PointRCNN(jcfg)
    params = jax.jit(fm.init)(jax.random.PRNGKey(1), jnp.asarray(s["points"]), None,
                              jnp.asarray(s["points_valid"]))
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    # Lift the RCNN class bias so that scores pass the 0.01 cut of the label files.
    params["params"]["PointRCNN_RCNN_0"]["Dense_1"]["bias"] += 1.0
    tm = load_flax_params(tnet.PointRCNN(tcfg), params)
    jdir, tdir = tmp_path_factory.mktemp("jax_labels"), tmp_path_factory.mktemp("torch_labels")
    want = jpipe.eval_pointrcnn(fm, params, jl, jcfg, out_dir=str(jdir))
    got = tpipe.eval_pointrcnn(tm, tl, tcfg, out_dir=str(tdir))
    return want, got, jdir, tdir, tl.stems


def test_eval_frames_match_jax(evaluated):
    (j_gt, j_det, _), (t_gt, t_det, _), _, _, stems = evaluated
    assert len(t_det) == len(j_det) == len(stems)
    kept = 0
    for jg, jd, tg, td in zip(j_gt, j_det, t_gt, t_det):
        np.testing.assert_array_equal(tg["boxes"], jg["boxes"])
        np.testing.assert_array_equal(tg["names"], jg["names"])
        np.testing.assert_array_equal(tg["difficulty"], jg["difficulty"])
        assert td["boxes"].shape == (TINY["num_proposals"], 7)
        np.testing.assert_array_equal(td["scores"] > 0, jd["scores"] > 0)  # the same kept set
        keep = jd["scores"] > 0
        kept += int(keep.sum())
        np.testing.assert_allclose(td["boxes"][keep], jd["boxes"][keep], rtol=0, atol=1e-3)
        np.testing.assert_allclose(td["scores"], jd["scores"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(td["names"], jd["names"])
    assert kept > 0


def test_eval_recall_table_matches_jax(evaluated):
    (_, _, j_stats), (_, _, t_stats), _, _, _ = evaluated
    assert t_stats == j_stats
    assert t_stats["num_frames"] == 3 and t_stats["num_gt"] == 12
    assert set(t_stats) == {"recall@0.1", "recall@0.3", "recall@0.5", "recall@0.7",
                            "num_frames", "num_gt"}


def test_eval_label_files_match_jax(evaluated):
    _, _, jdir, tdir, stems = evaluated
    written = 0
    for stem in stems:
        want, got = read_label_file(jdir / f"{stem}.txt"), read_label_file(tdir / f"{stem}.txt")
        assert len(got) == len(want)
        written += len(got)
        for a, b in zip(got, want):
            assert a.cls_type == b.cls_type == "Car"
            np.testing.assert_allclose([a.h, a.w, a.l, *a.pos, a.ry, a.score],
                                       [b.h, b.w, b.l, *b.pos, b.ry, b.score], rtol=0, atol=2e-3)
    assert written > 0


def test_infer_fn_is_batched(kitti_root):
    """A batch gives each sample the result it gets alone."""
    tcfg = tnet.PointRCNNConfig(**TINY)
    model = tnet.PointRCNN(tcfg, generator=torch.Generator().manual_seed(0))
    infer = tpipe.make_pointrcnn_infer_fn(model, tcfg)
    tl = tpipe.KittiPointRCNNLoader(kitti_root, tpipe.KittiLoaderConfig(**LOADER))
    b = tl.batch(tl.stems)
    boxes, scores = infer(torch.from_numpy(b["points"]), torch.from_numpy(b["points_valid"]))
    assert boxes.shape == (3, 8, 7) and scores.shape == (3, 8) and not model.training
    for i in range(3):
        one_boxes, one_scores = infer(torch.from_numpy(b["points"][i:i + 1]),
                                      torch.from_numpy(b["points_valid"][i:i + 1]))
        torch.testing.assert_close(boxes[i:i + 1], one_boxes, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(scores[i:i + 1], one_scores, rtol=1e-5, atol=1e-5)
