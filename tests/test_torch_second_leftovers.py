"""Port parity for the last pieces of SECOND: the VFE encoder
(``VoxelFeatureExtractor`` alone and in ``VoxelNet`` with each middle), the
unit middle with ``norm_type="batch"`` (eval mode, flax's train mode, and the
JAX trainer's step with it), the BatchNorm fold on that middle,
``standup_nms``, ``box_corners_3d`` and ``train/metrics.py``, each against
the JAX package on the same numpy inputs and the same flax weights carried
over by ``load_flax_params``.

Tolerances: encoder outputs and dense BEV maps 1e-4 of their scale, heads
1e-3 (float32 sums in another order through the middle and the RPN), as in
``test_torch_second_sparse.py``; a trainer step: loss 1e-5 relative,
parameters and statistics 1e-5 absolute (one Adam step of 1e-3), as in
``test_torch_trainer.py``; box corners 1e-6; NMS keep masks equal, with no
IoU within 1e-4 of the threshold (asserted); metrics 1e-6. The models are fed
the JAX voxelizer's output, so both sides see the same voxels.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lyft3d_tpu.models.fold_bn import fold_batch_norms as jax_fold
from lyft3d_tpu.models.second import middle as jmid
from lyft3d_tpu.models.second import voxel_encoder as jenc
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.ops import box_ops as jbox
from lyft3d_tpu.ops import nms as jnms
from lyft3d_tpu.ops import rotated_iou as jiou
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu.pipelines import second_train as jtrain
from lyft3d_tpu.train import metrics as jmetrics
from lyft3d_tpu.train import trainer as jtrainer
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.models.second.middle import SparseMiddleUnits
from lyft3d_tpu_torch.models.second.voxel_encoder import VoxelFeatureExtractor
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.ops import box_ops as tbox
from lyft3d_tpu_torch.ops import nms as tnms
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
from lyft3d_tpu_torch.pipelines import second_train as ttrain
from lyft3d_tpu_torch.train import metrics as tmetrics
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_layers import randomized  # noqa: E402
from test_torch_second_sparse import (  # noqa: E402
    JCFG as JSPARSE,
    KW,
    SHAPE,
    jbatch,
    port_config,
    random_batch,
)
from test_torch_second_train import JPILLARS, flat, pillars_batch, sparse_batch, t  # noqa: E402

BEV_TOL = 1e-4
HEAD_TOL = 1e-3
VOX_KEYS = ("voxels", "num_points", "coords", "voxel_valid")


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0)


def flax_init(module, *inputs, seed=0):
    """flax variables with norm scales, biases and running statistics drawn
    with numpy (init leaves them at 1/0, which would hide a mix-up)."""
    return randomized(jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)), seed)


def jax_voxels(jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.device_get(jax.vmap(lambda p, m: jvox.voxelize(
        p, m, jcfg.grid, jcfg.max_voxels, jcfg.max_points_per_voxel))(jb["points"], jb["points_valid"]))


# ------------------------------------------------------------------ VFE


def vfe_inputs(seed=0):
    rng = np.random.RandomState(seed)
    voxels = rng.randn(2, 40, 6, 4).astype(np.float32)
    nump = rng.randint(0, 7, (2, 40)).astype(np.int32)
    nump[:, :3] = 0  # empty voxels
    voxels *= (np.arange(6) < nump[..., None])[..., None]
    return voxels, nump, np.zeros((2, 40, 3), np.int32)


@pytest.mark.parametrize("with_distance", [False, True])
def test_vfe_encoder_matches_flax(with_distance):
    voxels, nump, coords = vfe_inputs()
    jm = jenc.VoxelFeatureExtractor(features=(8, 16), with_distance=with_distance, dtype=jnp.float32)
    v = flax_init(jm, voxels, nump, coords)
    want = np.asarray(jax.jit(jm.apply)(v, voxels, nump, coords))
    tm = load_flax_params(VoxelFeatureExtractor(4, (8, 16), with_distance=with_distance), v)
    with torch.no_grad():
        got = tm(t(voxels), t(nump), t(coords))
    assert got.shape == (2, 40, 16)
    close(got.numpy(), want, BEV_TOL)
    # An empty voxel's rows are ReLU·mask zeros, and the max runs over them.
    assert float(np.abs(want[:, :3]).max()) == 0.0 == float(got[:, :3].abs().max())
    assert (want >= 0).all() and np.abs(want).max() > 0.1


VFE_CASES = {
    "scatter": (dataclasses.replace(JPILLARS, encoder="vfe", encoder_features=(8, 16)),
                pillars_batch),
    "sparse_units": (dataclasses.replace(JSPARSE, encoder="vfe", encoder_features=(8, 16)),
                     sparse_batch),
    "sparse": (dataclasses.replace(JSPARSE, encoder="vfe", encoder_features=(8, 16),
                                   middle="sparse"), sparse_batch),
}


@pytest.mark.parametrize("middle", sorted(VFE_CASES))
def test_vfe_voxelnet_matches_flax(middle):
    jcfg, make_batch = VFE_CASES[middle]
    batch = make_batch()
    vox = jax_voxels(jcfg, batch)
    args = [vox[k] for k in VOX_KEYS]
    jm = JVoxelNet(jcfg, dtype=jnp.float32)
    v = flax_init(jm, *args)
    assert "VoxelFeatureExtractor_0" in v["params"]
    want = jax.jit(jm.apply)(v, *args)
    tm = load_flax_params(VoxelNet(port_config(jcfg), in_features=batch["points"].shape[-1]), v)
    with torch.no_grad():
        got = tm.eval()(*[t(a) for a in args])
    for k in ("box", "cls", "dir"):
        assert got[k].shape == want[k].shape, k
        close(got[k].numpy(), want[k], HEAD_TOL)
    assert np.abs(np.asarray(want["box"])).max() > 0.1
    back = export_flax_params(tm)["params"]
    assert set(flat(back)) == set(flat(v["params"]))


# ------------------------------------------------------- BatchNorm middle


@pytest.fixture(scope="module")
def batch_middle():
    """A flax unit middle with ``norm_type="batch"`` (random running
    statistics), its inputs, and the port's middle with its weights."""
    coords, valid, feats = random_batch(9, SHAPE, (70, 75), 96, 4, True)
    jm = jmid.SparseMiddleUnits(z_slab=4, dtype=jnp.float32, method="ref", norm_type="batch",
                                assume_sorted_voxels=True, **KW)
    v = flax_init(jm, jnp.asarray(feats), jbatch(coords, valid, SHAPE))
    assert "BatchNorm_0" in v["params"]["SubMUnitLayer_0"]
    tm = load_flax_params(SparseMiddleUnits(4, z_slab=4, norm_type="batch", assume_sorted_voxels=True,
                                            nz=SHAPE[2], **KW), v)
    return (coords, valid, feats), jm, v, tm


def test_batch_middle_eval_matches_flax(batch_middle):
    (coords, valid, feats), jm, v, tm = batch_middle
    want, _ = jax.jit(jm.apply)(v, jnp.asarray(feats), jbatch(coords, valid, SHAPE))
    with torch.no_grad():
        got, _ = tm.eval()(t(feats), ActiveSet(t(coords), t(valid), SHAPE))
    close(got.numpy(), want, BEV_TOL)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_batch_middle_train_mode_matches_flax_mutable(batch_middle):
    """flax with ``mutable=["batch_stats"]`` against the port in ``train()``:
    statistics over every row of the ``(B, V, C)`` output, inactive and padded
    ones included, the same outputs and the same updated running statistics."""
    (coords, valid, feats), jm, v, tm = batch_middle
    (want, _), upd = jax.jit(lambda v, f, a: jm.apply(v, f, a, mutable=["batch_stats"]))(
        v, jnp.asarray(feats), jbatch(coords, valid, SHAPE))
    tm = load_flax_params(SparseMiddleUnits(4, z_slab=4, norm_type="batch", assume_sorted_voxels=True,
                                            nz=SHAPE[2], **KW), v).train()
    with torch.no_grad():
        got, _ = tm(t(feats), ActiveSet(t(coords), t(valid), SHAPE))
    close(got.numpy(), want, BEV_TOL)
    stats = flat(export_flax_params(tm)["batch_stats"])
    for path, w in flat(jax.device_get(upd["batch_stats"])).items():
        close(stats[path], w, 1e-5)


JBATCH = dataclasses.replace(JSPARSE, middle_norm="batch")


def test_second_trainer_with_batch_middle_follows_jax(tmp_path):
    """The JAX SECOND trainer applies the model to its whole variable tree, not
    mutable: the middle normalises with its running statistics in the step,
    and the optimizer moves those statistics like parameters. The port's
    ``batch_stats_as_parameters`` does the same: one ``adam`` step from equal
    weights gives the same loss, parameters and statistics."""
    batch = sparse_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax_voxels(JBATCH, batch)
    jmodel = JVoxelNet(JBATCH, dtype=jnp.float32)
    variables = flax_init(jmodel, *[vox[k] for k in VOX_KEYS])
    jtr = jtrainer.Trainer(jmodel, optax.adam(1e-3), jtrain.make_second_loss_fn(JBATCH),
                           jtrainer.TrainerConfig(model_dir=str(tmp_path / "j"), donate_state=False))
    jstate, jm = jtr._step_fn(jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                                         jtr.tx), jb, jax.random.PRNGKey(0))
    after = jax.device_get(jstate.params)
    before_stats, after_stats = flat(variables["batch_stats"]), flat(after["batch_stats"])
    moved = max(float(np.abs(after_stats[p] - w).max()) for p, w in before_stats.items())
    assert moved > 1e-4  # the statistics were trained, not averaged

    cfg = port_config(JBATCH)
    model = load_flax_params(VoxelNet(cfg, in_features=3), variables)
    ttrain.batch_stats_as_parameters(model)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(norms) == 3 * len(JBATCH.middle_features)  # two submanifold + one strided a stage
    assert all(isinstance(m.running_var, torch.nn.Parameter) and m.use_running_average for m in norms)
    trainer = Trainer(model, lambda p: build_optimizer(p, "adam", 1e-3),
                      ttrain.make_second_loss_fn(cfg, device="cpu"),
                      TrainerConfig(model_dir=str(tmp_path / "t")))
    state, metrics = trainer.step_fn(TrainState(model, lambda p: build_optimizer(p, "adam", 1e-3)),
                                     {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    got = export_flax_params(model)
    for coll in ("params", "batch_stats"):
        want_flat, got_flat = flat(after[coll]), flat(got[coll])
        assert set(want_flat) == set(got_flat)
        for path, w in want_flat.items():
            np.testing.assert_allclose(got_flat[path], w, atol=1e-5, rtol=0, err_msg="/".join(path))
    # The statistics stay float32 parameters through a cast of the module.
    model.to(torch.bfloat16)
    assert all(isinstance(m.running_mean, torch.nn.Parameter)
               and m.running_mean.dtype == torch.float32 for m in norms)


def test_fold_leaves_the_middle_batch_norms_in_place():
    """The JAX fold pairs ``BatchNorm_i`` only with a ``Conv_i`` / ``Dense_i``
    sibling; a unit layer's weight is a bare ``kernel``, so its
    ``BatchNorm_0`` stays (and the result drops every ``batch_stats``). The
    port's fold leaves the middle's BatchNorms as they are too, with their
    running statistics, and the folded copy computes what the model does."""
    batch = sparse_batch()
    vox = jax_voxels(JBATCH, batch)
    args = [vox[k] for k in VOX_KEYS]
    jmodel = JVoxelNet(JBATCH, dtype=jnp.float32)
    variables = flax_init(jmodel, *args)
    folded = jax_fold(variables)
    assert set(folded) == {"params"}
    unit = folded["params"]["SparseMiddleUnits_0"]["SubMUnitLayer_0"]
    assert set(unit) == {"kernel", "BatchNorm_0"}
    assert flat(folded["params"]).keys() == flat(variables["params"]).keys()

    model = load_flax_params(VoxelNet(port_config(JBATCH), in_features=3), variables).eval()
    tfolded = fold_batch_norms(model)
    norms = [m for m in tfolded.modules() if isinstance(m, BatchNorm)]
    assert len(norms) == len([m for m in model.modules() if isinstance(m, BatchNorm)]) > 0
    assert tfolded.state_dict().keys() == model.state_dict().keys()
    with torch.no_grad():
        want, got = model(*[t(a) for a in args]), tfolded(*[t(a) for a in args])
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------ NMS, boxes, metrics


def nms_case(seed, n=48):
    rng = np.random.RandomState(seed)
    boxes = np.column_stack([rng.uniform(-6, 6, (n, 2)), rng.uniform(1, 3, (n, 2)),
                             rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[5:9] = scores[4]  # ties go to the lower index
    valid = rng.uniform(size=n) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("thr", [0.1, 0.3, 0.5])
def test_standup_nms_matches_jax(thr):
    cases = [nms_case(s) for s in (0, 1)]
    boxes, scores, valid = (np.stack(a) for a in zip(*cases))
    for b in range(2):  # no IoU within 1e-4 of the threshold
        su = jbox.corners_to_standup_2d(jbox.box_corners_2d(jnp.asarray(boxes[b])))
        iou = np.asarray(jiou.standup_iou(su, su))
        assert np.abs(iou - thr).min() > 1e-4
    want = np.stack([np.asarray(jnms.standup_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr,
                                                 valid=jnp.asarray(valid[b]))) for b in range(2)])
    got = tnms.standup_nms(t(boxes), t(scores), thr, valid=t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()
    one = tnms.standup_nms(t(boxes[0]), t(scores[0]), thr)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jnms.standup_nms(
        jnp.asarray(boxes[0]), jnp.asarray(scores[0]), thr)))


def test_box_corners_3d_matches_jax():
    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.uniform(-20, 20, (3, 5, 3)), rng.uniform(0.5, 5, (3, 5, 3)),
                            rng.uniform(-4, 4, (3, 5, 1))], -1).astype(np.float32)
    want = np.asarray(jbox.box_corners_3d(jnp.asarray(boxes)))
    got = tbox.box_corners_3d(t(boxes))
    assert got.shape == (3, 5, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * 25, rtol=0)


def test_metrics_match_jax():
    rng = np.random.RandomState(5)
    jpr, tpr = jmetrics.prec_recall_init((0.1, 0.5, 0.9)), tmetrics.prec_recall_init((0.1, 0.5, 0.9))
    jacc, tacc = jmetrics.accuracy_init(), tmetrics.accuracy_init()
    for step in range(3):
        scores = rng.uniform(size=(4, 30)).astype(np.float32)
        labels = (rng.uniform(size=(4, 30)) > 0.6).astype(np.int32)
        weights = None if step == 0 else rng.uniform(size=(4, 30)).astype(np.float32)
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else t(weights)
        jpr = jmetrics.prec_recall_update(jpr, jnp.asarray(scores), jnp.asarray(labels), jw)
        old, before = tpr, {k: v.clone() for k, v in tpr.items()}
        tpr = tmetrics.prec_recall_update(tpr, t(scores), t(labels), tw)
        assert all(torch.equal(before[k], v) for k, v in old.items())  # no update in place
        preds = rng.randint(0, 3, (4, 30))
        cls = rng.randint(0, 3, (4, 30))
        jacc = jmetrics.accuracy_update(jacc, jnp.asarray(preds), jnp.asarray(cls), jw)
        tacc = tmetrics.accuracy_update(tacc, t(preds), t(cls), tw)
    for g, w in zip(tmetrics.prec_recall_compute(tpr), jmetrics.prec_recall_compute(jpr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_allclose(tpr[k].numpy(), np.asarray(jpr[k]), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics.accuracy_compute(tacc)),
                               float(jmetrics.accuracy_compute(jacc)), rtol=1e-6)
    assert tpr["tp"].dtype == tacc["total"].dtype == torch.float32
