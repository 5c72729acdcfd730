"""Port parity for the SECOND training path: box encoding, anchor masks,
target assignment, the losses, ``voxelnet_loss`` and the whole slice
(``make_second_loss_fn``: loss, metrics and every parameter gradient) against
the JAX package on the same numpy inputs.

Tolerances: labels, direction targets, masks exact; box targets 1e-5; IoUs
1e-4, with a guard that no class-matched IoU lies within 1e-4 of a threshold
and that each GT's best anchor leads the runner-up by more than 1e-4 (else a
rounding could flip a label); loss values 1e-5 relative; loss gradients 1e-5
of scale; whole-slice parameter gradients 1e-4 of each leaf's scale in
float32 (floored at 1e-3 of the largest leaf's). Where two GTs claim one best
anchor the JAX scatter is unspecified; the cases here keep claims unique and
assert it.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.models.second.voxelnet import voxelnet_loss as jvoxelnet_loss
from lyft3d_tpu.ops import anchors as janchors
from lyft3d_tpu.ops import box_ops as jbox
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu.pipelines import second_train as jtrain
from lyft3d_tpu.train import losses as jlosses
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, voxelnet_loss
from lyft3d_tpu_torch.ops import anchors as tanchors
from lyft3d_tpu_torch.ops import box_ops as tbox
from lyft3d_tpu_torch.pipelines import second as tsecond
from lyft3d_tpu_torch.pipelines import second_train as ttrain
from lyft3d_tpu_torch.train import losses as tlosses
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_second import CFG as JCFG  # noqa: E402  the JAX suite's small pillars config
from test_second import make_cloud  # noqa: E402
from test_torch_second import port_config  # noqa: E402
from test_torch_second_sparse import JCFG as JSPARSE  # noqa: E402
from test_torch_second_sparse import one_point_cloud  # noqa: E402

MARGIN = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol, floor=1.0):
    want = np.asarray(want)
    scale = max(floor, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0)


# ------------------------------------------------------------------ box codes


@pytest.mark.parametrize("vector,smooth", [(False, False), (True, False), (False, True)],
                         ids=["angle", "angle_vector", "smooth_dim"])
def test_encode_boxes_and_sin_difference(vector, smooth):
    rng = np.random.RandomState(0)
    boxes = np.column_stack([rng.uniform(-10, 10, (40, 3)), rng.uniform(1, 5, (40, 3)),
                             rng.uniform(-3, 3, 40)]).astype(np.float32)
    anch = np.column_stack([rng.uniform(-10, 10, (40, 3)), rng.uniform(1, 5, (40, 3)),
                            rng.choice([0.0, np.pi / 2], 40)]).astype(np.float32)
    want = jbox.encode_boxes(jnp.asarray(boxes), jnp.asarray(anch), vector, smooth)
    got = tbox.encode_boxes(t(boxes), t(anch), vector, smooth)
    assert got.shape == (40, 8 if vector else 7)
    close(got, want, 1e-6)
    back = tbox.decode_boxes(got, t(anch), vector, smooth)
    if vector:  # the vector code gives the angle back modulo 2π
        np.testing.assert_allclose(np.cos(back.numpy()[:, 6] - boxes[:, 6]), 1.0, atol=1e-4)
        np.testing.assert_allclose(back.numpy()[:, :6], boxes[:, :6], atol=1e-4)
    else:
        np.testing.assert_allclose(back.numpy(), boxes, atol=1e-4)
    for g, w in zip(tbox.add_sin_difference(t(boxes[:, 6]), t(anch[:, 6])),
                    jbox.add_sin_difference(jnp.asarray(boxes[:, 6]), jnp.asarray(anch[:, 6]))):
        close(g, w, 1e-6)


# ---------------------------------------------------------------- anchor masks


def test_occupancy_and_area_mask_equal():
    rng = np.random.RandomState(1)
    ny, nx = 32, 32
    coords = np.stack([rng.randint(0, nx, (2, 60)), rng.randint(0, ny, (2, 60)),
                       np.zeros((2, 60), int)], -1).astype(np.int32)
    valid = rng.rand(2, 60) < 0.8
    jocc = jax.vmap(lambda c, v: janchors.bev_occupancy_mask(c, v, (ny, nx)))(
        jnp.asarray(coords), jnp.asarray(valid))
    tocc = tanchors.bev_occupancy_mask(t(coords), t(valid), (ny, nx))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tanchors.bev_occupancy_mask(t(coords[0]), t(valid[0]), (ny, nx)).numpy(),
                                  np.asarray(jocc[0]))
    janc = JCFG.make_anchors()[0]
    jstand = jbox.corners_to_standup_2d(jbox.box_corners_2d(
        jnp.concatenate([janc[:, 0:2], janc[:, 3:5], janc[:, 6:7]], -1)))
    for min_area in (1.0, 3.0):
        want = jax.vmap(lambda o: janchors.anchors_area_mask(
            jstand, o, JCFG.grid.point_cloud_range, min_area))(jocc)
        got = tanchors.anchors_area_mask(t(jstand), tocc, JCFG.grid.point_cloud_range, min_area)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < np.asarray(want).mean() < 1


# ------------------------------------------------------------ target assignment

JSPEC2 = janchors.AnchorSpec(size=(0.8, 0.8, 1.7), z_center=0.0, matched_threshold=0.35,
                             unmatched_threshold=0.2, class_id=2)
JCFG2 = dataclasses.replace(JCFG, anchor_specs=(JCFG.anchor_specs[0], JSPEC2), num_classes=2)


def gt_batch(seed, g=6, pad=3, batch=2, classes=(1, 2)):
    """``g`` GT boxes a sample of mixed classes on a coarse lattice (so that
    no two share a best anchor), padded with ``pad`` invalid rows."""
    rng = np.random.RandomState(seed)
    sizes = {1: (2.0, 4.0, 1.6), 2: (0.8, 0.8, 1.7)}
    boxes = np.zeros((batch, g + pad, 7), np.float32)
    cls = np.zeros((batch, g + pad), np.int32)
    for b in range(batch):
        cells = rng.choice(16, g, replace=False)
        for i, cell in enumerate(cells):
            c = classes[i % len(classes)]
            cx, cy = (cell % 4) * 7.0 - 10.5, (cell // 4) * 7.0 - 10.5
            boxes[b, i] = (cx + rng.uniform(-0.8, 0.8), cy + rng.uniform(-0.8, 0.8), rng.uniform(-0.5, 0.5),
                           *(np.array(sizes[c]) * rng.uniform(0.9, 1.1, 3)), rng.uniform(-3, 3))
            cls[b, i] = c
    valid = np.broadcast_to(np.arange(g + pad) < g, (batch, g + pad)).copy()
    return boxes, cls, valid


def assert_safe_margins(tgt, thresholds):
    """No anchor's best IoU lies near a threshold."""
    iou = np.asarray(tgt["max_iou"])
    for thr in thresholds:
        assert np.abs(iou - thr).min() > MARGIN


def port_anchor_args(jcfg):
    """The port's anchors in the argument order of ``assign_targets``."""
    anchors, mt, ut, acls = port_config(jcfg).make_anchors()
    return anchors, acls, mt, ut


def both_assign(jcfg, boxes, cls, valid, similarity, mask=None):
    janc, jmt, jut, jcls = jcfg.make_anchors()
    jm = jnp.asarray(mask) if mask is not None else jnp.ones((boxes.shape[0], janc.shape[0]), bool)
    want = jax.jit(jax.vmap(lambda g, c, v, m: janchors.assign_targets(
        janc, jcls, jmt, jut, g, c, v, anchor_mask=m, similarity=similarity)))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid), jm)
    got = tanchors.assign_targets(*port_anchor_args(jcfg), t(boxes), t(cls), t(valid),
                                  anchor_mask=None if mask is None else t(mask), similarity=similarity)
    return jax.device_get(want), got


def assert_targets_equal(got, want):
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["dir_targets"].numpy(), want["dir_targets"])
    np.testing.assert_array_equal(got["reg_weights"].numpy(), want["reg_weights"])
    np.testing.assert_allclose(got["bbox_targets"].numpy(), want["bbox_targets"], atol=1e-5)


@pytest.mark.parametrize("similarity", ["nearest", "rotated"])
def test_assign_targets_matches_jax(similarity):
    boxes, cls, valid = gt_batch(3)
    want, got = both_assign(JCFG2, boxes, cls, valid, similarity)
    thresholds = {s.matched_threshold for s in JCFG2.anchor_specs} | {
        s.unmatched_threshold for s in JCFG2.anchor_specs}
    assert_safe_margins(want, thresholds)
    np.testing.assert_allclose(got["max_iou"].numpy(), want["max_iou"], atol=MARGIN)
    assert_targets_equal(got, want)
    np.testing.assert_array_equal(got["assigned_gt"].numpy(), want["assigned_gt"])
    labels = want["labels"]
    assert {-1, 0, 1, 2} <= set(np.unique(labels).tolist())
    # Positives belong to valid GTs, several of them (a small box between
    # anchor centres overlaps no anchor of its class and stays unmatched).
    for b in range(boxes.shape[0]):
        pos_gt = set(want["assigned_gt"][b][labels[b] > 0].tolist())
        assert pos_gt <= set(np.flatnonzero(valid[b]).tolist()) and len(pos_gt) >= 3
    assert got["labels"].dtype == torch.int32 and got["bbox_targets"].shape[-1] == 7
    one = tanchors.assign_targets(*port_anchor_args(JCFG2), t(boxes[0]), t(cls[0]), t(valid[0]),
                                  similarity=similarity)
    for k in ("labels", "bbox_targets", "dir_targets"):
        assert torch.equal(one[k], got[k][0])


def test_assign_targets_ties_take_the_first_index_and_mask_is_dont_care():
    """Exact ties: an anchor with no class-matched GT (a row of −1 fills) and
    two identical GTs (equal columns). ``argmax`` takes the first index in
    both packages. The duplicated pair claims one best anchor, where the JAX
    scatter is unspecified: that anchor's assigned GT is left out."""
    boxes, cls, valid = gt_batch(5, g=4, pad=2, batch=1)
    boxes[0, 3], cls[0, 3] = boxes[0, 0], cls[0, 0]  # GT 3 duplicates GT 0
    mask = np.random.RandomState(0).rand(1, JCFG2.make_anchors()[0].shape[0]) < 0.7
    want, got = both_assign(JCFG2, boxes, cls, valid, "nearest", mask)
    assert_targets_equal(got, want)
    shared = want["labels"][0] > 0
    free = ~shared | ~np.isin(want["assigned_gt"][0], (0, 3))
    np.testing.assert_array_equal(got["assigned_gt"].numpy()[0][free], want["assigned_gt"][0][free])
    assert (want["assigned_gt"][0][want["max_iou"][0] < 0] == 0).all()  # all-(−1) rows
    assert (got["labels"].numpy()[~mask] == -1).all()


def test_assign_targets_pruned_matches_jax():
    boxes, cls, valid = gt_batch(7)
    janc, jmt, jut, jcls = JCFG2.make_anchors()
    rng = np.random.RandomState(2)
    mask = rng.rand(2, janc.shape[0]) < 0.25
    max_active = 160  # under the ~256 masked anchors: the cap cuts
    want = jax.device_get(jax.jit(jax.vmap(lambda g, c, v, m: janchors.assign_targets_pruned(
        janc, jcls, jmt, jut, g, c, v, m, max_active=max_active, similarity="rotated")))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid), jnp.asarray(mask)))
    got = tanchors.assign_targets_pruned(*port_anchor_args(JCFG2), t(boxes), t(cls), t(valid),
                                         t(mask), max_active=max_active, similarity="rotated")
    assert mask.sum(-1).min() > max_active
    assert_targets_equal(got, want)
    assert (want["labels"] >= 0).sum() == 2 * max_active


def test_tune_match_thresholds_matches_jax():
    boxes, cls, valid = gt_batch(9, g=6, pad=0)
    samples = [(boxes[b], cls[b]) for b in range(2)] + [(np.zeros((0, 7), np.float32), np.zeros(0, int))]
    janc, _, _, jcls = JCFG2.make_anchors()
    tanc, _, _, tcls = port_config(JCFG2).make_anchors()
    for similarity in ("nearest", "rotated"):
        want = janchors.tune_match_thresholds(janc, jcls, samples, (1, 2), target_rate=1.0,
                                              similarity=similarity)
        got = tanchors.tune_match_thresholds(tanc, tcls, samples, (1, 2), target_rate=1.0,
                                             similarity=similarity)
        assert got == want


# ----------------------------------------------------------------------- losses


def _loss_inputs(seed=0, shape=(2, 6, 5, 4)):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    onehot = np.eye(shape[-1], dtype=np.float32)[labels]
    weights = rng.rand(*shape[:-1], 1).astype(np.float32)
    return logits, labels, onehot, weights


# Subtracted from the logits, it makes 30% of them exactly 0 (a pixel whose
# head input is all ReLU zeros at init) with the gradient passed through:
# there the subgradients of max(x, 0) and |x| decide the loss's gradient.
_AT_ZERO = np.where(np.random.RandomState(5).rand(2, 6, 5, 4) < 0.3, _loss_inputs()[0], 0.0).astype(np.float32)

LOSS_CASES = {
    "weighted_softmax_ce": lambda m, a, x, lab, oh, w: m.weighted_softmax_ce(x, lab),
    "weighted_softmax_ce_weights": lambda m, a, x, lab, oh, w: m.weighted_softmax_ce(
        x, lab, a([0.2, 1.0, 3.0, 0.5])),
    "bce_with_logits": lambda m, a, x, lab, oh, w: m.bce_with_logits(x, oh, w),
    "bce_with_logits_at_zero": lambda m, a, x, lab, oh, w: m.bce_with_logits(x - a(_AT_ZERO), oh, w),
    "sigmoid_focal_loss_at_zero": lambda m, a, x, lab, oh, w: m.sigmoid_focal_loss(
        x - a(_AT_ZERO), oh, alpha=0.3, gamma=1.5, weights=w).sum(),
    "soft_dice_loss": lambda m, a, x, lab, oh, w: m.soft_dice_loss(x, oh),
    "soft_dice_loss_with_background": lambda m, a, x, lab, oh, w: m.soft_dice_loss(
        x, oh, eps=0.5, skip_background=False),
    "sigmoid_focal_loss": lambda m, a, x, lab, oh, w: m.sigmoid_focal_loss(
        x, oh, alpha=0.3, gamma=1.5, weights=w).sum(),
    "smooth_l1": lambda m, a, x, lab, oh, w: m.smooth_l1(x * 0.2, sigma=2.0).sum(),
    "weighted_smooth_l1": lambda m, a, x, lab, oh, w: m.weighted_smooth_l1(
        x * 0.2, oh, weights=w[..., 0], code_weights=a([1.0, 0.5, 2.0, 1.0])).sum(),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_value_and_gradient(case):
    logits, labels, onehot, weights = _loss_inputs()
    fn = LOSS_CASES[case]
    want, want_g = jax.value_and_grad(
        lambda x: fn(jlosses, jnp.asarray, x, jnp.asarray(labels), jnp.asarray(onehot), jnp.asarray(weights))
    )(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    got = fn(tlosses, torch.tensor, x, t(labels), t(onehot), t(weights))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    close(x.grad, want_g, 1e-5, floor=1e-12)


def test_bev_segmentation_loss_value_and_gradients():
    logits, labels, _, _ = _loss_inputs(1)
    aux = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    cw = [0.1, 1.0, 2.0, 1.5]
    (want, wparts), (wg, wga) = jax.value_and_grad(
        lambda x, a: jlosses.bev_segmentation_loss(x, a, jnp.asarray(labels), jnp.asarray(cw), 20.0),
        argnums=(0, 1), has_aux=True)(jnp.asarray(logits), jnp.asarray(aux))
    x, a = t(logits).requires_grad_(True), t(aux).requires_grad_(True)
    got, parts = tlosses.bev_segmentation_loss(x, a, t(labels), cw, 20.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in wparts:
        np.testing.assert_allclose(float(parts[k]), float(wparts[k]), rtol=1e-5)
    close(x.grad, wg, 1e-5, floor=1e-12)
    close(a.grad, wga, 1e-5, floor=1e-12)


@pytest.mark.parametrize("variant", ["one_class", "two_classes", "angle_vector"])
def test_voxelnet_loss_value_metrics_and_gradients(variant):
    jcfg = {"one_class": JCFG, "two_classes": JCFG2,
            "angle_vector": dataclasses.replace(JCFG2, encode_angle_to_vector=True)}[variant]
    boxes, cls, valid = gt_batch(11, classes=(1,) if variant == "one_class" else (1, 2))
    janc, jmt, jut, jcls = jcfg.make_anchors()
    tgt = jax.vmap(lambda g, c, v: janchors.assign_targets(
        janc, jcls, jmt, jut, g, c, v, encode_angle_to_vector=jcfg.encode_angle_to_vector))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid))
    a = janc.shape[0]
    rng = np.random.RandomState(0)
    preds = {"box": rng.randn(2, a, jcfg.box_code_size).astype(np.float32) * 0.3,
             "cls": rng.randn(2, a, jcfg.num_classes).astype(np.float32),
             "dir": rng.randn(2, a, 2).astype(np.float32)}
    (want, wm), wg = jax.value_and_grad(lambda p: jvoxelnet_loss(p, tgt, jcfg), has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: t(v).requires_grad_(True) for k, v in preds.items()}
    ttgt = {k: t(np.asarray(v)) for k, v in tgt.items()}
    got, gm = voxelnet_loss(tp, ttgt, port_config(jcfg))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5)
    assert float(wm["num_pos"]) >= 1
    for k in preds:
        close(tp[k].grad, wg[k], 1e-5, floor=1e-12)


# ------------------------------------------------------------------ whole slice


def flax_init(module, *inputs, seed=0):
    return jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs))


def grads_as_flax(model):
    """The module's gradients under flax's names and layouts."""
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(shadow.parameters(), model.parameters()):
            assert q.grad is not None
            p.copy_(q.grad)
    return export_flax_params(shadow)["params"]


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): np.asarray(v)})
    return out


def pillars_batch():
    gts = [[(2, 3, 0, 2, 4, 1.6, 0.3), (-5, -6, 0, 2, 4, 1.6, -0.7)], [(6, -4, 0, 2, 4, 1.6, 1.2)]]
    clouds = [make_cloud(g, seed=i) for i, g in enumerate(gts)]
    n = min(len(c) for c in clouds)
    boxes = np.zeros((2, 4, 7), np.float32)
    valid = np.zeros((2, 4), bool)
    for b, g in enumerate(gts):
        boxes[b, : len(g)] = g
        valid[b, : len(g)] = True
    return {"points": np.stack([c[:n] for c in clouds]), "points_valid": np.ones((2, n), bool),
            "gt_boxes": boxes, "gt_classes": np.ones((2, 4), np.int32), "gt_valid": valid}


def sparse_batch():
    clouds = [one_point_cloud(s, 700) for s in (3, 4)]
    n = min(len(c) for c in clouds)
    boxes = np.zeros((2, 3, 7), np.float32)
    boxes[:, :2] = [(2, 3, 0, 1, 2, 1, 0.3), (-4, -3, 0, 1, 2, 1, -1.2)]
    valid = np.broadcast_to(np.arange(3) < 2, (2, 3)).copy()
    return {"points": np.stack([c[:n] for c in clouds]), "points_valid": np.ones((2, n), bool),
            "gt_boxes": boxes, "gt_classes": np.ones((2, 3), np.int32), "gt_valid": valid}


# Room for every point of a pillar: the JAX voxelizer's unstable sort keeps
# other points of an overfull voxel than the port's stable one.
JPILLARS = dataclasses.replace(JCFG, max_points_per_voxel=32)

SLICES = {
    "pillars": (JPILLARS, pillars_batch),
    "pillars_area_mask": (dataclasses.replace(JPILLARS, anchor_area_threshold=1.0), pillars_batch),
    "sparse_units": (JSPARSE, sparse_batch),
    "sparse": (dataclasses.replace(JSPARSE, middle="sparse"), sparse_batch),
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_second_loss_fn_loss_metrics_and_every_gradient_match_jax(name):
    jcfg, make_batch = SLICES[name]
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, jcfg.grid, jcfg.max_voxels,
                                              jcfg.max_points_per_voxel))(jb["points"], jb["points_valid"])
    jmodel = JVoxelNet(jcfg, dtype=jnp.float32)
    variables = flax_init(jmodel, *[vox[k] for k in ("voxels", "num_points", "coords", "voxel_valid")])
    jloss_fn = jtrain.make_second_loss_fn(jcfg)
    assert int(vox["num_points"].max()) < jcfg.max_points_per_voxel or jcfg.max_points_per_voxel == 1
    (want, wm), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jmodel, p, b, None), has_aux=True))(variables, jb)

    cfg = port_config(jcfg)
    model = load_flax_params(VoxelNet(cfg, in_features=batch["points"].shape[-1]), variables).train()
    loss_fn = ttrain.make_second_loss_fn(cfg, device="cpu")
    got, gm = loss_fn(model, {k: t(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, atol=1e-7)
    assert float(wm["num_pos"]) >= 1
    want_flat, got_flat = flat(jax.device_get(wgrads)["params"]), flat(grads_as_flax(model))
    assert set(want_flat) == set(got_flat)
    top = max(float(np.abs(w).max()) for w in want_flat.values())
    for path, w in want_flat.items():
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(got_flat[path], w, rtol=0, err_msg="/".join(path),
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-3 * top))


def test_trained_model_is_put_in_eval_and_detects_as_before():
    """``make_second_infer_fn`` on a model left in ``train()`` mode with
    gradients on its parameters: eval mode, no graph, and the detections of
    the same weights before any training-mode call."""
    cfg = port_config(JPILLARS)
    batch = {k: t(v) for k, v in pillars_batch().items()}
    model = VoxelNet(cfg, generator=torch.Generator().manual_seed(3))
    before = tsecond.make_second_infer_fn(model, cfg)(batch["points"], batch["points_valid"])
    model.train()
    loss, _ = ttrain.make_second_loss_fn(cfg, device="cpu")(model, batch)
    loss.backward()
    assert model.training and all(p.grad is not None for p in model.parameters())
    infer = tsecond.make_second_infer_fn(model, cfg)
    assert not model.training
    after = infer(batch["points"], batch["points_valid"])
    for k in before:
        assert torch.equal(before[k], after[k]) and not after[k].requires_grad


@pytest.mark.parametrize("make", ["make_second_targets_fn", "make_second_loss_fn"])
def test_training_fns_take_the_card_by_default(make, monkeypatch):
    """Without a device the targets and loss functions are for the card, as
    ``train_second`` is: without one they raise; ``device="cpu"`` builds the
    anchors on the CPU."""
    cfg = port_config(JPILLARS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"{make}: no CUDA device found"):
        getattr(ttrain, make)(cfg)
    made = []
    make_anchors = type(cfg).make_anchors

    def recording(self, device=None):
        made.append(make_anchors(self, device))
        return made[-1]

    monkeypatch.setattr(type(cfg), "make_anchors", recording)
    fn = getattr(ttrain, make)(cfg, device="cpu")
    assert len(made) == 1 and all(a.device.type == "cpu" for a in made[0])
    batch = {k: t(v) for k, v in pillars_batch().items()}
    if make == "make_second_targets_fn":
        vox, tgts = fn(batch)
        assert all(v.device.type == "cpu" for v in tgts.values() if isinstance(v, torch.Tensor))
