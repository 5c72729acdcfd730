"""Port parity of PointRCNN's training targets and losses: the 3D rotated
IoU, the bin encoder and its loss, the RPN's point labels and loss, RoI
sampling, RoI noise and the RCNN loss, against the JAX package on the same
numpy inputs (float32, CPU), and ``SharedMLP(norm="batch")`` with its fold.

Tolerances: IoUs 1e-4 (shoelace cancellation, ROADMAP §C); bin labels,
point labels, target masks, assigned boxes and noise choices equal, on
inputs whose IoUs lie 1e-4 or more from every threshold (asserted);
residuals 1e-6; losses and their gradients 1e-5 (a logit of exactly 0 and
one at the −20 floor among them). The random numbers of RoI sampling and
noise are drawn with ``jax.random`` as the JAX functions draw them and fed to
the port. BatchNorm in train mode: outputs and running statistics 1e-5; the
fold exact up to re-association (1e-5)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyft3d_tpu.models.pointrcnn import modules as jmod
from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.models import fold_bn as jfold
from lyft3d_tpu.ops import bin_coder as jbin
from lyft3d_tpu.ops import rotated_iou as jiou
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.models.pointrcnn import modules as tmod
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.ops import bin_coder as tbin
from lyft3d_tpu_torch.ops import rotated_iou as tiou
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

LYFT = jnet.lyft_pointrcnn_config("train")
TLYFT = tnet.lyft_pointrcnn_config("train")
THRESHOLDS = (LYFT.fg_iou, LYFT.bg_iou, LYFT.bg_iou_lo)
IOU_3D = jax.jit(jiou.rotated_iou_3d)
PAIRED_IOU_3D = jax.jit(jnet._elementwise_iou3d)


def t(a):
    return torch.from_numpy(np.array(a))


def cars(rng, n, spread=20.0):
    """``n`` car-sized boxes with random centres and yaw."""
    return np.column_stack([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1.5, 0.5, n),
        np.array([1.93, 4.76, 1.72]) * rng.uniform(0.8, 1.2, (n, 3)), rng.uniform(-math.pi, math.pi, n),
    ]).astype(np.float32)


def jitter(rng, boxes, loc, size, yaw):
    out = boxes.copy()
    out[:, :3] += rng.uniform(-loc, loc, (len(boxes), 3))
    out[:, 3:6] *= rng.uniform(1 - size, 1 + size, (len(boxes), 3))
    out[:, 6] += rng.uniform(-yaw, yaw, len(boxes))
    return out.astype(np.float32)


# ------------------------------------------------------------------ IoU


def test_rotated_iou_3d_matches_jax():
    """Pairwise (unbatched and batched) and row by row, on boxes near each
    other (partial overlaps, vertical offsets) and far apart."""
    rng = np.random.RandomState(0)
    gt = cars(rng, 6, spread=6.0)
    rois = np.concatenate([jitter(rng, np.repeat(gt, 3, 0), 0.8, 0.2, 0.4), cars(rng, 6, spread=6.0)])
    want = np.asarray(IOU_3D(rois, gt))
    got = tiou.rotated_iou_3d(t(rois), t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want > 0.3).sum() >= 6 and (want == 0).sum() > 20
    batched = tiou.rotated_iou_3d(t(np.stack([rois, rois[::-1]])), t(np.stack([gt, gt])))
    np.testing.assert_allclose(batched[1].numpy(), want[::-1], rtol=0, atol=1e-4)

    paired = rois[: len(gt)]
    want_rows = np.asarray(PAIRED_IOU_3D(paired, gt))
    np.testing.assert_allclose(tiou.rotated_iou_3d_paired(t(paired), t(gt)).numpy(), want_rows,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(want_rows, np.diag(want[: len(gt)]), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ bin coder


def coder_inputs(rng, n, coder):
    """Anchors and boxes with offsets on every location-bin edge and
    headings on every heading-bin edge, beside random ones."""
    anchors = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    gt = cars(rng, n, spread=10.0)
    gt[:, :3] = anchors + rng.uniform(-coder.loc_scope - 1, coder.loc_scope + 1, (n, 3))
    edges = np.arange(coder.num_loc_bins + 1, dtype=np.float32) * coder.loc_bin_size - coder.loc_scope
    k = len(edges)
    gt[:k, 0] = anchors[:k, 0] + edges
    gt[k: 2 * k, 1] = anchors[k: 2 * k, 1] + edges
    step = np.float32(2 * np.pi / coder.num_head_bin)
    h = coder.num_head_bin
    gt[:h, 6] = np.arange(h, dtype=np.float32) * step
    gt[h: 2 * h, 6] = np.arange(h, dtype=np.float32) * step - np.float32(2 * np.pi)
    return anchors, gt


@pytest.mark.parametrize("which", ["rpn", "rcnn", "class_table"])
def test_encode_bin_targets_matches_jax(which):
    coder = {"rpn": LYFT.rpn_coder, "rcnn": LYFT.rcnn_coder, "class_table": LYFT.rpn_coder}[which]
    tcoder = {"rpn": TLYFT.rpn_coder, "rcnn": TLYFT.rcnn_coder, "class_table": TLYFT.rpn_coder}[which]
    rng = np.random.RandomState(1)
    anchors, gt = coder_inputs(rng, 64, coder)
    ids = rng.randint(0, 9, 64).astype(np.int32) if which == "class_table" else None
    want = jax.jit(lambda a, g, i: jbin.encode_bin_targets(a, g, coder, i))(anchors, gt, ids)
    got = tbin.encode_bin_targets(t(anchors), t(gt), tcoder, None if ids is None else t(ids))
    assert got.keys() == want.keys()
    for key in ("x_bin", "y_bin", "head_bin"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert len(np.unique(np.asarray(want[key]))) > 4
    for key in ("x_res", "y_res", "head_res", "z_res", "size_res"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6, err_msg=key)


def value_and_grads(torch_fn, jax_fn, arrays, wrt):
    """The loss and its gradient with respect to ``wrt`` (names of
    ``arrays``) in both packages."""
    want, jgrads = jax.jit(jax.value_and_grad(lambda *w: jax_fn(dict(arrays, **dict(zip(wrt, w)))),
                                              argnums=tuple(range(len(wrt)))))(*[arrays[k] for k in wrt])
    leaves = {k: t(arrays[k]).clone().requires_grad_(True) for k in wrt}
    got = torch_fn(dict({k: t(v) for k, v in arrays.items()}, **leaves))
    got.backward()
    return float(got.detach()), float(want), {k: (leaves[k].grad.numpy(), np.asarray(g)) for k, g in zip(wrt, jgrads)}


def check_loss(got, want, grads, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol)
    for k, (g, w) in grads.items():
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1e-3, float(np.abs(w).max())), err_msg=k)
        assert np.abs(w).max() > 0, k


def test_bin_reg_loss_value_and_gradient():
    """A batch of two: per-sample denominators (one sample without a
    foreground anchor), the mean over the batch."""
    rng = np.random.RandomState(2)
    coder, tcoder = LYFT.rpn_coder, TLYFT.rpn_coder
    anchors, gt = coder_inputs(rng, 96, coder)
    arrays = {"reg": rng.randn(2, 48, coder.channels).astype(np.float32),
              "fg": np.stack([rng.rand(48) < 0.4, np.zeros(48, bool)]).astype(np.float32)}
    anchors, gt = anchors.reshape(2, 48, 3), gt.reshape(2, 48, 7)

    def jax_fn(a):
        def one(reg, anc, g, fg):
            return jbin.bin_reg_loss(reg, jbin.encode_bin_targets(anc, g, coder), fg, coder)[0]
        return jnp.mean(jax.vmap(one)(a["reg"], anchors, gt, a["fg"]))

    def torch_fn(a):
        tgt = tbin.encode_bin_targets(t(anchors), t(gt), tcoder)
        total, comps = tbin.bin_reg_loss(a["reg"], tgt, a["fg"], tcoder)
        assert total.shape == (2,) and set(comps) == {"loc", "head", "size"}
        return total.mean()

    check_loss(*value_and_grads(torch_fn, jax_fn, arrays, ["reg"]))


# ------------------------------------------------------------------ RPN


def point_cloud(rng, gt, n):
    """Points in and around the boxes and in the open, as (n, 3)."""
    near = np.repeat(gt[:, :3], n // (2 * len(gt)), 0)
    near = near + rng.uniform(-3, 3, near.shape)
    far = rng.uniform(-25, 25, (n - len(near), 3)) * np.array([1, 1, 0.1])
    return np.concatenate([near, far]).astype(np.float32)


def rpn_batch(seed, n=512, g=5):
    rng = np.random.RandomState(seed)
    gt = cars(rng, 2 * g, spread=15.0).reshape(2, g, 7)
    gt[0, 1, :3] = gt[0, 0, :3] + [0.5, 0.3, 0.0]  # overlapping boxes: the first holds
    xyz = np.stack([point_cloud(rng, gt[b], n) for b in range(2)])
    gt_valid = np.ones((2, g), bool)
    gt_valid[1, -1] = False
    return xyz, gt, gt_valid


def test_rpn_point_labels_match_jax():
    xyz, gt, gt_valid = rpn_batch(3)
    want = jax.jit(jax.vmap(jnet.rpn_point_labels))(xyz, gt, gt_valid)
    labels, assigned = tnet.rpn_point_labels(t(xyz), t(gt), t(gt_valid))
    assert labels.dtype == assigned.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(assigned.numpy(), np.asarray(want[1]))
    lab = labels.numpy()
    assert (lab == 1).sum() > 20 and (lab == -1).sum() > 5 and (lab == 0).sum() > 100
    assert set(np.unique(assigned.numpy()[lab == 1])) >= {0, 2}


@pytest.mark.parametrize("zero_logits", [False, True], ids=["random_logits", "logits_at_zero"])
def test_rpn_loss_value_and_gradient(zero_logits):
    """``vmap`` then ``mean`` in JAX against the batched loss: each sample
    keeps its own care and foreground counts."""
    xyz, gt, gt_valid = rpn_batch(4)
    rng = np.random.RandomState(5)
    labels, assigned = (np.asarray(a) for a in jax.vmap(jnet.rpn_point_labels)(xyz, gt, gt_valid))
    arrays = {"cls": rng.randn(*xyz.shape[:2]).astype(np.float32),
              "reg": rng.randn(*xyz.shape[:2], LYFT.rpn_coder.channels).astype(np.float32)}
    if zero_logits:
        arrays["cls"][:, ::3] = 0.0

    def jax_fn(a):
        def one(cls, reg, x, lab, asg, g):
            return jnet.rpn_loss({"cls": cls, "reg": reg}, x, lab, asg, g, LYFT)[0]
        return jnp.mean(jax.vmap(one)(a["cls"], a["reg"], xyz, labels, assigned, gt))

    def torch_fn(a):
        total, metrics = tnet.rpn_loss({"cls": a["cls"], "reg": a["reg"]}, t(xyz), t(labels),
                                       t(assigned), t(gt), TLYFT)
        assert total.shape == (2,) and set(metrics) == {"rpn_cls", "rpn_reg", "loc", "head", "size"}
        return total.mean()

    check_loss(*value_and_grads(torch_fn, jax_fn, arrays, ["cls", "reg"]))


# ------------------------------------------------------------------ RCNN targets


def margin(iou):
    return min(float(np.abs(np.asarray(iou) - th).min()) for th in THRESHOLDS)


def target_case(seed, r=48, g=6):
    """RoIs around GT boxes (foreground and hard background) and apart from
    them (easy background), a few invalid; one GT slot invalid. A RoI whose
    best IoU lies within 1e-4 of a threshold is made invalid too."""
    rng = np.random.RandomState(seed)
    gt = cars(rng, g, spread=12.0)
    around = np.repeat(gt, -(-(r - 12) // g), 0)[: r - 12]
    half = len(around) // 2
    rois = np.concatenate([jitter(rng, around[:half], 0.25, 0.08, 0.1),
                           jitter(rng, around[half:], 0.8, 0.25, 0.5), cars(rng, 12, spread=12.0)])
    gt_valid = np.arange(g) < g - 1
    best = np.asarray(IOU_3D(rois, gt[gt_valid])).max(1)
    near_threshold = np.abs(best[:, None] - np.asarray(THRESHOLDS)).min(1) <= 1e-4
    roi_valid = (rng.rand(r) > 0.1) & ~near_threshold
    return rois, roi_valid, gt, gt_valid


def jax_target_draws(key, r):
    """The uniforms ``proposal_target_layer`` draws from ``key``."""
    return tuple(jax.random.uniform(k, (r,)) for k in jax.random.split(key, 3))


@pytest.mark.parametrize("rois_per_image", [16, 64])
def test_proposal_target_layer_matches_jax(rois_per_image):
    """A batch of two frames; 16 RoIs a frame make the foreground quota and
    the hard pool bind, 64 let the easy pool top up a short hard pool."""
    jcfg = jnet.PointRCNNConfig(rois_per_image=rois_per_image)
    tcfg = tnet.PointRCNNConfig(rois_per_image=rois_per_image)
    cases = [target_case(s) for s in (6, 7)]
    keys = [jax.random.PRNGKey(s) for s in (10, 11)]
    fn = jax.jit(lambda a, b, c, d, k: jnet.proposal_target_layer(a, b, c, d, jcfg, k))
    want = [jax.device_get(fn(*case, key)) for case, key in zip(cases, keys)]
    for w in want:
        assert margin(w["max_iou"][w["max_iou"] >= 0]) > 1e-4
    draws = [jax_target_draws(key, len(cases[0][0])) for key in keys]
    priorities = tuple(torch.stack([t(d[i]) for d in draws]) for i in range(3))
    got = tnet.proposal_target_layer(*(torch.stack([t(c[i]) for c in cases]) for i in range(4)), tcfg,
                                     priorities)
    for b, w in enumerate(want):
        for key in ("assigned_gt", "fg", "keep"):
            np.testing.assert_array_equal(got[key][b].numpy(), w[key], err_msg=key)
        np.testing.assert_allclose(got["max_iou"][b].numpy(), w["max_iou"], rtol=0, atol=1e-4)
        fg_all = w["max_iou"] >= jcfg.fg_iou
        assert w["fg"].sum() > 0 and w["keep"].sum() > w["fg"].sum()
        if rois_per_image == 16:
            assert fg_all.sum() > w["fg"].sum()  # the quota bound
        assert w["keep"].sum() <= rois_per_image


def test_aug_rois_with_noise_matches_jax():
    """Foreground RoIs try up to ten candidates, background ones one; the
    first candidate whose IoU with its GT box reaches 0.55 wins, else the
    last allowed."""
    rng = np.random.RandomState(8)
    rois, _, gt, _ = target_case(9, r=40)
    assigned = np.asarray(IOU_3D(rois, gt)).argmax(1)
    gt_of = gt[assigned]
    fg = rng.rand(len(rois)) < 0.6
    key = jax.random.PRNGKey(12)
    want = np.asarray(jax.jit(lambda r, k, g, f: jnet.aug_rois_with_noise(r, k, gt_of_rois=g, fg=f))(
        rois, key, gt_of, fg))
    k_keep, k_loc, k_size, k_yaw = jax.random.split(key, 4)
    a = 10
    noise = {"keep": jax.random.uniform(k_keep, (40, a)),
             "loc": jax.random.uniform(k_loc, (40, a, 3), minval=-0.5, maxval=0.5),
             "size": jax.random.uniform(k_size, (40, a, 3), minval=-0.15, maxval=0.15),
             "yaw": jax.random.uniform(k_yaw, (40, a), minval=-float(jnp.pi) / 12, maxval=float(jnp.pi) / 12)}
    cand_iou = np.asarray(PAIRED_IOU_3D(
        np.concatenate([
            np.repeat(rois, a, 0)[:, :3] + np.asarray(noise["loc"]).reshape(-1, 3),
            np.maximum(np.repeat(rois, a, 0)[:, 3:6] * (1 + np.asarray(noise["size"]).reshape(-1, 3)), 0.1),
            np.repeat(rois, a, 0)[:, 6:] + np.asarray(noise["yaw"]).reshape(-1, 1)], 1),
        np.repeat(gt_of, a, 0)))
    assert np.abs(cand_iou - LYFT.fg_iou).min() > 1e-4
    got = tnet.aug_rois_with_noise(t(rois)[None], {k: t(v)[None] for k, v in noise.items()},
                                   gt_of_rois=t(gt_of)[None], fg=t(fg)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)
    moved = (want != rois).any(1)
    assert moved.sum() > 10 and (~moved).sum() > 0  # jittered, and some kept as they were
    # The port's own draws: the JAX shapes and ranges.
    drawn = tnet.draw_roi_noise((2, 40), 10, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        "keep": (2, 40, 10), "loc": (2, 40, 10, 3), "size": (2, 40, 10, 3), "yaw": (2, 40, 10)}
    assert float(drawn["loc"].abs().max()) <= 0.5 and float(drawn["size"].abs().max()) <= 0.15
    assert float(drawn["yaw"].abs().max()) <= math.pi / 12 and 0 <= float(drawn["keep"].min())


@pytest.mark.parametrize("logits", ["random", "at_zero_and_floor"])
def test_rcnn_loss_value_and_gradient(logits):
    """The inline BCE over kept RoIs with logits floored at −20, and the
    canonical-frame bin regression over the sampled foreground, a batch of
    two frames against ``vmap`` then ``mean``."""
    rng = np.random.RandomState(13)
    cases = [target_case(s, r=32) for s in (14, 15)]
    rois = np.stack([c[0] for c in cases])
    gt = np.stack([c[2] for c in cases])
    targets = {"assigned_gt": rng.randint(0, 6, (2, 32)).astype(np.int32),
               "fg": rng.rand(2, 32) < 0.3, "keep": rng.rand(2, 32) < 0.7}
    targets["keep"] |= targets["fg"]
    arrays = {"cls": rng.randn(2, 32).astype(np.float32),
              "reg": rng.randn(2, 32, LYFT.rcnn_coder.channels).astype(np.float32)}
    if logits == "at_zero_and_floor":
        arrays["cls"][:, :8] = 0.0
        arrays["cls"][:, 8:10] = -25.0
        arrays["cls"][:, 10] = -20.0
        targets["keep"][:, :11] = True

    def jax_fn(a):
        def one(cls, reg, ro, tg, g):
            return jnet.rcnn_loss({"cls": cls, "reg": reg}, ro, tg, g, LYFT)[0]
        return jnp.mean(jax.vmap(one)(a["cls"], a["reg"], rois, targets, gt))

    def torch_fn(a):
        total, metrics = tnet.rcnn_loss({"cls": a["cls"], "reg": a["reg"]}, t(rois),
                                        {k: t(v) for k, v in targets.items()}, t(gt), TLYFT)
        assert total.shape == (2,) and set(metrics) == {"rcnn_cls", "rcnn_reg"}
        return total.mean()

    check_loss(*value_and_grads(torch_fn, jax_fn, arrays, ["cls", "reg"]))


# ------------------------------------------------------------------ BatchNorm


@pytest.fixture(scope="module")
def batch_mlp():
    """A flax SharedMLP(norm="batch") with random statistics and affine
    parameters, and its input."""
    x = np.random.RandomState(16).randn(3, 7, 5, 6).astype(np.float32) * 2 + 1
    fm = jmod.SharedMLP([8, 12], norm="batch")
    v = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(17)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.3 * np.abs(rng.randn(*a.shape)).astype(np.float32), v)
    return fm, v, x


def test_shared_mlp_batch_norm_train_and_eval_match_flax(batch_mlp):
    """Train mode: flax's statistics over every dimension but the last, and
    the running statistics after the step; eval mode: the running ones."""
    fm, v, x = batch_mlp
    tm = load_flax_params(tmod.SharedMLP(6, [8, 12], norm="batch"), v)
    want_eval = np.asarray(fm.apply(v, jnp.asarray(x)))
    want_train, updated = fm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    got_train = tm.train()(t(x))
    np.testing.assert_allclose(got_train.detach().numpy(), np.asarray(want_train), rtol=0, atol=1e-5)
    stats = export_flax_params(tm)["batch_stats"]
    for layer, leaves in jax.device_get(updated["batch_stats"]).items():
        for name, want in leaves.items():
            np.testing.assert_allclose(stats[layer][name], want, rtol=1e-5, atol=1e-6)
    tm = load_flax_params(tmod.SharedMLP(6, [8, 12], norm="batch"), v).eval()
    np.testing.assert_allclose(tm(t(x)).detach().numpy(), want_eval, rtol=0, atol=1e-5)
    assert not np.allclose(want_eval, np.asarray(want_train), atol=1e-2)


def test_shared_mlp_batch_norm_fold_is_exact(batch_mlp):
    """The fold of a trained SharedMLP is the "folded" structure, equal in
    eval mode up to re-association, and equal to the JAX package's fold."""
    fm, v, x = batch_mlp
    tm = load_flax_params(tmod.SharedMLP(6, [8, 12], norm="batch"), v).eval()
    folded = fold_batch_norms(tm)
    assert set(folded.state_dict()) == set(tmod.SharedMLP(6, [8, 12], norm="folded").state_dict())
    np.testing.assert_allclose(folded(t(x)).detach().numpy(), tm(t(x)).detach().numpy(), rtol=0, atol=1e-5)
    want = jax.device_get(jfold.fold_batch_norms(v))
    got = export_flax_params(folded)
    for layer, leaves in want["params"].items():
        for name, w in leaves.items():
            np.testing.assert_allclose(got["params"][layer][name], w, rtol=1e-6, atol=1e-6)
    assert isinstance(tm.norms[0], torch.nn.BatchNorm2d) and isinstance(folded.norms[0], torch.nn.Identity)


def test_rpn_with_batch_norm_and_its_fold_match_jax():
    """A small ``PointRCNN_RPN(norm="batch")`` with random running
    statistics, in eval mode, against flax's (1e-4 of each output's scale);
    its fold equals it (1e-5) and equals the JAX package's fold carried into
    the ``norm="folded"`` RPN (1e-6)."""
    tiny = dict(sa_npoints=(64, 16), sa_radii=((1.5,), (3.0,)), sa_nsamples=((8,), (8,)), sa_widths=(16, 32),
                fp_width=16)
    jcfg, tcfg = jnet.PointRCNNConfig(**tiny), tnet.PointRCNNConfig(**tiny)
    rng = np.random.RandomState(18)
    xyz = rng.uniform(-6, 6, (256, 3)).astype(np.float32)
    feats, valid = np.zeros((256, 1), np.float32), np.arange(256) < 240
    jm = jnet.PointRCNN_RPN(jcfg, norm="batch")
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), xyz, feats, valid))
    v = {"params": jax.tree_util.tree_map(lambda a: np.asarray(a) * rng.uniform(0.8, 1.2, a.shape).astype(np.float32),
                                          v["params"]),
         "batch_stats": jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * rng.rand(*a.shape).astype(np.float32),
                                               v["batch_stats"])}
    want = jax.device_get(jax.jit(jm.apply)(v, xyz, feats, valid))
    tm = load_flax_params(tnet.PointRCNN_RPN(tcfg, norm="batch"), v).eval()
    with torch.no_grad():
        got = tm(t(xyz)[None], t(feats)[None], t(valid)[None])
        for k in ("point_features", "cls", "reg"):
            scale = max(1.0, float(np.abs(want[k]).max()))
            np.testing.assert_allclose(got[k][0].numpy(), want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
        folded = fold_batch_norms(tm)
        again = folded(t(xyz)[None], t(feats)[None], t(valid)[None])
    for k in ("point_features", "cls", "reg"):
        np.testing.assert_allclose(again[k].numpy(), got[k].numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(got[k].abs().max())), err_msg=k)
    carried = load_flax_params(tnet.PointRCNN_RPN(tcfg, norm="folded"), jax.device_get(jfold.fold_batch_norms(v)))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    for (k, a), (k2, b) in zip(folded.state_dict().items(), carried.state_dict().items()):
        assert k == k2
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
