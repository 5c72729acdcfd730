"""Port parity for the SECOND pillars modules: ``voxelize``, anchors, box
decoding, rotated IoU and NMS, LayerNorm, ``PillarFeatureNet``,
``pillar_scatter``, ``RPN``, ``VoxelNet`` and ``voxelnet_predict``, each
against the JAX function on the same numpy inputs (and, for modules, the
same flax weights carried over by ``load_flax_params``).

Tolerances:

- exact: voxel coords, counts, validity and slot maps; anchors (bit-equal);
  the canvas of ``pillar_scatter``; NMS keep masks and selections, under a
  guard that no IoU of the JAX run lies within 1e-4 of the threshold (a
  difference in the last bit could flip it otherwise).
- voxel contents compare as sets of rows per voxel, on clouds where no voxel
  holds more points than its cap: the JAX voxelizer's sort is unstable, so
  which points an overflowing voxel keeps, and their order, are not a
  contract.
- float32 arithmetic in another order (sums over points, convolutions,
  XLA vs oneDNN): 1e-5 for elementwise box math; 1e-4 for IoUs, whose
  shoelace sums of metre-scale world coordinates cancel (seen: 1.3e-5);
  1e-4 of the output scale for the networks.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.models import layers as jlayers
from lyft3d_tpu.models.second import voxel_encoder as jenc
from lyft3d_tpu.models.second.rpn import RPN as JRPN
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.models.second.voxelnet import VoxelNetConfig as JConfig
from lyft3d_tpu.models.second.voxelnet import voxelnet_predict as jpredict
from lyft3d_tpu.ops import anchors as janchors
from lyft3d_tpu.ops import box_ops as jbox
from lyft3d_tpu.ops import nms as jnms
from lyft3d_tpu.ops import rotated_iou as jiou
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu_torch.models.layers import LayerNorm, resize_to
from lyft3d_tpu_torch.models.second.rpn import RPN
from lyft3d_tpu_torch.models.second.voxel_encoder import PillarFeatureNet, pillar_scatter
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig, voxelnet_predict
from lyft3d_tpu_torch.ops import anchors as tanchors
from lyft3d_tpu_torch.ops import box_ops as tbox
from lyft3d_tpu_torch.ops import nms as tnms
from lyft3d_tpu_torch.ops import rotated_iou as tiou
from lyft3d_tpu_torch.ops import voxelize as tvox
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_second import CFG as JCFG  # noqa: E402  the JAX suite's small config
from test_second import make_cloud  # noqa: E402

NET_TOL = 1e-4
BOX_TOL = 1e-5
IOU_TOL = 1e-4
NMS_MARGIN = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def port_config(jcfg: JConfig, **changes) -> VoxelNetConfig:
    """The port's config with the JAX config's values for every shared field."""
    names = {f.name for f in dataclasses.fields(VoxelNetConfig)}
    kw = {k: getattr(jcfg, k) for k in names}
    kw["grid"] = tvox.VoxelGrid(*jcfg.grid)
    kw["anchor_specs"] = tuple(tanchors.AnchorSpec(*s) for s in jcfg.anchor_specs)
    kw.update(changes)
    return VoxelNetConfig(**kw)


CFG = port_config(JCFG)


# ---------------------------------------------------------------- voxelize


def cloud(seed, n, spread=18.0):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-4.0, 6.0, (n, 1)), rng.rand(n, 1),
    ], axis=1).astype(np.float32)
    # Points exactly on voxel edges (x = k·1.0 − 16) and beyond the range.
    pts[: n // 20, 0] = np.arange(n // 20) % 33 - 16.0
    return pts, rng.rand(n) > 0.1


def assert_same_voxels(want, got, cap):
    for k in ("coords", "num_points", "voxel_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert np.asarray(want["num_points"]).max() < cap, "a voxel overflowed its point cap"
    wv, gv = np.asarray(want["voxels"]), got["voxels"].numpy()
    for s in range(wv.shape[0]):  # each voxel's rows as a set
        np.testing.assert_array_equal(
            np.sort(gv[s].view([("", gv.dtype)] * gv.shape[-1]), axis=0),
            np.sort(wv[s].view([("", wv.dtype)] * wv.shape[-1]), axis=0),
        )


@pytest.mark.parametrize("n,max_voxels,cap,overflow",
                         [(600, 512, 32, False), (3000, 64, 64, True), (40, 256, 8, False)],
                         ids=["fits", "overflow_voxels", "fewer_points_than_slots"])
def test_voxelize_matches_jax(n, max_voxels, cap, overflow):
    pts, valid = cloud(n, n)
    grid = JCFG.grid
    want = jvox.voxelize(jnp.asarray(pts), jnp.asarray(valid), grid, max_voxels, cap,
                         need_point_voxel=True)
    got = tvox.voxelize(t(pts), t(valid), tvox.VoxelGrid(*grid), max_voxels, cap,
                        need_point_voxel=True)
    assert_same_voxels(want, got, cap)
    np.testing.assert_array_equal(got["point_voxel"].numpy(), np.asarray(want["point_voxel"]))
    occupied = len(np.unique(np.asarray(jvox.voxelize(
        jnp.asarray(pts), jnp.asarray(valid), grid, 10 * n, cap)["coords"])[:, :2], axis=0))
    assert (occupied > max_voxels) == overflow  # the even-spread path runs where intended


def test_voxelize_batched_equals_per_sample_and_grid_size():
    grid = tvox.VoxelGrid((-49.6, -49.6, -5.0, 49.6, 49.6, 3.0), (0.2, 0.2, 8.0))
    assert grid.grid_size == jvox.VoxelGrid(*grid).grid_size == (496, 496, 1)
    pts = np.stack([cloud(s, 500)[0] for s in (1, 2)])
    valid = np.stack([cloud(s, 500)[1] for s in (1, 2)])
    batch = tvox.voxelize(t(pts), t(valid), CFG.grid, 128, 16)
    for b in range(2):
        one = tvox.voxelize(t(pts[b]), t(valid[b]), CFG.grid, 128, 16)
        for k in batch:
            assert torch.equal(batch[k][b], one[k]), k


def test_voxelize_all_invalid_and_block_filtering():
    out = tvox.voxelize(torch.zeros(10, 4), torch.zeros(10, dtype=torch.bool), CFG.grid, 4, 2,
                        need_point_voxel=True)
    assert not out["voxel_valid"].any() and (out["point_voxel"] == -1).all()
    assert (out["voxels"] == 0).all() and (out["num_points"] == 0).all()
    # Block filtering drops a block's lowest point and those within the
    # height threshold of it (parity with JAX: test_torch_second_sparse.py).
    pts = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.6, 0.6, 0.1, 0.0], [0.7, 0.7, 1.0, 0.0]])
    out = tvox.voxelize(pts, torch.ones(3, dtype=torch.bool),
                        CFG.grid._replace(block_filtering=True), 4, 4)
    assert int(out["num_points"].sum()) == 1 and float(out["voxels"][0, 0, 2]) == 1.0


# ------------------------------------------------------ anchors and boxes


LYFT9 = [((1.93, 4.76, 1.72), -1.07, 0.6, 0.45), ((0.96, 2.35, 1.59), -1.29, 0.5, 0.3),
         ((2.96, 12.34, 3.44), -0.36, 0.55, 0.4), ((0.77, 0.81, 1.78), -0.91, 0.5, 0.35)]


@pytest.mark.parametrize("hw,point_range,specs", [
    ((62, 62), (-49.6, -49.6, -5.0, 49.6, 49.6, 3.0), LYFT9),
    ((16, 16), JCFG.grid.point_cloud_range, [tuple(JCFG.anchor_specs[0])[:4]]),
    ((5, 7), (-3.3, -10.0, -1.0, 12.1, 4.4, 2.0), LYFT9[:2]),
], ids=["lyft9_62", "small_cfg", "odd_grid"])
def test_anchors_bit_equal(hw, point_range, specs):
    jspecs = [janchors.AnchorSpec(*s, class_id=i + 1) for i, s in enumerate(specs)]
    tspecs = [tanchors.AnchorSpec(*s, class_id=i + 1) for i, s in enumerate(specs)]
    want = janchors.generate_anchors(hw, point_range, jspecs)
    got = tanchors.generate_anchors(hw, point_range, tspecs)
    for w, g in zip(want, got):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_limit_period_corners():
    rng = np.random.RandomState(17)
    anchors = np.concatenate([rng.uniform(-40, 40, (256, 3)), rng.uniform(0.3, 12, (256, 3)),
                              rng.uniform(-np.pi, np.pi, (256, 1))], 1).astype(np.float32)
    deltas = rng.normal(0, 0.5, (256, 7)).astype(np.float32)
    np.testing.assert_allclose(tbox.decode_boxes(t(deltas), t(anchors)).numpy(),
                               np.asarray(jbox.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors))),
                               rtol=BOX_TOL, atol=BOX_TOL)
    yaw = rng.uniform(-20, 20, 1000).astype(np.float32)
    for offset, period in ((0.5, np.pi), (0.5, 2 * np.pi), (0.0, np.pi)):
        np.testing.assert_allclose(tbox.limit_period(t(yaw), offset, period).numpy(),
                                   np.asarray(jbox.limit_period(jnp.asarray(yaw), offset, period)),
                                   atol=BOX_TOL)
    bev = anchors[:, [0, 1, 3, 4, 6]]
    corners = tbox.box_corners_2d(t(bev))
    np.testing.assert_allclose(corners.numpy(), np.asarray(jbox.box_corners_2d(jnp.asarray(bev))),
                               atol=BOX_TOL)
    np.testing.assert_allclose(
        tbox.corners_to_standup_2d(corners).numpy(),
        np.asarray(jbox.corners_to_standup_2d(jbox.box_corners_2d(jnp.asarray(bev)))), atol=BOX_TOL)


# ----------------------------------------------------------- IoU and NMS


def bev(*rows):
    return np.array(rows, np.float32)


GOLDEN = [
    (bev([1.0, 2.0, 2.0, 3.0, 0.4]), bev([1.0, 2.0, 2.0, 3.0, 0.4]), 1.0),
    (bev([0, 0, 1, 1, 0]), bev([10, 10, 1, 1, 0.5]), 0.0),
    (bev([0, 0, 2, 2, 0]), bev([1, 0, 2, 2, 0]), 1 / 3),
    (bev([0, 0, 1, 1, 0]), bev([0, 0, 1, 1, np.pi / 4]), 2 * (np.sqrt(2) - 1) / (2 - 2 * (np.sqrt(2) - 1))),
    (bev([0, 0, 4, 4, 0.3]), bev([0, 0, 1, 2, 1.1]), 2.0 / 16.0),
]


@pytest.mark.parametrize("b1,b2,iou", GOLDEN, ids=["same", "disjoint", "half", "octagon", "contained"])
def test_rotated_iou_golden(b1, b2, iou):
    got = float(tiou.rotated_iou_bev(t(b1), t(b2))[0, 0])
    want = float(jiou.rotated_iou_bev(jnp.asarray(b1), jnp.asarray(b2))[0, 0])
    assert abs(got - iou) < 1e-5 and abs(got - want) < 1e-6


def random_boxes(rng, n, spread=6.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)), rng.uniform(0.5, 4.0, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_random_and_batched(criterion):
    rng = np.random.RandomState(5 + criterion)
    b1, b2 = random_boxes(rng, 70), random_boxes(rng, 50)
    want = np.asarray(jiou.rotated_iou_bev(jnp.asarray(b1), jnp.asarray(b2), criterion))
    got = tiou.rotated_iou_bev(t(b1), t(b2), criterion).numpy()
    np.testing.assert_allclose(got, want, atol=IOU_TOL)
    assert (want > 0.05).mean() > 0.05  # the test exercises real overlaps
    both = tiou.rotated_iou_bev(t(np.stack([b1, b1[::-1]])), t(np.stack([b2, b2])), criterion)
    np.testing.assert_allclose(both[0].numpy(), got, atol=1e-7)
    np.testing.assert_allclose(both[1].numpy(), got[::-1], atol=1e-7)
    s1 = jbox.corners_to_standup_2d(jbox.box_corners_2d(jnp.asarray(b1)))
    s2 = jbox.corners_to_standup_2d(jbox.box_corners_2d(jnp.asarray(b2)))
    np.testing.assert_allclose(tiou.standup_iou(t(np.asarray(s1)), t(np.asarray(s2))).numpy(),
                               np.asarray(jiou.standup_iou(s1, s2)), atol=BOX_TOL)


def assert_margin(iou, threshold):
    """NMS decisions are discrete: no IoU may lie at the threshold."""
    gap = np.abs(np.asarray(iou) - threshold).min()
    assert gap > NMS_MARGIN, f"an IoU is {gap:.2e} from the threshold"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_nms_and_select_top_k(seed):
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, 120, spread=5.0)
    scores = rng.rand(120).astype(np.float32)
    scores[:10] = scores[10]  # ties resolve to the lower index in both
    valid = rng.rand(120) > 0.2
    thr = 0.3
    assert_margin(jiou.rotated_iou_bev(jnp.asarray(boxes), jnp.asarray(boxes)), thr)
    want = np.asarray(jnms.rotated_nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                                       valid=jnp.asarray(valid)))
    got = tnms.rotated_nms(t(boxes), t(scores), thr, valid=t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 5 < want.sum() < valid.sum()  # some suppression happened
    widx, wval = jnms.select_top_k(jnp.asarray(want), jnp.asarray(scores), 64)
    gidx, gval = tnms.select_top_k(t(got), t(scores), 64)
    np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    np.testing.assert_array_equal(gidx.numpy()[gval.numpy()], np.asarray(widx)[np.asarray(wval)])


def test_nms_mask_from_iou_orders():
    boxes = jnp.asarray(bev([0, 0, 2, 2, 0], [1.2, 0, 2, 2, 0], [2.4, 0, 2, 2, 0], [0.2, 0, 2, 2, 0]))
    iou = np.asarray(jiou.rotated_iou_bev(boxes, boxes))
    scores = np.array([0.9, 0.8, 0.7, 0.95], np.float32)
    for presorted in (False, True):
        want = np.asarray(jnms.nms_mask_from_iou(jnp.asarray(iou), jnp.asarray(scores), 0.2,
                                                 presorted=presorted))
        got = tnms.nms_mask_from_iou(t(iou), t(scores), 0.2, presorted=presorted).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- networks


def flax_init(module, *inputs, seed=0):
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs])
    v = jax.device_get(v)
    # Norm scales and biases away from 1/0, so that a mix-up shows.
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, x in node.items():
            if hasattr(x, "items"):
                out[k] = walk(x)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k == "bias":
                out[k] = rng.normal(0, 0.3, x.shape).astype(np.float32)
            else:
                out[k] = np.asarray(x)
        return out

    return walk(v)


def close(got, want, tol=NET_TOL):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("offset", [0.0, 4.0], ids=["centred", "offset_mean"])
def test_layer_norm_matches_flax(offset):
    """Both use the one-pass variance; an input whose mean dwarfs its spread
    (offset 4, std 0.5) shows a two-pass variance apart."""
    from flax import linen as nn

    x = (np.random.RandomState(6).randn(4, 9, 32) * 0.5 + offset).astype(np.float32)
    v = flax_init(nn.LayerNorm(dtype=jnp.float32), x)
    want = np.asarray(nn.LayerNorm(dtype=jnp.float32).apply(v, jnp.asarray(x)))
    ln = LayerNorm(32)
    with torch.no_grad():
        ln.weight.copy_(t(v["params"]["scale"]))
        ln.bias.copy_(t(v["params"]["bias"]))
        close(ln(t(x)).numpy(), want)


def jax_voxels(points, cfg=JCFG, batch=1):
    vox = jvox.voxelize(jnp.asarray(points), jnp.ones(len(points), bool), cfg.grid,
                        cfg.max_voxels, cfg.max_points_per_voxel)
    return [np.broadcast_to(np.asarray(vox[k])[None], (batch,) + vox[k].shape).copy()
            for k in ("voxels", "num_points", "coords", "voxel_valid")]


BOXES = [(2, 3, 0, 2, 4, 1.6, 0.3), (-5, -6, 0, 2, 4, 1.6, -0.7)]


def test_pillar_feature_net_and_scatter():
    vox, nump, coords, valid = jax_voxels(make_cloud(BOXES))
    jm = jenc.PillarFeatureNet(features=(32, 16), voxel_size=(1.0, 1.0), point_range=(-16.0, -16.0),
                               dtype=jnp.float32)
    v = flax_init(jm, vox, nump, coords)
    want = np.asarray(jm.apply(v, jnp.asarray(vox), jnp.asarray(nump), jnp.asarray(coords)))
    tm = load_flax_params(PillarFeatureNet(4, (32, 16), (1.0, 1.0), (-16.0, -16.0)), v)
    with torch.no_grad():
        feats = tm(t(vox), t(nump), t(coords))
    close(feats.numpy(), want)
    canvas = pillar_scatter(feats, t(coords), t(valid), (32, 32), assume_sorted=True)
    want_canvas = np.stack([
        np.asarray(jenc.pillar_scatter(jnp.asarray(f), jnp.asarray(c), jnp.asarray(m), (32, 32),
                                       assume_sorted=True))
        for f, c, m in zip(feats.numpy(), coords, valid)
    ])
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)


@pytest.mark.parametrize("hw_in", [248, 124])
def test_resize_to_shrinks_to_62_like_jax(hw_in):
    """The 9-class RPN's 4x and 2x shrinking resizes."""
    x = np.random.RandomState(hw_in).randn(1, hw_in, hw_in, 3).astype(np.float32)
    want = np.asarray(jlayers.resize_to(jnp.asarray(x), (62, 62)))
    got = resize_to(t(x).permute(0, 3, 1, 2), (62, 62)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rpn_with_shrinking_upsample_strides():
    x = np.random.RandomState(8).randn(2, 32, 32, 16).astype(np.float32)
    kw = dict(layer_nums=(1, 2, 1), layer_strides=(2, 2, 2), num_filters=(16, 32, 32),
              upsample_strides=(0.25, 0.5, 1), num_upsample_filters=(8, 8, 16),
              num_anchors_per_loc=6, num_classes=2)
    jm = JRPN(dtype=jnp.float32, **kw)
    v = flax_init(jm, x)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_flax_params(RPN(16, **kw), v).eval()
    with torch.no_grad():
        got = tm(t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    for k in ("box", "cls", "dir"):
        assert got[k].shape == want[k].shape == (2, 4, 4, {"box": 42, "cls": 12, "dir": 12}[k])
        close(got[k].numpy(), np.asarray(want[k]))


@pytest.fixture(scope="module")
def voxelnet_pair():
    """The JAX suite's small VoxelNet (32x32 grid, 256 voxels, RPN (32, 64)),
    flax-initialised, and the port with the same weights."""
    inputs = jax_voxels(make_cloud(BOXES), batch=2)
    inputs[0][1] *= 0.5  # two different samples
    model = JVoxelNet(JCFG, dtype=jnp.float32)
    v = flax_init(model, *inputs)
    preds = jax.device_get(jax.jit(model.apply)(v, *[jnp.asarray(a) for a in inputs]))
    port = load_flax_params(VoxelNet(CFG, in_features=4), v).eval()
    with torch.no_grad():
        tpreds = port(*[t(a) for a in inputs])
    return preds, {k: x.numpy() for k, x in tpreds.items()}


def test_voxelnet_heads_match(voxelnet_pair):
    want, got = voxelnet_pair
    anchors = CFG.make_anchors()[0]
    for k, width in (("box", 7), ("cls", 1), ("dir", 2)):
        assert got[k].shape == (2, anchors.shape[0], width) == np.asarray(want[k]).shape
        close(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("per_class", [False, True], ids=["single_nms", "per_class_nms"])
def test_voxelnet_predict_matches(per_class):
    """Decode + direction fix + top-k + NMS + post filter on the same random
    head outputs, two anchor classes."""
    spec2 = JCFG.anchor_specs[0]._replace(class_id=2, size=(1.0, 1.0, 2.0))
    jcfg = dataclasses.replace(JCFG, anchor_specs=(JCFG.anchor_specs[0], spec2),
                               per_class_nms=per_class, nms_pre=200, nms_post=150)
    cfg = port_config(jcfg)
    rng = np.random.RandomState(9)
    a = jcfg.make_anchors()[0].shape[0]
    preds = {"box": rng.normal(0, 0.3, (2, a, 7)).astype(np.float32),
             "cls": rng.normal(-1.0, 1.5, (2, a, 1)).astype(np.float32),
             "dir": rng.normal(0, 1, (2, a, 2)).astype(np.float32)}
    janc, _, _, jcls = jcfg.make_anchors()
    want = jax.device_get(jax.vmap(lambda b, c, d: jpredict({"box": b, "cls": c, "dir": d},
                                                            janc, jcls, jcfg))(
        *[jnp.asarray(preds[k]) for k in ("box", "cls", "dir")]))
    # Guard: no candidate pair of the JAX run sits at the NMS threshold.
    from lyft3d_tpu.ops.box_ops import decode_boxes
    for b in range(2):
        scores = 1 / (1 + np.exp(-preds["cls"][b, :, 0]))
        top = np.argsort(-scores, kind="stable")[:200]
        boxes = np.asarray(decode_boxes(jnp.asarray(preds["box"][b]), janc))[top]
        assert_margin(jiou.rotated_iou_bev(jnp.asarray(boxes[:, [0, 1, 3, 4, 6]]),
                                           jnp.asarray(boxes[:, [0, 1, 3, 4, 6]])), jcfg.nms_iou)
    tanc, _, _, tcls = cfg.make_anchors()
    got = voxelnet_predict({k: t(x) for k, x in preds.items()}, tanc, tcls, cfg)
    valid = np.asarray(want["valid"])
    assert 5 < valid.sum(axis=1).min() and valid.sum(axis=1).max() < 150
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], np.asarray(want["classes"])[valid])
    np.testing.assert_allclose(got["scores"].numpy()[valid], np.asarray(want["scores"])[valid],
                               atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], np.asarray(want["boxes"])[valid],
                               atol=BOX_TOL, rtol=BOX_TOL)
    if not per_class:
        assert {1, 2} <= set(got["classes"].numpy()[valid].tolist())
