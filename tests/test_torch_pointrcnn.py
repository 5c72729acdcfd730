"""Port parity: the PointRCNN model of ``lyft3d_tpu_torch`` against the flax
model, on the same numpy inputs and the same weights.

Weights come from ``model.init`` of the flax module plus seeded numpy noise
(so that LayerNorm scales and every bias are not at their defaults) and are
carried over by ``load_flax_params``. Everything runs in float32 on the CPU,
where the port's kernel wrappers use their plain versions. Outputs are held
to a tolerance relative to their scale; sampled indices, proposal sets and
validity masks must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lyft3d_tpu.models.pointrcnn import modules as jmod
from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.ops import bin_coder as jcoder
from lyft3d_tpu_torch.models.pointrcnn import modules as tmod
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.ops import bin_coder as tcoder
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

B, N = 2, 256


def t(x):
    return torch.from_numpy(np.array(x))


def cloud(seed, b=B, n=N, c=0, span=6.0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-span, span, (b, n, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-1.5, 1.0, (b, n))
    valid = np.arange(n)[None, :] < np.array([n, n - n // 8])[:b, None]
    feats = rng.randn(b, n, c).astype(np.float32) if c else None
    return xyz, feats, valid


def noisy(params, seed, scale=0.1):
    """The flax variables plus seeded noise, as numpy arrays."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(np.float32), params)


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def batched(fn, *arrays):
    """vmap an unbatched flax ``apply`` over the leading axis, jitted."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(fn))(*map(jnp.asarray, arrays)))


# ------------------------------------------------------------------ bin coder


CODERS = {
    "default": dict(),
    "lyft_rpn": dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12, mean_size=(1.93, 4.76, 1.72),
                     class_mean_sizes=jnet.LYFT_CLS_MEAN_SIZES),
    "lyft_rcnn": dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, mean_size=(0.77, 0.81, 1.78)),
}


@pytest.mark.parametrize("name", sorted(CODERS))
def test_bin_decoders_match_jax(name):
    jcfg, tcfg = jcoder.BinCoderConfig(**CODERS[name]), tcoder.BinCoderConfig(**CODERS[name])
    assert tcfg.channels == jcfg.channels and tcfg.slices() == jcfg.slices()
    rng = np.random.RandomState(0)
    anchors = rng.uniform(-30, 30, (B, 50, 3)).astype(np.float32)
    reg = rng.randn(B, 50, jcfg.channels).astype(np.float32)
    reg[0, 0, :4] = 0.0  # tied bin logits: the first bin wins in both
    want = np.stack([jcoder.decode_bin_boxes(jnp.asarray(a), jnp.asarray(r), jcfg)
                     for a, r in zip(anchors, reg)])
    close(tcoder.decode_bin_boxes(t(anchors), t(reg), tcfg), want, 1e-5, "decode_bin_boxes")
    rois = np.concatenate([anchors, rng.uniform(1, 5, (B, 50, 3)),
                           rng.uniform(-np.pi, np.pi, (B, 50, 1))], -1).astype(np.float32)
    want = np.stack([jcoder.decode_refined_boxes(jnp.asarray(a), jnp.asarray(r), jcfg)
                     for a, r in zip(rois, reg)])
    close(tcoder.decode_refined_boxes(t(rois), t(reg), tcfg), want, 1e-5, "decode_refined_boxes")
    if jcfg.class_mean_sizes is not None:
        ids = rng.randint(0, 9, (B, 50))
        want = np.stack([jcoder.decode_bin_boxes(jnp.asarray(a), jnp.asarray(r), jcfg, jnp.asarray(i))
                         for a, r, i in zip(anchors, reg, ids)])
        close(tcoder.decode_bin_boxes(t(anchors), t(reg), tcfg, t(ids)), want, 1e-5, "class means")


# -------------------------------------------------------------------- modules


@pytest.mark.parametrize("norm", ["layer", "folded"])
def test_shared_mlp_matches_flax(norm):
    x = np.random.RandomState(1).randn(B, 40, 7).astype(np.float32)
    fm = jmod.SharedMLP([16, 12], norm=norm)
    params = noisy(fm.init(jax.random.PRNGKey(0), jnp.asarray(x[0])), 2)
    tm = load_flax_params(tmod.SharedMLP(7, [16, 12], norm=norm), params).eval()
    want = batched(lambda a: fm.apply(params, a), x)
    with torch.inference_mode():
        close(tm(t(x)), want, 1e-4, f"SharedMLP {norm}")


@pytest.mark.parametrize("norm,c", [("layer", 5), ("folded", 5), ("layer", 0)])
def test_sa_module_msg_matches_flax(norm, c):
    xyz, feats, valid = cloud(3, c=c)
    kw = dict(npoint=32, radii=(1.5, 3.0), nsamples=(4, 8), mlps=[[8, 8], [8, 12]], norm=norm)
    fm = jmod.SAModuleMSG(**kw)
    f0 = None if feats is None else jnp.asarray(feats[0])
    params = noisy(fm.init(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), f0, jnp.asarray(valid[0])), 4)
    tm = load_flax_params(tmod.SAModuleMSG(c, **kw), params).eval()
    if feats is None:
        want = batched(lambda x, v: fm.apply(params, x, None, v), xyz, valid)
    else:
        want = batched(lambda x, f, v: fm.apply(params, x, f, v), xyz, feats, valid)
    with torch.inference_mode():
        new_xyz, new_feats, new_valid = tm(t(xyz), None if feats is None else t(feats), t(valid))
    assert torch.equal(new_xyz, t(want[0]))  # the same sampled points
    assert torch.equal(new_valid, t(want[2]))
    assert new_feats.shape == (B, 32, 20)
    close(new_feats, want[1], 1e-4, "SAModuleMSG")


def test_sa_module_msg_empty_groups_are_zero():
    xyz, feats, valid = cloud(5, c=3)
    kw = dict(npoint=16, radii=(1e-3,), nsamples=(4,), mlps=[[8]], norm="folded")
    fm = jmod.SAModuleMSG(**kw)
    params = noisy(fm.init(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), jnp.asarray(feats[0]),
                           jnp.asarray(valid[0])), 6)
    valid[1, :] = False  # a cloud without a valid point: every group is empty
    tm = load_flax_params(tmod.SAModuleMSG(3, **kw), params).eval()
    want = batched(lambda x, f, v: fm.apply(params, x, f, v), xyz, feats, valid)
    with torch.inference_mode():
        _, new_feats, _ = tm(t(xyz), t(feats), t(valid))
    close(new_feats, want[1], 1e-4, "SAModuleMSG with empty groups")
    assert float(new_feats[1].abs().max()) == 0.0


@pytest.mark.parametrize("norm", ["layer", "folded"])
def test_sa_module_global_matches_flax(norm):
    xyz, feats, valid = cloud(7, c=6)
    fm = jmod.SAModuleGlobal([16], norm=norm)
    params = noisy(fm.init(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), jnp.asarray(feats[0]),
                           jnp.asarray(valid[0])), 8)
    tm = load_flax_params(tmod.SAModuleGlobal(6, [16], norm=norm), params).eval()
    want = batched(lambda x, f, v: fm.apply(params, x, f, v), xyz, feats, valid)
    with torch.inference_mode():
        close(tm(t(xyz), t(feats), t(valid)), want, 1e-4, "SAModuleGlobal")


@pytest.mark.parametrize("norm,skip", [("layer", True), ("folded", True), ("layer", False)])
def test_fp_module_matches_flax(norm, skip):
    xyz, feats, valid = cloud(9, c=4)
    known, kfeats, kvalid = cloud(10, n=40, c=6)
    fm = jmod.FPModule([16, 16], norm=norm)
    f0 = jnp.asarray(feats[0]) if skip else None
    params = noisy(fm.init(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), f0, jnp.asarray(known[0]),
                           jnp.asarray(kfeats[0]), jnp.asarray(kvalid[0])), 11)
    tm = load_flax_params(tmod.FPModule(6 + (4 if skip else 0), [16, 16], norm=norm), params).eval()
    if skip:
        want = batched(lambda a, b, c, d, e: fm.apply(params, a, b, c, d, e),
                       xyz, feats, known, kfeats, kvalid)
    else:
        want = batched(lambda a, c, d, e: fm.apply(params, a, None, c, d, e),
                       xyz, known, kfeats, kvalid)
    with torch.inference_mode():
        close(tm(t(xyz), t(feats) if skip else None, t(known), t(kfeats), t(kvalid)), want, 1e-4,
              "FPModule")


# ------------------------------------------------------------- proposal layer


@pytest.mark.parametrize("bucket", [False, True])
def test_proposal_layer_matches_jax(bucket):
    kw = dict(nms_pre=64, num_proposals=20, distance_bucket=bucket, bucket_radius=5.0,
              proposal_nms_iou=0.5)
    jcfg, tcfg = jnet.PointRCNNConfig(**kw), tnet.PointRCNNConfig(**kw)
    rng = np.random.RandomState(12)
    xyz, _, valid = cloud(13)
    cls = rng.randn(B, N).astype(np.float32) * 2
    cls[:, 5] = cls[:, 3]  # tied scores keep the lower index
    reg = rng.randn(B, N, jcfg.rpn_coder.channels).astype(np.float32) * 0.3
    want = batched(lambda a, b, c, d: jnet.proposal_layer(a, b, c, d, jcfg), xyz, cls, reg, valid)
    got = tnet.proposal_layer(t(xyz), t(cls), t(reg), t(valid), tcfg)
    assert torch.equal(got["roi_valid"], t(want["roi_valid"]))
    assert got["rois"].shape == (B, 20, 7)
    ok = want["roi_valid"]
    assert ok.sum() >= 20  # and padding below the quota occurs
    close(got["rois"][t(ok)], want["rois"][ok], 1e-5, "rois")
    close(got["roi_scores"][t(ok)], want["roi_scores"][ok], 1e-6, "roi_scores")


def test_canonical_transform_matches_jax():
    rng = np.random.RandomState(14)
    pooled = rng.uniform(-5, 5, (B, 6, 10, 3)).astype(np.float32)
    rois = rng.uniform(-3, 3, (B, 6, 7)).astype(np.float32)
    want = np.stack([jnet.canonical_transform(jnp.asarray(p), jnp.asarray(r))
                     for p, r in zip(pooled, rois)])
    close(tnet.canonical_transform(t(pooled), t(rois)), want, 1e-6, "canonical_transform")


# ------------------------------------------------------------------ whole net


def lyft_structure(module):
    """The Lyft preset's structure (paired radii, the near/far proposal
    split, three RCNN widths, per-class mean sizes) at narrowed widths and
    capacities."""
    cfg = module.lyft_pointrcnn_config("test")
    return dataclasses.replace(
        cfg, sa_npoints=(128, 64, 32, 16), sa_widths=(8, 8, 16, 16), fp_width=16,
        sa_radii=((0.5, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 8.0)),
        sa_nsamples=((4, 8),) * 4, num_proposals=10, nms_pre=64, bucket_radius=4.0,
        roi_points=32, rcnn_sa_npoints=(16, 8), rcnn_widths=(16, 16, 24),
        rcnn_sa_radii=(0.8, 1.6), rcnn_sa_nsamples=(8, 8),
    )


WHOLE = {
    "default_1024": (lambda m: m.PointRCNNConfig(), 1024, "layer"),
    "lyft_structure": (lyft_structure, 256, "folded"),
}


@pytest.fixture(scope="module", params=sorted(WHOLE))
def whole(request):
    make_cfg, n, norm = WHOLE[request.param]
    jcfg, tcfg = make_cfg(jnet), make_cfg(tnet)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    xyz, _, valid = cloud(15, n=n, span=8.0)
    fm = jnet.PointRCNN(jcfg, norm=norm)
    params = noisy(jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), None,
                                    jnp.asarray(valid[0])), 16, scale=0.05)
    want = batched(lambda x, v: fm.apply(params, x, None, v), xyz, valid)
    tm = load_flax_params(tnet.PointRCNN(tcfg, norm=norm), params).eval()
    with torch.inference_mode():
        got = tm(t(xyz), None, t(valid))
    return tcfg, params, want, got


def test_whole_net_rpn_matches_flax(whole):
    _, _, want, got = whole
    close(got["rpn"]["point_features"], want["rpn"]["point_features"], 1e-3, "point features")
    close(got["rpn"]["cls"], want["rpn"]["cls"], 1e-3, "rpn cls")
    close(got["rpn"]["reg"], want["rpn"]["reg"], 1e-3, "rpn reg")


def test_whole_net_proposals_match_flax(whole):
    cfg, _, want, got = whole
    ok = want["proposals"]["roi_valid"]
    assert torch.equal(got["proposals"]["roi_valid"], t(ok)) and ok.sum() > cfg.num_proposals
    close(got["proposals"]["rois"][t(ok)], want["proposals"]["rois"][ok], 1e-3, "rois")
    close(got["proposals"]["roi_scores"][t(ok)], want["proposals"]["roi_scores"][ok], 1e-3,
          "roi scores")
    assert torch.equal(got["roi_empty"][t(ok)], t(want["roi_empty"][ok]))


def test_whole_net_rcnn_and_refined_match_flax(whole):
    _, _, want, got = whole
    ok = want["proposals"]["roi_valid"]
    close(got["rcnn"]["cls"][t(ok)], want["rcnn"]["cls"][ok], 1e-3, "rcnn cls")
    close(got["rcnn"]["reg"][t(ok)], want["rcnn"]["reg"][ok], 1e-3, "rcnn reg")
    close(got["refined"][t(ok)], want["refined"][ok], 1e-3, "refined boxes")
    assert bool(torch.isfinite(got["refined"]).all())


def test_lyft_preset_equals_the_jax_preset():
    for mode in ("test", "train"):
        for name in ("car", "pedestrian"):
            assert dataclasses.asdict(tnet.lyft_pointrcnn_config(mode, name)) == dataclasses.asdict(
                jnet.lyft_pointrcnn_config(mode, name))
    assert tnet.LYFT_CLASS_NAMES == jnet.LYFT_CLASS_NAMES
    assert tnet.LYFT_CLS_MEAN_SIZES == jnet.LYFT_CLS_MEAN_SIZES


# --------------------------------------------------------- bridge and errors


def test_bridge_raises_on_missing_and_extra_leaves(whole):
    cfg, params, _, _ = whole
    norm = "layer" if "LayerNorm_0" in params["params"]["PointRCNN_RPN_0"]["SharedMLP_0"] else "folded"
    model = tnet.PointRCNN(cfg, norm=norm)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["params"]["PointRCNN_RCNN_0"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="not used"):
        load_flax_params(model, extra)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["params"]["PointRCNN_RCNN_0"]["Vmap_RoIEncoder_0"]["SAModuleGlobal_0"]
    with pytest.raises(KeyError, match="SAModuleGlobal_0"):
        load_flax_params(model, missing)
    other = "folded" if norm == "layer" else "layer"
    with pytest.raises((KeyError, ValueError)):
        load_flax_params(tnet.PointRCNN(cfg, norm=other), params)


def test_unported_variants_raise():
    """The grid-bucketed ball query is not ported and an unknown norm is
    refused; ``norm="batch"`` is ported (held to flax in
    ``test_torch_pointrcnn_losses.py``) and builds BatchNorm layers."""
    assert all(isinstance(n, torch.nn.BatchNorm2d) for n in tmod.SharedMLP(4, [8, 8], norm="batch").norms)
    assert any(isinstance(m, torch.nn.BatchNorm2d) for m in tnet.PointRCNN(tnet.PointRCNNConfig(), norm="batch").modules())
    with pytest.raises(ValueError, match="norm must be"):
        tmod.SharedMLP(4, [8], norm="group")
    grid = dataclasses.replace(tnet.PointRCNNConfig(), grid_bounds=((-64.0, 64.0), (-8.0, 120.0)))
    for build in (tnet.PointRCNN, tnet.PointRCNN_RPN, tnet.PointRCNNBackbone):
        with pytest.raises(NotImplementedError, match="not ported"):
            build(grid)


def test_heads_stay_float32_and_bias_init_in_bfloat16():
    model = tnet.PointRCNN(tnet.PointRCNNConfig(), norm="folded", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    for head in (model.rpn.cls, model.rpn.reg, model.rcnn.cls, model.rcnn.reg):
        assert head.weight.dtype == torch.float32
    assert model.rcnn.fc.weight.dtype == torch.bfloat16
    assert model.rpn.backbone.sa[0].mlps[0].linears[0].weight.dtype == torch.bfloat16
    assert abs(float(model.rpn.cls.bias.detach()) + np.log(99.0)) < 1e-6
    again = tnet.PointRCNN(tnet.PointRCNNConfig(), norm="folded",
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.rcnn.fc.weight.to(torch.bfloat16), model.rcnn.fc.weight)
