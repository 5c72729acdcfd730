"""Port parity for the sparse SECOND slice: ``block_filter_mask`` and the
block-filtered ``voxelize``, ``SimpleVoxel``, ``SparseMiddleUnits``
("layer" and "folded"), ``SparseMiddle``, the sparse ``VoxelNet`` with
``voxelnet_predict``, and ``voxelnet_config_from_experiment`` on the sparse
FHD yaml, each against the JAX package on the same numpy inputs and the
same flax weights carried over by ``load_flax_params``.

Tolerances: masks, voxel coords and validity exact; dense BEV maps 1e-4 of
the output scale and heads 1e-3 (float32 sums in another order through up
to six sparse layers and the RPN); detections: the same valid set and
classes, boxes and scores within 1e-3. Clouds hold at most one point a
voxel: with ``max_points_per_voxel: 1`` the JAX voxelizer's unstable sort
would otherwise keep another point than the port's stable one. The JAX
stencil runs as its reference (``method="auto"`` on the CPU).
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
from lyft3d_tpu.models.second import middle as jmid
from lyft3d_tpu.models.second import voxel_encoder as jenc
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.models.second.voxelnet import VoxelNetConfig as JConfig
from lyft3d_tpu.models.second.voxelnet import voxelnet_predict as jpredict
from lyft3d_tpu.ops import anchors as janchors
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu.ops.sparse_conv import ActiveSet as JActiveSet
from lyft3d_tpu.pipelines import second_train as jsecond
from lyft3d_tpu_torch.models.second.middle import (
    SparseMiddle,
    SparseMiddleColumns,
    SparseMiddleUnits,
    SubMUnitLayer,
)
from lyft3d_tpu_torch.models.second.voxel_encoder import SimpleVoxel
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig
from lyft3d_tpu_torch.ops import anchors as tanchors
from lyft3d_tpu_torch.ops import voxelize as tvox
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
from lyft3d_tpu_torch.pipelines import second as tsecond
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

REPO = Path(__file__).resolve().parent.parent
BEV_TOL = 1e-4
HEAD_TOL = 1e-3

JGRID = jvox.VoxelGrid((-8.0, -8.0, -2.0, 8.0, 8.0, 2.0), (0.5, 0.5, 0.25),
                       block_filtering=True, block_factor=1, block_size=4, height_threshold=0.2)
JSPEC = janchors.AnchorSpec(size=(1.0, 2.0, 1.0), z_center=0.0, matched_threshold=0.5,
                            unmatched_threshold=0.35, class_id=1)
JCFG = JConfig(
    grid=JGRID, max_voxels=800, max_points_per_voxel=1, encoder="simple", middle="sparse_units",
    middle_features=(8, 16), middle_max_voxels=(768, 512), middle_z_slab=4,
    anchor_specs=(JSPEC,), rpn_layer_nums=(1, 1), rpn_strides=(1, 2), rpn_filters=(16, 32),
    rpn_up_strides=(1, 2), rpn_up_filters=(16, 16), nms_pre=64, nms_post=16,
)


def t(x):
    return torch.from_numpy(np.array(x))


def port_config(jcfg: JConfig, **changes) -> VoxelNetConfig:
    names = {f.name for f in dataclasses.fields(VoxelNetConfig)}
    kw = {k: getattr(jcfg, k) for k in names}
    kw["grid"] = tvox.VoxelGrid(*jcfg.grid)
    kw["anchor_specs"] = tuple(tanchors.AnchorSpec(*s) for s in jcfg.anchor_specs)
    kw.update(changes)
    return VoxelNetConfig(**kw)


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0)


def one_point_cloud(seed, n, grid=JGRID):
    """``n`` points in distinct voxels (a voxel centre plus a jitter well inside
    the voxel), over a ground sheet near z = −1.5 with clutter above it."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = grid.grid_size
    flat = rng.choice(nx * ny * nz, n, replace=False)
    idx = np.stack([flat % nx, (flat // nx) % ny, flat // (nx * ny)], -1)
    idx[: n // 2, 2] = rng.randint(1, 4, n // 2)  # the ground sheet
    _, first = np.unique((idx[:, 1] * nx + idx[:, 0]) * nz + idx[:, 2], return_index=True)
    idx = idx[np.sort(first)]
    lo = np.array(grid.point_cloud_range[:3])
    pts = lo + (idx + 0.5 + rng.uniform(-0.3, 0.3, idx.shape)) * np.array(grid.voxel_size)
    return pts.astype(np.float32)


def flax_init(module, *inputs, seed=0):
    v = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs))
    rng = np.random.RandomState(seed)

    def walk(node):  # norm scales and biases away from 1/0, so that a mix-up shows
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


# ------------------------------------------------- block filter and encoder


@pytest.mark.parametrize("seed,n", [(0, 600), (1, 2500)])
def test_block_filter_mask_and_voxelize_equal(seed, n):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-9, 9, (n, 2)), rng.uniform(-2.5, 2.5, (n, 1))], 1).astype(np.float32)
    pts[: n // 20, 0] = np.arange(n // 20) % 9 * 2.0 - 8.0  # on block edges
    valid = rng.rand(n) > 0.1
    want = np.asarray(jvox.block_filter_mask(jnp.asarray(pts), jnp.asarray(valid), JGRID))
    got = tvox.block_filter_mask(t(pts), t(valid), tvox.VoxelGrid(*JGRID))
    np.testing.assert_array_equal(got.numpy(), want)
    in_range = (np.abs(pts[:, :2]) < 8).all(1) & valid
    assert 0.05 < 1 - want[in_range].mean() < 0.9  # the filter removes some, not all
    assert want[valid & ~(np.abs(pts[:, :2]) < 8).all(1)].all()  # out of range: left to voxelize
    both = tvox.block_filter_mask(t(np.stack([pts, pts[::-1]])), t(np.stack([valid, valid[::-1]])),
                                  tvox.VoxelGrid(*JGRID))
    assert torch.equal(both[0], got) and torch.equal(both[1], got.flip(0))

    cloud = one_point_cloud(seed, n)
    ones = np.ones(len(cloud), bool)
    jv = jvox.voxelize(jnp.asarray(cloud), jnp.asarray(ones), JGRID, 400, 1)
    tv = tvox.voxelize(t(cloud), t(ones), tvox.VoxelGrid(*JGRID), 400, 1)
    for k in ("coords", "num_points", "voxel_valid", "voxels"):
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]), err_msg=k)
    unfiltered = jvox.voxelize(jnp.asarray(cloud), jnp.asarray(ones),
                               JGRID._replace(block_filtering=False), 4000, 1)
    assert int(jv["voxel_valid"].sum()) < int(unfiltered["voxel_valid"].sum())


def test_simple_voxel_matches_flax():
    rng = np.random.RandomState(2)
    voxels = rng.randn(2, 50, 3, 4).astype(np.float32)
    nump = rng.randint(0, 4, (2, 50)).astype(np.int32)
    coords = np.zeros((2, 50, 3), np.int32)
    jm = jenc.SimpleVoxel(num_features=3, dtype=jnp.float32)
    want = jm.apply({}, jnp.asarray(voxels), jnp.asarray(nump), jnp.asarray(coords))
    got = SimpleVoxel(3)(t(voxels), t(nump), t(coords))
    assert got.shape == (2, 50, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ------------------------------------------------------------------ middles


def random_batch(seed, shape, ns, cap, c, sort):
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    coords, valid = np.zeros((len(ns), cap, 3), np.int32), np.zeros((len(ns), cap), bool)
    for b, n in enumerate(ns):
        flat = rng.choice(nx * ny * nz, n, replace=False)
        if sort:  # the voxelizer's (y, x, z) order
            flat = np.sort(flat)
            xyz = np.stack([(flat // nz) % nx, flat // (nz * nx), flat % nz], -1)
        else:
            xyz = np.stack([flat % nx, (flat // nx) % ny, flat // (nx * ny)], -1)
        coords[b, :n], valid[b, :n] = xyz, True
    feats = rng.randn(len(ns), cap, c).astype(np.float32) * valid[..., None]
    return coords, valid, feats


def jbatch(coords, valid, shape):
    return jax.vmap(lambda c, v: JActiveSet(coords=c, valid=v, spatial_shape=shape))(
        jnp.asarray(coords), jnp.asarray(valid))


SHAPE = (16, 16, 8)
KW = dict(stage_features=(8, 16), stage_max_voxels=(512, 512), subm_per_stage=2)


@pytest.mark.parametrize("norm,sort", [("layer", False), ("folded", True)])
def test_sparse_middle_units_matches_flax(norm, sort):
    coords, valid, feats = random_batch(9, SHAPE, (70, 75), 96, 4, sort)
    jm = jmid.SparseMiddleUnits(z_slab=4, dtype=jnp.float32, method="ref", norm_type=norm,
                                assume_sorted_voxels=sort, **KW)
    v = flax_init(jm, jnp.asarray(feats), jbatch(coords, valid, SHAPE))
    want, want_cols = jax.jit(jm.apply)(v, jnp.asarray(feats), jbatch(coords, valid, SHAPE))
    tm = load_flax_params(SparseMiddleUnits(4, z_slab=4, norm_type=norm, assume_sorted_voxels=sort,
                                            nz=SHAPE[2], **KW), v).eval()
    with torch.no_grad():
        got, got_cols = tm(t(feats), ActiveSet(t(coords), t(valid), SHAPE))
    assert got.shape == (2, 4, 4, 2 * 16)
    np.testing.assert_array_equal(got_cols.col_ids.numpy(), np.asarray(want_cols.col_ids))
    np.testing.assert_array_equal(got_cols.mask.numpy(), np.asarray(want_cols.mask))
    close(got.numpy(), want, BEV_TOL)
    assert np.abs(np.asarray(want)).max() > 0.1


@pytest.fixture(scope="module")
def per_voxel_middle():
    """The flax per-voxel middle on a cap-free batch, the port with its
    weights, and both outputs."""
    coords, valid, feats = random_batch(10, SHAPE, (70, 75), 96, 4, True)
    jm = jmid.SparseMiddle(stage_features=KW["stage_features"],
                           stage_max_voxels=KW["stage_max_voxels"], dtype=jnp.float32)
    one = JActiveSet(jnp.asarray(coords[0]), jnp.asarray(valid[0]), SHAPE)
    v = flax_init(jm, jnp.asarray(feats[0]), one)
    apply = jax.jit(lambda f, c, m: jm.apply(v, f, JActiveSet(c, m, SHAPE))[0])
    want = np.stack([np.asarray(apply(jnp.asarray(feats[b]), jnp.asarray(coords[b]),
                                      jnp.asarray(valid[b]))) for b in range(2)])
    tm = load_flax_params(SparseMiddle(4, KW["stage_features"], KW["stage_max_voxels"]), v).eval()
    with torch.no_grad():
        got, _ = tm(t(feats), ActiveSet(t(coords), t(valid), SHAPE))
    return (coords, valid, feats), tm, got, want


def test_sparse_middle_matches_flax(per_voxel_middle):
    _, _, got, want = per_voxel_middle
    assert got.shape == (2, 4, 4, 2 * 16)
    close(got.numpy(), want, BEV_TOL)
    assert np.abs(want).max() > 0.1


def test_the_two_port_middles_agree(per_voxel_middle):
    """Same weights, no cap truncating: the unit middle and the per-voxel
    middle compute the same dense BEV map."""
    (coords, valid, feats), tm, got, _ = per_voxel_middle
    units = SparseMiddleUnits(4, z_slab=4, norm_type="layer", assume_sorted_voxels=True,
                              nz=SHAPE[2], **KW).eval()
    units.load_state_dict(tm.state_dict())
    with torch.no_grad():
        dense, cols = units(t(feats), ActiveSet(t(coords), t(valid), SHAPE))
    assert int(cols.valid.sum(-1).max()) < KW["stage_max_voxels"][-1]
    close(dense.numpy(), got.numpy(), BEV_TOL)


def test_unported_middle_variants_raise():
    # The dense-z column middle is ported now (tests/test_torch_column_middle.py).
    cols = SparseMiddleColumns(4)
    assert [tuple(m.kernel.shape) for m in cols.strided] == [(27, 16, 16), (27, 32, 32), (27, 64, 64)]
    # "batch" is ported now (tests/test_torch_second_leftovers.py): a BatchNorm over the channels.
    assert SubMUnitLayer(4, 8, 2, norm_type="batch").norm.channel_dim == -1
    with pytest.raises(ValueError, match="unknown norm_type"):
        SubMUnitLayer(4, 8, 2, norm_type="group")


# -------------------------------------------------------------- whole slice


@pytest.fixture(scope="module")
def sparse_voxelnet():
    clouds = [one_point_cloud(s, 700) for s in (3, 4)]
    n = min(len(c) for c in clouds)
    pts = np.stack([c[:n] for c in clouds])
    valid = np.ones(pts.shape[:2], bool)
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, JGRID, JCFG.max_voxels, 1))(
        jnp.asarray(pts), jnp.asarray(valid))
    keys = ("voxels", "num_points", "coords", "voxel_valid")
    model = JVoxelNet(JCFG, dtype=jnp.float32)
    v = flax_init(model, *[vox[k] for k in keys])
    preds = jax.device_get(jax.jit(model.apply)(v, *[vox[k] for k in keys]))
    return pts, valid, v, preds


def test_sparse_voxelnet_heads_and_detections_match(sparse_voxelnet):
    pts, valid, v, want = sparse_voxelnet
    cfg = port_config(JCFG)
    assert cfg.feature_hw == JCFG.feature_hw == (8, 8)
    port = load_flax_params(VoxelNet(cfg, in_features=3), v)
    infer = tsecond.make_second_infer_fn(port, cfg)
    with torch.no_grad():
        vox = tvox.voxelize(t(pts), t(valid), cfg.grid, cfg.max_voxels, 1)
        got = port(vox["voxels"], vox["num_points"], vox["coords"], vox["voxel_valid"])
    assert 100 < int(vox["voxel_valid"][0].sum()) < cfg.max_voxels
    for k in ("box", "cls", "dir"):
        assert got[k].shape == np.asarray(want[k]).shape
        close(got[k].numpy(), want[k], HEAD_TOL)
    janc, _, _, jcls = JCFG.make_anchors()
    jdet = jax.device_get(jax.vmap(lambda b, c, d: jpredict({"box": b, "cls": c, "dir": d},
                                                            janc, jcls, JCFG))(
        *[jnp.asarray(want[k]) for k in ("box", "cls", "dir")]))
    det = infer(t(pts), t(valid))
    ok = np.asarray(jdet["valid"])
    assert ok.sum() > 4
    np.testing.assert_array_equal(det["valid"].numpy(), ok)
    np.testing.assert_array_equal(det["classes"].numpy()[ok], np.asarray(jdet["classes"])[ok])
    np.testing.assert_allclose(det["scores"].numpy()[ok], np.asarray(jdet["scores"])[ok], atol=1e-3)
    np.testing.assert_allclose(det["boxes"].numpy()[ok], np.asarray(jdet["boxes"])[ok], atol=1e-3)


def test_sparse_voxelnet_per_voxel_middle_loads_vmapped_weights(sparse_voxelnet):
    """``middle="sparse"``: the flax parameters sit under the ``nn.vmap``ped
    per-sample module; heads agree with JAX."""
    pts, valid, _, _ = sparse_voxelnet
    jcfg = dataclasses.replace(JCFG, middle="sparse")
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, JGRID, jcfg.max_voxels, 1))(
        jnp.asarray(pts), jnp.asarray(valid))
    args = [vox[k] for k in ("voxels", "num_points", "coords", "voxel_valid")]
    model = JVoxelNet(jcfg, dtype=jnp.float32)
    v = flax_init(model, *args)
    want = jax.device_get(jax.jit(model.apply)(v, *args))
    port = load_flax_params(VoxelNet(port_config(jcfg), in_features=3), v).eval()
    with torch.no_grad():
        got = port(*[t(a) for a in args])
    for k in ("box", "cls", "dir"):
        close(got[k].numpy(), want[k], HEAD_TOL)
    tree = {"params": {**v["params"], "Stray_0": {"kernel": np.zeros((1,), np.float32)}}}
    with pytest.raises(ValueError, match="not used"):
        load_flax_params(VoxelNet(port_config(jcfg), in_features=3), tree)


def test_fhd_config_matches_yaml():
    """chip_smoke.py's spelled-out FHD config == the port's config of the
    shipped sparse yaml, field by field; the JAX config agrees on every
    shared field, on the feature grid and on the anchors."""
    exp = load_yaml(SecondExperiment, REPO / "configs" / "second_lyft_9class_sparse.yaml")
    from_yaml = tsecond.voxelnet_config_from_experiment(exp)
    spelled = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")["fhd_config"]()
    jcfg = jsecond.voxelnet_config_from_experiment(exp)
    for f in dataclasses.fields(VoxelNetConfig):
        assert getattr(spelled, f.name) == getattr(from_yaml, f.name), f.name
        assert getattr(jcfg, f.name) == getattr(from_yaml, f.name), f.name
    assert from_yaml.grid.grid_size == (1984, 1984, 40)
    assert from_yaml.middle_downsample == jcfg.middle_downsample == 8
    assert from_yaml.feature_hw == jcfg.feature_hw == (124, 124)
    want = jcfg.make_anchors()
    got = from_yaml.make_anchors()
    assert got[0].shape == (124 * 124 * 18, 7)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
