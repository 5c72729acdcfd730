"""Port parity for the dense-z column middle (``middle: sparse_columns``) and
the grid-bucketed ball query, each against the JAX function on the same numpy
inputs, at a small size (nz ≤ 8, ≤ 300 voxels).

- ops: ``columns_from_voxels`` (sorted and unsorted, with its gradient),
  ``column_neighbors``, ``subm_qids_one``, ``downsample_columns`` (with a cap
  that fills), the chunk plan of every FHD layer, the batched submanifold and
  strided column convs (forward, both gradients, the strided layer's
  activity) and their plain unbatched forms;
- the middle, ``SparseMiddleColumns``, with ``layer``, ``batch`` (train and
  eval) and ``folded`` norms after ``load_flax_params``; one
  ``train_second`` step of a ``simple + sparse_columns`` VoxelNet;
- ``grid_multi_radius_ball_query`` on a clustered cloud where cells overflow
  ``cell_cap``;
- a CPU emulation of the stencil's wide tile (``conv_wide_kernel``: a
  16-query group's warps own a chunk's whole width, band ranges, weights in
  the MMA's fragment order, float32 rows rounded as they are read) at the
  column shapes, held to ``stencil_conv_ref``; the band ranges' cover of
  every non-zero (``hypothesis``); the bfloat16 column VoxelNet's gradients
  as far from float32 as JAX's.

Tolerances: ids, validity, masks and query ids exact (the caps are integer
arithmetic that decides which columns survive); placed features exact
(copies); conv outputs and gradients 1e-4 of their scale (float32 sums in
another order); the strided activity exact (a count of ones); ball-query
indices and counts exact.
"""

import dataclasses
import itertools
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

from lyft3d_tpu.models.second import middle as jmid
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.ops import column_sparse as jcs
from lyft3d_tpu.ops import pointnet2 as jp2
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu.ops.sparse_conv import ActiveSet as JActiveSet
from lyft3d_tpu.pipelines import second_train as jtrain
from lyft3d_tpu.train import trainer as jtrainer
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.models.second.middle import SparseMiddleColumns
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.ops import column_sparse as tcs
from lyft3d_tpu_torch.ops import pointnet2 as tp2
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
from lyft3d_tpu_torch.pipelines import second_train as ttrain
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402  (its stencil edge-case generator)
from test_torch_layers import randomized  # noqa: E402
from test_torch_second_sparse import JCFG as JSPARSE, port_config  # noqa: E402
from test_torch_second_train import flat, sparse_batch  # noqa: E402

TOL = 1e-4
SHAPE = (12, 10, 8)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol * scale, rtol=0)


def voxel_batch(seeds, shape=SHAPE, n=150, cap=170, sort=True, c=4):
    """Unique voxel coords of ``len(seeds)`` samples padded to ``cap`` (the
    voxelizer's (y, x, z) order when ``sort``) and ``c``-channel features."""
    nx, ny, nz = shape
    coords, valid = [], []
    for i, seed in enumerate(seeds):
        rng = np.random.RandomState(seed)
        m = n - 7 * i
        flat = rng.choice(nx * ny * nz, m, replace=False)
        x, y, z = flat % nx, (flat // nx) % ny, flat // (nx * ny)
        if sort:
            order = np.argsort((y * nx + x) * nz + z)
            x, y, z = x[order], y[order], z[order]
        cc = np.zeros((cap, 3), np.int32)
        cc[:m] = np.stack([x, y, z], -1)
        coords.append(cc)
        valid.append(np.arange(cap) < m)
    feats = np.random.RandomState(seeds[0] + 100).randn(len(seeds), cap, c).astype(np.float32)
    return np.stack(coords), np.stack(valid), feats


def jactive(coords, valid, shape=SHAPE):
    return jax.vmap(lambda c, v: JActiveSet(c, v, shape))(jnp.asarray(coords), jnp.asarray(valid))


def tactive(coords, valid, shape=SHAPE):
    return ActiveSet(t(coords), t(valid), shape)


def to_torch_cols(jcols):
    return tcs.ColumnSet(t(jcols.col_ids), t(jcols.valid), t(jcols.mask), tuple(jcols.bev_shape), jcols.nz)


def assert_same_cols(got, want, mask=True):
    assert got.bev_shape == tuple(want.bev_shape) and got.nz == want.nz
    np.testing.assert_array_equal(got.col_ids.numpy(), np.asarray(want.col_ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if mask:
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def jax_columns(coords, valid, feats, sort, shape=SHAPE):
    fn = jax.jit(lambda f, c, v: jax.vmap(lambda ff, a: jcs.columns_from_voxels(ff, a, sort))(
        f, jax.vmap(lambda cc, vv: JActiveSet(cc, vv, shape))(c, v)))
    return fn(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid))


# ------------------------------------------------------------ building columns


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_columns_from_voxels_equal_with_gradient(sort):
    coords, valid, feats = voxel_batch((0, 1), sort=sort)
    shape = SHAPE
    jcols, jf = jax_columns(coords, valid, feats, sort)
    f = t(feats).requires_grad_(True)
    tcols, tf = tcs.columns_from_voxels(f, tactive(coords, valid), assume_sorted=sort)
    assert_same_cols(tcols, jcols)
    np.testing.assert_array_equal(tf.detach().numpy(), np.asarray(jf))
    assert int(np.asarray(jcols.mask).sum()) == int(valid.sum())  # every voxel placed
    cot = np.random.RandomState(3).randn(*tf.shape).astype(np.float32)

    def jloss(ff):
        _, colf = jax.vmap(lambda x, a: jcs.columns_from_voxels(x, a, sort))(ff, jactive(coords, valid, shape))
        return jnp.sum(colf * cot)

    want = jax.jit(jax.grad(jloss))(jnp.asarray(feats))
    (tf * t(cot)).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(want))
    assert not np.asarray(want)[~valid].any()


def test_neighbors_and_query_ids_equal():
    coords, valid, feats = voxel_batch((2, 3))
    jcols, _ = jax_columns(coords, valid, feats, True)
    tcols = to_torch_cols(jcols)
    want_q = jax.vmap(jcs.subm_qids_one)(jcols)
    np.testing.assert_array_equal(tcs.subm_qids_one(tcols).numpy(), np.asarray(want_q))
    want_n = jax.vmap(lambda c: jcs.column_neighbors(c, "search"))(jcols)
    np.testing.assert_array_equal(tcs.column_neighbors(tcols).numpy(), np.asarray(want_n))
    assert (np.asarray(want_n)[:, 4] >= 0).sum() == int(np.asarray(jcols.valid).sum())  # the centre


@pytest.mark.parametrize("max_out", [200, 12], ids=["fits", "cap_fills"])
def test_downsample_columns_equal(max_out):
    coords, valid, feats = voxel_batch((4, 5))
    jcols, _ = jax_columns(coords, valid, feats, True)
    want = jax.jit(jax.vmap(lambda c: jcs.downsample_columns(c, max_out)))(jcols)
    got = tcs.downsample_columns(to_torch_cols(jcols), max_out)
    assert_same_cols(got, want)
    n_out = np.asarray(want.valid).sum(-1)
    assert (n_out == max_out).all() if max_out == 12 else (n_out < max_out).all()


# The (Cin, Cout, nz out, stride) of the FHD column middle's convs and the
# strided layers' mask convs: each chunk plan equals JAX's.
FHD_COLUMN_CONVS = ((3, 16, 40, 1), (16, 16, 40, 1), (16, 16, 20, 2), (16, 32, 20, 1), (32, 32, 20, 1),
                    (32, 32, 10, 2), (32, 64, 10, 1), (64, 64, 10, 1), (64, 64, 5, 2),
                    (1, 1, 20, 2), (1, 1, 10, 2), (1, 1, 5, 2))


@pytest.mark.parametrize("cin,cout,nz_out,stride", FHD_COLUMN_CONVS)
def test_chunk_plan_of_every_fhd_conv_equals_jax(cin, cout, nz_out, stride):
    plan = tcs._chunk_plan(cin, nz_out, stride)
    assert tuple(plan) == tuple(jcs._chunk_plan(cin, nz_out, stride))
    # The stencil's bfloat16 route takes the forward and d_src of each.
    tcs.stencil_mma_variant(plan.kzp, plan.z * cout)
    tcs.stencil_mma_variant(plan.z * cout, plan.kzp)


# ------------------------------------------------------------ convolutions


def jax_vjp(fn, colf, w, cols, cot, aux=False):
    """``fn(colf, w, cols)``'s output and its VJP at ``cot`` in one jitted call
    (with ``aux``, ``fn`` returns (output, activity) and the activity comes
    third)."""
    def both(cf, ww, cc, ct):
        if aux:
            out, vjp, extra = jax.vjp(lambda a, b: fn(a, b, cc), cf, ww, has_aux=True)
            return out, vjp(ct), extra
        out, vjp = jax.vjp(lambda a, b: fn(a, b, cc), cf, ww)
        return out, vjp(ct)
    return jax.jit(both)(jnp.asarray(colf), jnp.asarray(w), cols, jnp.asarray(cot))


def conv_case(seed, cin, cout):
    coords, valid, feats = voxel_batch((seed, seed + 1), c=cin)
    jcols, jf = jax_columns(coords, valid, feats, True)
    w = (np.random.RandomState(seed + 7).randn(27, cin, cout) * 0.3).astype(np.float32)
    return jcols, np.asarray(jf), w


@pytest.mark.parametrize("cin,cout", [(3, 16), (32, 8)])  # 1 and 2 chunks
def test_subm_conv_columns_batched_equal_with_gradients(cin, cout):
    """Forward against JAX and against the plain unbatched form; ``d_colf``
    and ``d_w`` against JAX's VJP (the fused backward's reverse queries)."""
    jcols, colf, w = conv_case(10 + cin, cin, cout)
    tcols = to_torch_cols(jcols)

    cf = t(colf).requires_grad_(True)
    wt = t(w).requires_grad_(True)
    got = tcs.subm_conv_columns_batched(cf, tcols, wt)
    cot = np.random.RandomState(1).randn(*got.shape).astype(np.float32)
    want, (want_cf, want_w) = jax_vjp(lambda c, ww, cols: jcs.subm_conv_columns_batched(c, cols, ww, method="ref"),
                                      colf, w, jcols, cot)
    close(got.detach(), want)
    plain = tcs.subm_conv_columns(t(colf), tcols, tcs.column_neighbors(tcols), t(w))
    close(plain, want)
    (got * t(cot)).sum().backward()
    close(cf.grad, want_cf)
    close(wt.grad, want_w)


@pytest.mark.parametrize("cin,cout,max_out", [(4, 8, 200), (64, 8, 12)], ids=["fits", "cap_fills_4_chunks"])
def test_strided_conv_columns_batched_equal_with_gradients(cin, cout, max_out):
    jcols, colf, w = conv_case(20 + cin, cin, cout)
    jout_cols = jax.vmap(lambda c: jcs.downsample_columns(c, max_out))(jcols)
    tcols, tout = to_torch_cols(jcols), to_torch_cols(jout_cols)

    cf = t(colf).requires_grad_(True)
    wt = t(w).requires_grad_(True)
    got, got_mask = tcs.strided_conv_columns_batched(cf, tcols, tout, wt)
    cot = np.random.RandomState(2).randn(*got.shape).astype(np.float32)
    want, (want_cf, want_w), want_mask = jax_vjp(
        lambda c, ww, cols: jcs.strided_conv_columns_batched(c, cols[0], cols[1], ww, method="ref"),
        colf, w, (jcols, jout_cols), cot, aux=True)
    close(got.detach(), want)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert 0 < np.asarray(want_mask).mean() < 1
    plain, plain_mask = tcs.strided_conv_columns(t(colf), tcols, tout, t(w))
    close(plain, want)
    assert torch.equal(plain_mask, got_mask)
    (got * t(cot)).sum().backward()
    close(cf.grad, want_cf)
    close(wt.grad, want_w)


# ------------------------------------------------------------ the middle


KW = dict(stage_features=(8, 16), stage_max_voxels=(20, 8), subm_per_stage=2)  # 30 and 9 candidates


@pytest.fixture(scope="module")
def column_middles():
    """The flax column middle in each norm (a module-scoped init, norm
    statistics drawn with numpy) with its inputs: 2 x ≤ 150 voxels on
    12 x 10 x 8, the second stage's cap filling."""
    coords, valid, feats = voxel_batch((30, 31))
    active = jactive(coords, valid)
    out = {}
    for norm in ("layer", "batch", "folded"):
        jm = jmid.SparseMiddleColumns(dtype=jnp.float32, method="ref", norm_type=norm,
                                      assume_sorted_voxels=True, **KW)
        v = randomized(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(feats), active)), 3)
        out[norm] = (jm, v)
    return (coords, valid, feats, active), out


def port_middle(norm, variables):
    return load_flax_params(SparseMiddleColumns(4, norm_type=norm, assume_sorted_voxels=True, **KW), variables)


@pytest.mark.parametrize("norm,mode", [("layer", "eval"), ("batch", "eval"), ("batch", "train"), ("folded", "eval")])
def test_sparse_middle_columns_matches_flax(column_middles, norm, mode):
    """The dense BEV map and the final column set; in ``batch`` train mode
    also the updated running statistics (flax's ``mutable=["batch_stats"]``)."""
    (coords, valid, feats, active), middles = column_middles
    jm, v = middles[norm]
    if mode == "train":
        (want, want_cols), upd = jax.jit(lambda vv, f, a: jm.apply(vv, f, a, mutable=["batch_stats"]))(
            v, jnp.asarray(feats), active)
    else:
        want, want_cols = jax.jit(jm.apply)(v, jnp.asarray(feats), active)
    tm = port_middle(norm, v).train(mode == "train")
    with torch.no_grad():
        got, got_cols = tm(t(feats), tactive(coords, valid))
    close(got, want)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    assert_same_cols(got_cols, want_cols)
    assert int(np.asarray(want_cols.valid).sum(-1).max()) == KW["stage_max_voxels"][-1]  # the cap fills
    if mode == "train":
        stats = flat(export_flax_params(tm)["batch_stats"])
        for path, w in flat(jax.device_get(upd["batch_stats"])).items():
            close(stats[path], w, 1e-5)
    if norm == "batch":  # the fold leaves the middle's BatchNorms (a bare kernel has no Conv sibling)
        folded = fold_batch_norms(tm.eval())
        assert len([m for m in folded.modules() if isinstance(m, BatchNorm)]) == 6


JCOLUMNS = dataclasses.replace(JSPARSE, middle="sparse_columns", middle_max_voxels=(768, 256))


def test_column_voxelnet_trainer_step_follows_jax(tmp_path):
    """One ``adam`` step of a ``simple + sparse_columns`` VoxelNet from the
    same flax weights: the loss within 1e-5 relative, every parameter within
    1e-5 where JAX's gradient exceeds 100·eps (Adam's first step is
    lr·g/(|g| + eps): where |g| is near eps a rounding difference moves an
    element by up to lr, so the step is not resolved there), and within 2·lr
    everywhere."""
    batch = sparse_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, JCOLUMNS.grid, JCOLUMNS.max_voxels,
                                              JCOLUMNS.max_points_per_voxel))(jb["points"], jb["points_valid"])
    keys = ("voxels", "num_points", "coords", "voxel_valid")
    jmodel = JVoxelNet(JCOLUMNS, dtype=jnp.float32)
    variables = randomized(jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *[vox[k] for k in keys])), 5)
    jtr = jtrainer.Trainer(jmodel, optax.adam(1e-3), jtrain.make_second_loss_fn(JCOLUMNS),
                           jtrainer.TrainerConfig(model_dir=str(tmp_path / "j"), donate_state=False))
    jstate, jm = jtr._step_fn(jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                                         jtr.tx), jb, jax.random.PRNGKey(0))
    after = flat(jax.device_get(jstate.params)["params"])
    before = flat(variables["params"])

    cfg = port_config(JCOLUMNS)
    model = load_flax_params(VoxelNet(cfg, in_features=3), variables)
    assert isinstance(model.middle, SparseMiddleColumns)
    trainer = Trainer(model, lambda p: build_optimizer(p, "adam", 1e-3),
                      ttrain.make_second_loss_fn(cfg, device="cpu"), TrainerConfig(model_dir=str(tmp_path / "t")))
    state, metrics = trainer.step_fn(TrainState(model, lambda p: build_optimizer(p, "adam", 1e-3)),
                                     {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    got = flat(export_flax_params(model)["params"])
    assert set(got) == set(after) and any("SparseMiddleColumns_0" in p for p in got)
    resolved = 0
    for path, w in after.items():
        # Adam's first step moves an element by lr·|g|/(|g| + eps): by more than
        # lr·100/101 exactly where |g| > 100·eps.
        sure = np.abs(w - before[path]) > 1e-3 * 100 / 101
        resolved += int(sure.sum())
        np.testing.assert_allclose(got[path][sure], w[sure], atol=1e-5, rtol=0, err_msg="/".join(path))
        np.testing.assert_allclose(got[path], w, atol=2e-3, rtol=0, err_msg="/".join(path))
    assert resolved > 0.9 * sum(w.size for w in after.values())


def test_bf16_column_gradients_are_as_far_from_float32_as_jax():
    """The bfloat16 column VoxelNet (``layer`` norm, nz 8, 2 x ~170 voxels,
    the same flax weights and numpy batch) against its float32 self, leaf by
    leaf: ‖g_bf16 − g_f32‖ / ‖g_f32‖ in JAX and in the port (plain
    versions). Both sides are bfloat16 rounding noise taken at different
    places in the two frameworks, so no leaf's ratio equals the other
    side's; the port's median leaf stays within 1.5x of JAX's and its worst
    leaf within 2x of JAX's worst. A fault of the port's bfloat16 path (a
    gradient wrong, not noisy) would put its ratios near 1 and its median
    far above JAX's. Measured here: medians 0.164 (port) and 0.168 (JAX),
    worst leaves 0.50 and 0.37, both at the first layers' kernels and
    LayerNorm scales (sums that cancel)."""
    grid = JCOLUMNS.grid._replace(voxel_size=(0.5, 0.5, 0.5))
    jcfg = dataclasses.replace(JCOLUMNS, grid=grid, middle_norm="layer")
    assert jcfg.grid.grid_size[2] == 8
    batch = sparse_batch()
    batch["points"], batch["points_valid"] = batch["points"][:, :320], batch["points_valid"][:, :320]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = ("voxels", "num_points", "coords", "voxel_valid")
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, jcfg.grid, jcfg.max_voxels, jcfg.max_points_per_voxel))(
        jb["points"], jb["points_valid"])
    assert int(np.asarray(vox["voxel_valid"]).sum(-1).max()) <= 300
    variables = randomized(jax.device_get(jax.jit(JVoxelNet(jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), *[vox[k] for k in keys])), 5)
    jloss = jtrain.make_second_loss_fn(jcfg)
    jax_side, port_side = {}, {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jm = JVoxelNet(jcfg, dtype=jdt)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jloss(jm, {**variables, "params": p}, jb, jax.random.PRNGKey(0))[0]))(variables["params"])
        jax_side[tdt] = (float(loss), flat(jax.device_get(grads)))
        cfg = port_config(jcfg)
        model = load_flax_params(VoxelNet(cfg, in_features=3, dtype=tdt), variables)
        tl, _ = ttrain.make_second_loss_fn(cfg, device="cpu")(model, {k: t(v) for k, v in batch.items()})
        tl.backward()
        port_side[tdt] = (float(tl.detach()), {k: p.grad.detach().float() for k, p in model.named_parameters()
                                               if p.grad is not None})

    def ratios(side, norm):
        g32, g16 = side[torch.float32][1], side[torch.bfloat16][1]
        return np.array([norm(g16[k] - g) / norm(g) for k, g in g32.items() if norm(g) > 0])

    jr = ratios(jax_side, lambda x: float(np.linalg.norm(np.asarray(x, np.float64))))
    tr = ratios(port_side, lambda x: float(x.double().norm()))
    assert len(jr) == len(tr) == 42
    for side in (jax_side, port_side):
        assert abs(side[torch.bfloat16][0] - side[torch.float32][0]) <= 1e-2 * abs(side[torch.float32][0])
    np.testing.assert_allclose(port_side[torch.float32][0], jax_side[torch.float32][0], rtol=1e-5)
    assert np.median(tr) <= 1.5 * np.median(jr), (np.median(tr), np.median(jr))
    assert tr.max() <= 2.0 * jr.max() and tr.max() < 1.0, (tr.max(), jr.max())


# ------------------------------------------------------------ grid ball query


def test_grid_ball_query_matches_jax_where_cells_overflow():
    """A clustered cloud (two dense blobs, uniform clutter, invalid points,
    points beyond the bounds) where plane cells hold more than ``cell_cap``
    points: indices and counts equal JAX's, and differ from the exact query's."""
    rng = np.random.RandomState(7)
    b, n, s = 2, 1500, 200
    pts = np.concatenate([rng.normal([2.0, 0.0, 3.0], 0.4, (b, 600, 3)), rng.normal([-5.0, 0.5, -4.0], 0.3, (b, 300, 3)),
                          rng.uniform([-12, -2, -12], [12, 2, 12], (b, n - 900, 3))], 1).astype(np.float32)
    pts[:, -20:, 0] = 40.0  # beyond the bounds: clipped to the edge cells
    valid = rng.rand(b, n) > 0.1
    centers = pts[:, rng.choice(n, s, replace=False)]
    radii, ks, bounds = (0.5, 1.0), (8, 32), ((-10.0, 10.0), (-10.0, 10.0))
    want = [jax.jit(jax.vmap(lambda c, p, v: jp2.grid_multi_radius_ball_query(c, p, v, radii, ks, bounds)))(
        centers, pts, valid)]
    got = tp2.grid_multi_radius_ball_query(t(centers), t(pts), t(valid), radii, ks, bounds)
    exact = tp2.multi_radius_ball_query(t(centers), t(pts), t(valid), radii, ks)
    for (gi, gc), (wi, wc), (ei, ec) in zip(got, want[0], exact):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert not all(torch.equal(g[1], e[1]) for g, e in zip(got, exact))  # the caps dropped points
    cells = np.floor((pts[..., [0, 2]] + 10.0) / 1.0).clip(0, 19)
    occupancy = np.unique((cells[0, valid[0], 1] * 20 + cells[0, valid[0], 0]), return_counts=True)[1]
    assert occupancy.max() > 16


# ------------------------------------------------ the wide tensor-core tile


def emulate_conv_wide(src, qids, src_ids, wc, nc):
    """``conv_wide_kernel`` of ``csrc/conv_mma.cuh`` on the CPU: each warp (a
    16-query group of one chunk, one of ``col_warps`` column warps owning
    the 16-column pairs [8·cw, 8·cw + 8)) walks the offsets at which
    one of its queries hits and the 16-lane steps whose band range
    (:func:`stencil_band_ranges_ref`) holds one of its pairs, multiplying
    its two rows a lane (misses and lanes at or past the rows' chunk width
    zero; a float32 row rounded to bfloat16 as it is read) by the B block
    the lanes load from the fragment-ordered weights
    (:func:`stencil_weight_fragments_ref`), rebuilt here from the lanes'
    fragments; float32 sums. Returns the output and the number of 16 x 16
    weight blocks multiplied by the warps of a 16-query group."""
    k, n = wc.shape[1:]
    var = tcs.stencil_mma_variant(k, n, nc, src.dtype)
    assert var["route"] == "wide" and var["col_tiles"] == 1 and var["cols"] >= var["n_pad"]
    kp, n_pad, col_warps = var["kp"], var["n_pad"], var["col_warps"]
    if var["prep"]:  # the padded copy, its zero rows flagged
        (rows, flags), ka = tcs.stencil_rows_prep_ref(src, nc, k, kp), kp
    else:
        rows, flags, ka = src.to(torch.bfloat16), None, k
    rows = rows.float()
    wt, wmask = tcs.stencil_weight_prep_ref(wc, kp, n_pad)
    band = tcs.stencil_band_ranges_ref(wmask, kp, n_pad)
    frags = tcs.stencil_weight_fragments_ref(wt, kp, n_pad).float()  # (9, steps, pairs, 32, 8)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    ks = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] * 2, dim=-1)
    ns = torch.stack([g] * 4 + [g + 8] * 4, dim=-1)
    blocks = torch.zeros(9, kp // 16, n_pad // 16, 16, 16)
    blocks[:, :, :, ks, ns] = frags  # B[k, n] as the lanes hand it to mma.m16n8k16
    pos = tcs.stencil_positions_ref(qids, src_ids, flags).long()
    b, vq = qids.shape[0], qids.shape[-1]
    out = torch.zeros(b, vq, nc, n_pad)
    multiplied = 0
    groups = -(-vq // 16)
    for bi, chunk, j in itertools.product(range(b), range(nc), range(9)):
        p = pos[bi, j]
        hit = F.pad((p >= 0).float(), (0, groups * 16 - vq)).view(groups, 16).any(-1)
        a = torch.zeros(vq, kp)
        a[:, :ka] = rows[bi, p.clamp(min=0), chunk * ka:(chunk + 1) * ka] * (p >= 0)[:, None]
        for step in range(kp // 16):
            lo, hi = (int(v) for v in band[j, step])
            for cw in range(col_warps):
                mine = [q for q in range(lo, hi) if q // 8 == cw]
                if bi == chunk == 0:
                    multiplied += len(mine) * int(hit.sum())
                for pair in mine:
                    out[bi, :, chunk, pair * 16:(pair + 1) * 16] += a[:, step * 16:(step + 1) * 16] @ blocks[j, step, pair]
    return out[..., :n].reshape(b, vq, nc * n), multiplied / groups


@pytest.mark.parametrize("nc,k,n", [(2, 128, 640), (1, 640, 256), (3, 448, 128)],
                         ids=["640_columns_3_tiles", "640_lane_d_src", "448_lane_d_src_3_chunks"])
def test_widened_tiling_emulation_equals_plain(nc, k, n):
    """The widened shapes (a 640-wide forward at two chunks; contractions of
    640 and 448 lanes, ``d_src`` of the wide layers) on the wide tile that
    now takes them (a 16-query group's warps own a chunk's whole width, no
    column tiles), with weights whose 16-lane blocks are 60% zero: the
    emulated warps rebuild ``stencil_conv_ref`` (on the rows rounded to
    bfloat16) within 1e-5 of its scale, and skip the all-zero steps."""
    src, src_ids, _, qids, _, wc, _ = chip_smoke.stencil_edge_case(2, 200, 300, nc, k, n, 0.3, 11,
                                                                   torch.device("cpu"))
    src = src.to(torch.bfloat16)
    got, multiplied = emulate_conv_wide(src, qids, src_ids, wc, nc)
    want = tcs.stencil_conv_ref(src, qids, src_ids, wc.to(torch.bfloat16), nc)
    close(got, want, 1e-5)
    steps, pairs = -(-k // 64) * 4, -(-n // 16)
    assert 0 < multiplied < 9 * steps * pairs  # the all-zero steps skipped


def column_band(cin, cout, nz, stride, seed):
    """A column layer's chunk plan and band weights ``(9, kzp, z·Cout)``."""
    plan = tcs._chunk_plan(cin, nz, stride)
    w = torch.from_numpy((np.random.RandomState(seed).randn(9, 3, cin, cout) * 0.3).astype(np.float32))
    return plan, tcs._chunk_weights(w, plan, stride)


@pytest.mark.parametrize("cin,cout,nz,stride,side", [
    (3, 16, 40, 1, "forward"), (16, 32, 20, 1, "forward"), (16, 16, 40, 1, "forward"),
    (3, 16, 40, 1, "d_src"), (16, 32, 20, 1, "d_src"), (16, 16, 40, 1, "d_src"), (16, 16, 20, 2, "d_src")],
    ids=["640_columns", "448_columns_2_chunks", "224_columns_3_chunks", "d_src_640_lanes",
         "d_src_448_lanes", "d_src_224_lanes", "d_src_strided_112_lanes"])
def test_wide_tile_emulation_equals_plain_at_column_shapes(cin, cout, nz, stride, side):
    """The wide tile at the dense-z column middle's shapes with its band
    weights: the forward at 640, 448 and 224 columns (1, 2 and 3 chunks) and
    ``d_src`` (the float32 cotangent read as it is and rounded to bfloat16 as
    it is read, zero cotangent rows flagged) rebuild ``stencil_conv_ref``
    within 1e-5 of its scale, and a 16-query group's warps multiply only the
    band: at most half the 16 x 16 weight blocks of every step and pair."""
    plan, wc = column_band(cin, cout, nz, stride, seed=cin + nz)
    kzp, n = wc.shape[1:]
    vs, vq = (150, 200) if side == "forward" else (200, 150)
    k, width = (kzp, n) if side == "forward" else (n, kzp)
    src, src_ids, _, qids, _, _, _ = chip_smoke.stencil_edge_case(
        2, vs, vq, plan.nc, k, width, 0.4, 21, torch.device("cpu"))
    w = wc if side == "forward" else wc.transpose(1, 2)
    if side == "d_src":
        src[:, ::3] = 0  # the caps' zero cotangent rows
        assert tcs.stencil_mma_variant(k, width, plan.nc, torch.float32)["rows_dtype"] == torch.float32
    else:
        src = src.to(torch.bfloat16)
    got, multiplied = emulate_conv_wide(src, qids, src_ids, w, plan.nc)
    want = tcs.stencil_conv_ref(src.to(torch.bfloat16), qids, src_ids, w.to(torch.bfloat16), plan.nc)
    close(got, want, 1e-5)
    var = tcs.stencil_mma_variant(k, width, plan.nc, src.dtype)
    assert 0 < multiplied <= 9 * (var["kp"] // 16) * (var["n_pad"] // 16) // 2
    # The route's plain version agrees: the ranges keep every non-zero.
    close(tcs.stencil_conv_mma_ref(src, qids, src_ids, w, plan.nc), want, 1e-5)


@settings(max_examples=40, deadline=None)
@given(k=st.integers(1, 640), n=st.integers(1, 640), seed=st.integers(0, 2 ** 16), banded=st.booleans(),
       density=st.floats(0.0, 1.0))
def test_band_ranges_cover_every_nonzero(k, n, seed, banded, density):
    """``stencil_band_ranges_ref`` (the plain ``band_ranges_kernel``) over the
    bitmap of ``stencil_weight_prep_ref``: for every offset and 16-lane step,
    no non-zero weight lies outside the step's range, and an empty range
    means an all-zero step; for a random matrix, banded (a window of
    columns a step) or not."""
    rng = np.random.RandomState(seed)
    wc = rng.randn(9, k, n).astype(np.float32) * (rng.rand(9, k, n) < density)
    if banded:
        rows = np.arange(k)[:, None] * n // k
        wc *= np.abs(np.arange(n)[None, :] - rows) < 1 + rng.randint(0, max(1, n // 4))
    kp, n_pad = -(-k // 64) * 64, -(-n // 16) * 16
    wt, wmask = tcs.stencil_weight_prep_ref(torch.from_numpy(wc), kp, n_pad)
    band = tcs.stencil_band_ranges_ref(wmask, kp, n_pad).numpy()
    nz = wt.float().numpy() != 0  # (9, n_pad, kp)
    for j, step in itertools.product(range(9), range(kp // 16)):
        cols = np.nonzero(nz[j, :, step * 16:(step + 1) * 16].any(axis=1))[0]
        lo, hi = band[j, step]
        if len(cols) == 0:
            assert lo == hi == 0
        else:
            assert lo * 16 <= cols.min() and cols.max() < hi * 16 and hi <= n_pad // 16
            assert cols.min() // 16 == lo and cols.max() // 16 == hi - 1  # the tightest pairs


@pytest.mark.parametrize("nc,kzp,n,weights", [(1, 128, 640, "band"), (3, 256, 224, "band"), (2, 128, 68, "dense"),
                                              (1, 30, 16, "blocks")])
def test_band_ops_counts_the_band_alone(nc, kzp, n, weights):
    """``chip_smoke.band_ops``, the operations the forward's and ``d_src``'s
    bounds count: 2 x 16 x 16 a hit, a chunk and a (16-lane step, 16-column
    pair) between the step's first and last non-zero column pair, found here
    from the weights directly; at least the non-zeros' products, at most
    the whole padded matrix's."""
    src, src_ids, _, qids, _, wc, _ = chip_smoke.stencil_edge_case(2, 90, 80, nc, kzp, n, 0.4, 5, torch.device("cpu"),
                                                                   weights)
    pos = tcs.stencil_positions_ref(qids, src_ids)
    hits = (pos >= 0).sum(dim=(0, 2)).numpy()
    nz = wc.to(torch.bfloat16).float().numpy() != 0  # (9, kzp, n)
    blocks = np.zeros(9, dtype=np.int64)
    for j, step in itertools.product(range(9), range(-(-kzp // 16))):
        cols = np.nonzero(nz[j, step * 16:(step + 1) * 16].any(axis=0))[0]
        if len(cols):
            blocks[j] += cols.max() // 16 + 1 - cols.min() // 16
    got = chip_smoke.band_ops(pos, wc, nc)
    assert got == 2 * nc * int((hits * blocks).sum()) * 256
    assert 2 * nc * int((hits * nz.sum(axis=(1, 2))).sum()) <= got
    assert got <= 2 * nc * int(hits.sum()) * (-(-kzp // 16) * 16) * (-(-n // 16) * 16)
