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
- a CPU emulation of the stencil's tensor-core route at the column shapes it
  was widened for (256-column tiles, a 640-lane contraction in 64-lane
  slices), held to ``stencil_conv_ref``.

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


# ------------------------------------------- the widened tensor-core tiling


def emulate_conv_mma(src, qids, src_ids, wc, nc, queries=128):
    """``conv_mma_kernel`` of ``csrc/conv_mma.cuh`` on the CPU: blocks of 128
    queries x one chunk x one column tile (128 columns, or 256 for wider
    outputs; a tile's bits sit in its 256-column word of the bitmap), each
    walking the (offset, 64-lane
    slice) pairs that have a hit in the block and a non-zero weight block in
    its tile (:func:`stencil_weight_prep_ref`'s bitmap), each 16-lane step
    multiplying only the 16 x 8 blocks its word marks; float32 sums. Returns
    the output and how many pairs each block walked."""
    k, n = wc.shape[1:]
    var = tcs.stencil_mma_variant(k, n)
    kp, n_pad, tile_cols = var["kp"], var["n_pad"], var["cols"]
    assert var["col_tiles"] == -(-n_pad // tile_cols)
    rows, _ = tcs.stencil_rows_prep_ref(src, nc, k, kp, torch.float32)
    wt, wmask = tcs.stencil_weight_prep_ref(wc, kp, n_pad, torch.float32)
    tiles, msteps = -(-n_pad // 256), max(16, kp // 16)
    words = wmask.reshape(9, tiles, msteps)
    pos = tcs.stencil_positions_ref(qids, src_ids).long()
    b, vq = qids.shape[0], qids.shape[-1]
    out = torch.zeros(b, vq, nc, n_pad)
    walked = []
    for bi, chunk, ct, q0 in itertools.product(range(b), range(nc), range(var["col_tiles"]),
                                              range(0, vq, queries)):
        cols = slice(ct * tile_cols, min(n_pad, (ct + 1) * tile_cols))
        word, shift = divmod(ct * tile_cols, 256)
        pairs = 0
        for j in range(9):
            p = pos[bi, j, q0:q0 + queries]
            if not (p >= 0).any():
                continue
            a = rows[bi, p.clamp(min=0), chunk * kp:(chunk + 1) * kp] * (p >= 0)[:, None]
            for sl in range(kp // 64):
                w_words = words[j, word, sl * 4:(sl + 1) * 4] >> (shift // 8)
                if not (w_words != 0).any():
                    continue
                pairs += 1
                for ks in range(4):
                    step = sl * 4 + ks
                    bits = int(words[j, word, step]) >> (shift // 8)
                    keep = torch.tensor([(bits >> (c // 8)) & 1 for c in range(cols.stop - cols.start)],
                                        dtype=torch.float32)
                    out[bi, q0:q0 + queries, chunk, cols] += (
                        a[:, step * 16:(step + 1) * 16] @ (wt[j, cols, step * 16:(step + 1) * 16].T * keep))
        walked.append(pairs)
    return out[..., :n].reshape(b, vq, nc * n), walked


@pytest.mark.parametrize("nc,k,n", [(2, 128, 640), (1, 640, 256), (3, 448, 128)],
                         ids=["640_columns_3_tiles", "640_lane_d_src", "448_lane_d_src_3_chunks"])
def test_widened_tiling_emulation_equals_plain(nc, k, n):
    """Column tiles of 256 (a 640-wide forward: three tiles, the last half
    full) and a contraction of 640 or 448 lanes in 64-lane slices (``d_src``
    of the wide layers), with band weights whose zero blocks the bitmap
    skips: the emulated blocks rebuild ``stencil_conv_ref`` within 1e-5 of
    its scale, and skip work where the bitmap says so."""
    src, src_ids, _, qids, _, wc, _ = chip_smoke.stencil_edge_case(2, 200, 300, nc, k, n, 0.3, 11,
                                                                   torch.device("cpu"))
    got, walked = emulate_conv_mma(src, qids, src_ids, wc, nc)
    want = tcs.stencil_conv_ref(src, qids, src_ids, wc, nc)
    close(got, want, 1e-5)
    assert max(walked) <= 9 * (-(-k // 64)) and min(walked) < 9 * (-(-k // 64))
