"""Port parity for the z-slab unit ops of ``ops/column_sparse.py``:
``units_from_voxels``, ``_insert_ghosts``, ``_even_select``,
``downsample_units``, the stencil conv (the plain version of the CUDA kernel
``csrc/stencil_conv.cu``), ``subm_conv_units_batched``,
``strided_conv_units_batched`` and ``units_to_dense_bev``, each against the
JAX function on the same numpy inputs.

Tolerances: ids, validity, masks, output positions and query ids exact (the
caps and ghost rules are integer arithmetic that decides which units
survive); placed features and dense maps exact (copies); conv outputs 1e-4
of the output scale (float32 sums of 9·kz products in another order; seen
below 1e-6); the strided layer's output masks exact (a count of ones). The
JAX stencil runs both as its reference (``method="ref"``) and as the Pallas
kernel in interpret mode, as in ``tests/test_unit_sparse.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import column_sparse as jcs
from lyft3d_tpu.ops.sparse_conv import ActiveSet as JActiveSet
from lyft3d_tpu_torch.ops import column_sparse as tcs
from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet

CONV_TOL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def random_voxels(seed, shape, n, cap, sort=False, odd_xy=False):
    """Unique voxel coords padded to ``cap``; ``sort`` gives the voxelizer's
    (y, x, z) order; ``odd_xy`` keeps odd x and y only (4 parents a unit)."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    if odd_xy:
        flat = rng.choice((nx // 2) * (ny // 2) * nz, n, replace=False)
        x, y, z = 2 * (flat % (nx // 2)) + 1, 2 * ((flat // (nx // 2)) % (ny // 2)) + 1, flat // ((nx // 2) * (ny // 2))
    else:
        flat = rng.choice(nx * ny * nz, n, replace=False)
        x, y, z = flat % nx, (flat // nx) % ny, flat // (nx * ny)
    if sort:
        order = np.argsort((y * nx + x) * nz + z)
        x, y, z = x[order], y[order], z[order]
    coords = np.zeros((cap, 3), np.int32)
    coords[:n] = np.stack([x, y, z], -1)
    return coords, np.arange(cap) < n


def jactive(coords, valid, shape):
    return JActiveSet(jnp.asarray(coords), jnp.asarray(valid), shape)


def tactive(coords, valid, shape):
    return ActiveSet(t(coords), t(valid), shape)


def stack_trees(xs):
    return jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *xs)


def to_torch_cols(jcols):
    return tcs.ColumnSet(t(jcols.col_ids), t(jcols.valid), t(jcols.mask), jcols.bev_shape, jcols.nz)


def assert_same_cols(got, want, mask=True):
    assert got.bev_shape == tuple(want.bev_shape) and got.nz == want.nz
    np.testing.assert_array_equal(got.col_ids.numpy(), np.asarray(want.col_ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if mask:
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def close(got, want, tol=CONV_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0)


# ------------------------------------------------------------ building units


@pytest.mark.parametrize("seed,shape,z_slab,n,cap,sort,unit_cap", [
    (0, (14, 12, 8), 4, 80, 100, False, None),
    (1, (9, 9, 4), 2, 50, 64, True, None),
    (2, (9, 8, 7), 3, 40, 64, False, None),      # uneven slab tail
    (3, (6, 6, 16), 4, 200, 200, True, None),    # dense columns: many ghosts, tail unit at the end
    (4, (6, 6, 16), 4, 200, 256, True, 90),      # the unit cap drops units
], ids=["unsorted", "sorted", "uneven_tail", "dense", "cap_overflow"])
def test_units_from_voxels_equal(seed, shape, z_slab, n, cap, sort, unit_cap):
    coords, valid = random_voxels(seed, shape, n, cap, sort=sort)
    feats = np.random.RandomState(seed).randn(cap, 5).astype(np.float32)
    jcols, jf = jcs.units_from_voxels(jnp.asarray(feats), jactive(coords, valid, shape), z_slab,
                                      sort, unit_cap)
    tcols, tf = tcs.units_from_voxels(t(feats), tactive(coords, valid, shape), z_slab, sort, unit_cap)
    assert_same_cols(tcols, jcols)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    n_units = int(np.asarray(jcols.valid).sum())
    ghosts = n_units - int(np.asarray(jcols.mask).any(-1).sum())
    if unit_cap is None:
        assert int(np.asarray(jcols.mask).sum()) == n  # every voxel placed
    else:
        assert n_units == unit_cap and int(np.asarray(jcols.mask).sum()) < n  # the cap bit
    if seed == 3:
        assert ghosts > 0


def test_units_from_voxels_batched_equals_per_sample():
    shape = (10, 11, 8)
    sets = [random_voxels(s, shape, 60 + s, 80, sort=True) for s in (5, 6)]
    coords, valid = (np.stack(a) for a in zip(*sets))
    feats = np.random.RandomState(5).randn(2, 80, 3).astype(np.float32)
    cols, f = tcs.units_from_voxels(t(feats), tactive(coords, valid, shape), 4, True)
    for b in range(2):
        c1, f1 = tcs.units_from_voxels(t(feats[b]), tactive(coords[b], valid[b], shape), 4, True)
        assert torch.equal(cols.col_ids[b], c1.col_ids) and torch.equal(cols.mask[b], c1.mask)
        assert torch.equal(f[b], f1)


@pytest.mark.parametrize("cap,n_ids", [(16, 10), (16, 103), (7, 50)])
def test_even_select_equal(cap, n_ids):
    vals = np.concatenate([np.sort(np.random.RandomState(cap).choice(10_000, n_ids, replace=False)),
                           np.full(29, 2 ** 30)]).astype(np.int32)
    want = np.asarray(jcs._even_select(jnp.asarray(vals), jnp.int32(n_ids), cap))
    got = tcs._even_select(t(vals).long(), torch.tensor([n_ids]), cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unit_cap", [64, 20], ids=["fits", "cap_overflow"])
def test_insert_ghosts_equal(unit_cap):
    """Runs of adjacent slabs, shared ghosts between units two apart, ghosts
    refused at a column's first and last slab, and a padded tail."""
    ncs, bigu = 5, 500
    ids = np.array([0, 2, 3, 7, 9, 14, 20, 21, 22, 24, 31, 33, 40, 44] + [bigu] * 6, np.int32)
    rng = np.random.RandomState(unit_cap)
    valid = ids < bigu
    first, last = rng.rand(len(ids)) < 0.7, rng.rand(len(ids)) < 0.7
    want = jcs._insert_ghosts(jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(first),
                              jnp.asarray(last), ncs, jnp.int32(bigu), unit_cap)
    got = tcs._insert_ghosts(t(ids).long(), t(valid), t(first), t(last), ncs, bigu, unit_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(np.asarray(want[1]).sum()) > valid.sum() or unit_cap == 20


# ------------------------------------------------------------- downsampling


# The JAX references run jitted: eager dispatch compiles every primitive of
# these long index pipelines on its own.
j_units_from_voxels = jax.jit(jcs.units_from_voxels, static_argnums=(2, 3, 4))
j_downsample_units = jax.jit(jcs.downsample_units, static_argnums=(1, 2))


def unit_pair(seed, shape, z_slab, n, cap, **kw):
    coords, valid = random_voxels(seed, shape, n, cap, sort=True, **kw)
    feats = np.random.RandomState(seed).randn(cap, 3).astype(np.float32)
    ju = j_units_from_voxels(jnp.asarray(feats), jactive(coords, valid, shape), z_slab, True, None)
    tu = tcs.units_from_voxels(t(feats), tactive(coords, valid, shape), z_slab, True)
    return ju, tu


@pytest.mark.parametrize("seed,shape,n,max_out,odd,what", [
    (7, (12, 10, 8), 55, 256, False, "fits"),
    (3, (32, 32, 8), 250, 100, False, "out_cap"),
    (8, (64, 64, 8), 60, 16, True, "parent_cap"),
    (9, (6, 6, 8), 1, 64, False, "tiny"),
], ids=["fits", "out_cap_overflow", "parent_cap_overflow", "fewer_candidates_than_slots"])
def test_downsample_units_equal(seed, shape, n, max_out, odd, what):
    (jcols, _), (tcols, _) = unit_pair(seed, shape, 4, n, n + 6, odd_xy=odd)
    want = j_downsample_units(jcols, 2, max_out)
    got = tcs.downsample_units(tcols, 2, max_out)
    assert_same_cols(got, want)
    n_out = int(np.asarray(want.valid).sum())
    full = int(np.asarray(j_downsample_units(jcols, 2, 4096).valid).sum())
    if what == "out_cap":
        assert n_out == max_out < full
    elif what == "parent_cap":
        # 4 parents a unit, none shared: more than 3·Vu of them, so ranks are dropped.
        vu = np.asarray(jcols.col_ids).shape[0]
        assert full > 3 * vu and n_out == max_out
    else:
        assert n_out == full


# ------------------------------------------------------------ the stencil conv


def stencil_case(seed, b, vs, vq, nc, kzp, n):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, vs, nc * kzp).astype(np.float32)
    ids = np.full((b, vs), jcs.PAD_ID, np.int32)
    qids = np.full((b, 9, vq), -1, np.int32)
    for i in range(b):
        n_src = vs - 3 - i
        ids[i, :n_src] = np.sort(rng.choice(400, n_src, replace=False))
        # Ascending queries per offset: hits, misses (ids not in the source) and absent (−1).
        for j in range(9):
            q = np.sort(rng.choice(400, vq, replace=False))
            qids[i, j] = np.where(rng.rand(vq) < 0.2, -1, q)
    wc = (rng.randn(9, kzp, n) * 0.3).astype(np.float32)
    return src, qids, ids, wc


@pytest.mark.parametrize("nc,kzp,n", [(1, 128, 24), (2, 128, 10)], ids=["nc1", "nc2"])
@pytest.mark.parametrize("method", ["ref", "pallas_interpret"])
def test_stencil_conv_ref_matches_jax(method, nc, kzp, n):
    src, qids, ids, wc = stencil_case(nc, 2, 40, 48, nc, kzp, n)
    want = jcs.stencil_conv_batched(jnp.asarray(src), jnp.asarray(qids), jnp.asarray(ids),
                                    jnp.asarray(wc), nc, 256, 384, method)
    got = tcs.stencil_conv_ref(t(src), t(qids), t(ids), t(wc), nc)
    assert got.shape == (2, 48, nc * n) and got.dtype == torch.float32
    close(got, want, 1e-5)
    hits = np.isin(qids[0], ids[0]) & (qids[0] >= 0)
    assert 0 < hits.mean() < 1
    before = tcs.KERNEL_LAUNCHES
    assert torch.equal(tcs.stencil_conv_batched(t(src), t(qids), t(ids), t(wc), nc), got)
    close(tcs.stencil_conv_batched(t(src[1]), t(qids[1]), t(ids[1]), t(wc), nc), got[1].numpy(), 1e-6)
    assert tcs.KERNEL_LAUNCHES == before  # CPU tensors take the plain version


def test_stencil_conv_argument_checks_and_no_fallback(monkeypatch):
    src, qids, ids, wc = (t(a) for a in stencil_case(0, 1, 16, 8, 1, 128, 4))
    with pytest.raises(TypeError, match="int32"):
        tcs.stencil_conv_batched(src, qids.long(), ids, wc, 1)
    with pytest.raises(ValueError, match="nc·kzp"):
        tcs.stencil_conv_batched(src, qids, ids, wc, 2)
    with pytest.raises(ValueError, match="meta"):
        tcs.stencil_conv_batched(*(a.to("meta") for a in (src, qids, ids, wc)), 1)
    from lyft3d_tpu_torch import _build

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "load_library", broken)
    monkeypatch.setattr(tcs, "stencil_conv_ref", lambda *a: pytest.fail("fell back to the plain version"))
    with pytest.raises(RuntimeError, match="cannot build stencil_conv"):
        tcs._stencil_conv_cuda(src, qids, ids, wc, 1)


# ---------------------------------------------------------------- unit convs


@pytest.mark.parametrize("seed,shape,z_slab,nz", [(3, (10, 11, 8), 4, 8), (4, (9, 8, 7), 3, 7)],
                         ids=["even_slabs", "uneven_slab_tail"])
def test_subm_conv_units_matches_jax(seed, shape, z_slab, nz):
    cin, cout, ncs = 3, 6, -(-nz // z_slab)
    w = (np.random.RandomState(seed).randn(27, cin, cout) * 0.3).astype(np.float32)
    pairs = [unit_pair(seed + 10 * i, shape, z_slab, 56 + 3 * i, 80) for i in range(2)]
    jcols = stack_trees([p[0][0] for p in pairs])
    jf = jnp.stack([p[0][1] for p in pairs])
    tcols = to_torch_cols(jcols)
    np.testing.assert_array_equal(tcs.unit_qids_subm(tcols, ncs).numpy(),
                                  np.asarray(jax.vmap(lambda c: jcs.unit_qids_subm(c, ncs))(jcols)))
    want = jcs.subm_conv_units_batched(jf, jcols, jnp.asarray(w), ncs, method="ref")
    got = tcs.subm_conv_units_batched(t(jf), tcols, t(w), ncs)
    assert got.dtype == torch.float32
    close(got, want)
    # Dense BEV of the masked result, as the middle hands it on.
    masked = got * tcols.mask[..., None]
    want_dense = jax.vmap(lambda o, u: jcs.units_to_dense_bev(o, u, ncs, nz))(
        want * jcols.mask[..., None], jcols)
    got_dense = tcs.units_to_dense_bev(masked, tcols, ncs, nz)
    assert got_dense.shape == (2, shape[1], shape[0], nz * cout)
    close(got_dense, want_dense)
    np.testing.assert_array_equal(
        tcs.units_to_dense_bev(t(want * jcols.mask[..., None]), tcols, ncs, nz).numpy(),
        np.asarray(want_dense))


@pytest.mark.parametrize("method", ["ref", "pallas_interpret"])
def test_strided_conv_units_matches_jax(method):
    shape, z_slab, ncs, cin, cout = (12, 10, 8), 4, 2, 3, 5
    w = (np.random.RandomState(7).randn(27, cin, cout) * 0.3).astype(np.float32)
    pairs = [unit_pair(70 + i, shape, z_slab, 50 + 4 * i, 80) for i in range(2)]
    jcols = stack_trees([p[0][0] for p in pairs])
    jf = jnp.stack([p[0][1] for p in pairs])
    jout_cols = jax.jit(jax.vmap(lambda c: jcs.downsample_units(c, ncs, 256)))(jcols)
    tcols = to_torch_cols(jcols)
    tout_cols = tcs.downsample_units(tcols, ncs, 256)
    assert_same_cols(tout_cols, jout_cols)
    want, want_mask = jcs.strided_conv_units_batched(jf, jcols, jout_cols, jnp.asarray(w), ncs,
                                                     method=method)
    got, got_mask = tcs.strided_conv_units_batched(t(jf), tcols, tout_cols, t(w), ncs)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    close(got, want)
    assert 0 < np.asarray(want_mask).mean() < 1
    # Ghost outputs (valid, all cells inactive) exist and stay.
    ghosts = np.asarray(jout_cols.valid) & ~np.asarray(want_mask).any(-1)
    assert ghosts.any()


@pytest.mark.cuda
def test_stencil_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    src, qids, ids, wc = (t(a).cuda() for a in stencil_case(1, 2, 300, 260, 2, 128, 68))
    got = tcs.stencil_conv_batched(src, qids, ids, wc, 2)
    torch.cuda.synchronize()
    want = tcs.stencil_conv_ref(src, qids, ids, wc, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # The tensor-core route at widths that need padding (68 → 80 columns, 30 →
    # 64 lanes), at 256 columns, and at the widths it takes since the dense-z
    # column middle needs them: a contraction of 300 lanes (the wide tile:
    # more than 256 lanes) and 640 output columns at 2 chunks (the wide tile,
    # five 128-column warps a 16-query group); its
    # preparation kernels are held to their plain versions in
    # tests/test_torch_sparse_kernels_dispatch.py.
    for nc, kzp, n in ((2, 128, 68), (1, 30, 65), (1, 256, 256), (1, 300, 8), (2, 128, 640)):
        src, qids, ids, wc = (t(a).cuda() for a in stencil_case(3, 2, 300, 260, nc, kzp, n))
        src16, wc16 = src.bfloat16(), wc.bfloat16()
        got = tcs.stencil_conv_batched(src16, qids, ids, wc16, nc)
        want = tcs.stencil_conv_ref(src16, qids, ids, wc16, nc)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):  # still refused: a contraction above 640 lanes
        tcs.stencil_conv_batched(torch.zeros(2, 300, 700, device="cuda", dtype=torch.bfloat16), qids, ids,
                                 torch.zeros(9, 700, 8, device="cuda"), 1)


# ------------------------------------------------------------------ gradients
#
# Tolerance: 1e-5 of the gradient's scale in float32 (sums of the same
# products in another order). Reverse-query arrays are integer arithmetic and
# compared exactly.

GRAD_TOL = 1e-5


def unit_batch(seeds, shape, z_slab, n, cap):
    pairs = [unit_pair(s, shape, z_slab, n + 3 * i, cap) for i, s in enumerate(seeds)]
    jcols = stack_trees([p[0][0] for p in pairs])
    jf = jnp.stack([p[0][1] for p in pairs])
    return jcols, jf, to_torch_cols(jcols)


@pytest.mark.parametrize("rev", [True, False], ids=["rev_qids", "legacy"])
@pytest.mark.parametrize("method", ["ref", "pallas_interpret"])
def test_stencil_conv_gradients_match_jax(method, rev):
    """d_src and d_wc of the submanifold stencil (symmetric queries, so that
    reverse queries exist) against jax.grad, with the reverse queries and
    through the legacy branch without them."""
    shape, z_slab, ncs, cin, cout = (10, 11, 8), 4, 2, 3, 4
    jcols, jf, tcols = unit_batch((3, 13), shape, z_slab, 56, 80)
    rng = np.random.RandomState(0)
    kzp = 128
    jsrc = jax.vmap(lambda f, i, v: jcs._unit_rows_padded(f, i, v, ncs, bottom=True))(
        jf * jcols.mask[..., None], jcols.col_ids, jcols.valid)
    wc = (rng.randn(9, kzp, z_slab * cout) * 0.3).astype(np.float32)
    jq = jax.vmap(lambda c: jcs.unit_qids_subm(c, ncs))(jcols)
    tgt = rng.randn(*jsrc.shape[:2], z_slab * cout).astype(np.float32)

    def jloss(s, w):
        o = jcs.stencil_conv_batched(s, jq, jcols.col_ids, w, 1, 256, 384, method,
                                     rev_qids=jq[:, ::-1] if rev else None,
                                     rev_src_ids=jcols.col_ids if rev else None)
        return jnp.sum(jnp.sin(o) * tgt)

    want_s, want_w = jax.grad(jloss, argnums=(0, 1))(jsrc, jnp.asarray(wc))
    src = t(jsrc).requires_grad_(True)
    w = t(wc).requires_grad_(True)
    tq = t(jq)
    out = tcs.stencil_conv_batched(src, tq, tcols.col_ids, w, 1,
                                   rev_qids=tq.flip(-2) if rev else None,
                                   rev_src_ids=tcols.col_ids if rev else None)
    (torch.sin(out) * t(tgt)).sum().backward()
    close(src.grad, want_s, GRAD_TOL)
    close(w.grad, want_w, GRAD_TOL)
    assert float(np.abs(want_s).max()) > 0 and float(np.abs(want_w).max()) > 0


@pytest.mark.parametrize("method", ["ref", "pallas_interpret"])
def test_padded_cotangent_route_of_d_src_matches_jax(method):
    """d_src as the tensor-core route takes it (cotangent rows padded from 16
    lanes to a whole 64-lane slice, zero rows turned into misses, transposed
    weights through the block bitmap), in float32 values, against the JAX
    package's ``_stencil_bwd`` on the reverse queries."""
    shape, z_slab, ncs, cout = (10, 11, 8), 4, 2, 4
    jcols, jf, tcols = unit_batch((3, 13), shape, z_slab, 56, 80)
    rng = np.random.RandomState(0)
    kzp, n = 128, z_slab * cout
    jsrc = jax.vmap(lambda f, i, v: jcs._unit_rows_padded(f, i, v, ncs, bottom=True))(
        jf * jcols.mask[..., None], jcols.col_ids, jcols.valid)
    wc = (rng.randn(9, kzp, n) * 0.3).astype(np.float32)
    jq = jax.vmap(lambda c: jcs.unit_qids_subm(c, ncs))(jcols)
    cot = rng.randn(*jsrc.shape[:2], n).astype(np.float32)
    cot[:, ::3] = 0

    def jout(s):
        return jcs.stencil_conv_batched(s, jq, jcols.col_ids, jnp.asarray(wc), 1, 256, 384, method,
                                        rev_qids=jq[:, ::-1], rev_src_ids=jcols.col_ids)

    want, = jax.vjp(jout, jsrc)[1](jnp.asarray(cot))
    tq = t(jq)
    assert tcs.stencil_mma_variant(n, kzp)["kp"] == 64
    got = tcs.stencil_conv_mma_ref(t(cot), tq.flip(-2), tcols.col_ids, t(wc).transpose(1, 2), 1,
                                   dtype=torch.float32)
    close(got, want, GRAD_TOL)
    assert float(np.abs(want).max()) > 0


def test_stencil_backward_rev_equals_plain_autograd(monkeypatch):
    """The reverse-query d_src equals autograd of the plain forward, for the
    strided layer's queries too (asymmetric: the cotangent's ids are the
    output units', with the invalid tail above every valid id)."""
    shape, z_slab, ncs = (12, 10, 8), 4, 2
    jcols, jf, tcols = unit_batch((70, 71), shape, z_slab, 50, 80)
    out_cols = tcs.downsample_units(tcols, ncs, 96)
    ids = out_cols.col_ids.long()
    big = int(ids.max())
    assert (ids[..., 1:] >= ids[..., :-1]).all()  # ascending, PAD at the tail
    assert (ids[~out_cols.valid] == big).all() and (ids[out_cols.valid] < big).all()
    w = t((np.random.RandomState(1).randn(27, 3, 5) * 0.3).astype(np.float32))
    stencil = tcs.stencil_conv_batched

    def run():
        f = t(jf).requires_grad_(True)
        wt = w.clone().requires_grad_(True)
        o, _ = tcs.strided_conv_units_batched(f, tcols, out_cols, wt, ncs)
        torch.sin(o).sum().backward()
        return f.grad, wt.grad

    with_rev = run()
    # The same layer with the reverse queries dropped: the legacy branch.
    monkeypatch.setattr(tcs, "stencil_conv_batched",
                        lambda s, q, i, wc, nc, rev_qids=None, rev_src_ids=None: stencil(s, q, i, wc, nc))
    legacy = run()
    close(with_rev[0], legacy[0].numpy(), GRAD_TOL)
    close(with_rev[1], legacy[1].numpy(), GRAD_TOL)
    assert float(with_rev[0].abs().max()) > 0


def test_rev_qids_equal_jax():
    """Reverse queries, exact: submanifold (the flip) and strided (floor
    division and modulo on negative coordinates)."""
    shape, z_slab, ncs = (12, 10, 8), 4, 2
    jcols, jf, tcols = unit_batch((70, 71), shape, z_slab, 50, 80)
    jout = jax.jit(jax.vmap(lambda c: jcs.downsample_units(c, ncs, 256)))(jcols)
    tout = tcs.downsample_units(tcols, ncs, 256)
    captured = {}
    orig = jcs.stencil_conv_batched

    def spy(*a, rev_qids=None, rev_src_ids=None, **k):
        captured["rev_qids"], captured["rev_src_ids"] = rev_qids, rev_src_ids
        return orig(*a, rev_qids=rev_qids, rev_src_ids=rev_src_ids, **k)

    jcs.stencil_conv_batched = spy
    try:
        w = jnp.zeros((27, 3, 2), jnp.float32)
        jcs.strided_conv_units_batched(jf, jcols, jout, w, ncs, method="ref")
        got = tcs.rev_qids_strided(tcols, tout, ncs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(captured["rev_qids"]))
        np.testing.assert_array_equal(tout.col_ids.numpy(), np.asarray(captured["rev_src_ids"]))
        assert (got.numpy() >= 0).any() and (got.numpy() < 0).any()
        jcs.subm_conv_units_batched(jf, jcols, jnp.zeros((27, 3, 2), jnp.float32), ncs, method="ref")
        np.testing.assert_array_equal(tcs.unit_qids_subm(tcols, ncs).flip(-2).numpy(),
                                      np.asarray(captured["rev_qids"]))
    finally:
        jcs.stencil_conv_batched = orig


@pytest.mark.parametrize("layer", ["subm", "strided"])
def test_unit_layer_gradients_match_jax(layer):
    """Gradients of the unit layers w.r.t. the unit features and the
    (27, C, Cout) kernel: through masks, halos, band weights, the mask channel
    of the strided layer and the kernel's Function."""
    shape, z_slab, ncs, cin, cout = (12, 10, 8), 4, 2, 3, 5
    jcols, jf, tcols = unit_batch((70, 71), shape, z_slab, 50, 80)
    w = (np.random.RandomState(7).randn(27, cin, cout) * 0.3).astype(np.float32)
    if layer == "subm":
        def jloss(f, wt):
            return jnp.sum(jnp.sin(jcs.subm_conv_units_batched(f, jcols, wt, ncs, method="ref")))

        def tloss(f, wt):
            return torch.sin(tcs.subm_conv_units_batched(f, tcols, wt, ncs)).sum()
    else:
        jout = jax.jit(jax.vmap(lambda c: jcs.downsample_units(c, ncs, 256)))(jcols)
        tout = tcs.downsample_units(tcols, ncs, 256)

        def jloss(f, wt):
            o, m = jcs.strided_conv_units_batched(f, jcols, jout, wt, ncs, method="ref")
            return jnp.sum(jnp.sin(o) * m[..., None])

        def tloss(f, wt):
            o, m = tcs.strided_conv_units_batched(f, tcols, tout, wt, ncs)
            return (torch.sin(o) * m[..., None]).sum()

    want_f, want_w = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jf, jnp.asarray(w))
    f = t(jf).requires_grad_(True)
    wt = t(w).requires_grad_(True)
    tloss(f, wt).backward()
    close(f.grad, want_f, GRAD_TOL)
    close(wt.grad, want_w, GRAD_TOL)
    assert float(np.abs(want_w).max()) > 0


@pytest.mark.parametrize("seed,shape,z_slab,n,cap,sort,unit_cap", [
    (1, (9, 9, 4), 2, 50, 64, True, None),
    (0, (14, 12, 8), 4, 80, 100, False, None),
    (4, (6, 6, 16), 4, 200, 256, True, 90),
], ids=["sorted", "unsorted", "cap_overflow"])
def test_units_from_voxels_gradient_matches_jax(seed, shape, z_slab, n, cap, sort, unit_cap):
    """The hand-written JAX VJP is a gather; here it falls out of autograd
    through the fill's backward and the sort. Exact (copies); a voxel of a
    unit the cap dropped gets zero."""
    coords, valid = random_voxels(seed, shape, n, cap, sort=sort)
    rng = np.random.RandomState(seed)
    feats = rng.randn(cap, 5).astype(np.float32)
    ucap = unit_cap if unit_cap is not None else cap + cap // 4
    tgt = rng.randn(ucap, z_slab, 5).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jcs.units_from_voxels(
        f, jactive(coords, valid, shape), z_slab, sort, unit_cap)[1] * tgt))(jnp.asarray(feats))
    f = t(feats).requires_grad_(True)
    _, uf = tcs.units_from_voxels(f, tactive(coords, valid, shape), z_slab, sort, unit_cap)
    (uf * t(tgt)).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(want))
    assert (f.grad.numpy()[~valid] == 0).all()
    if unit_cap is not None:
        assert (np.abs(f.grad.numpy()[valid]).sum(-1) == 0).any()


@pytest.mark.cuda
def test_stencil_backward_kernels_on_card_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    shape, z_slab, ncs = (12, 10, 8), 4, 2
    _, jf, tcols = unit_batch((70, 71), shape, z_slab, 50, 80)
    w = t((np.random.RandomState(1).randn(27, 3, 5) * 0.3).astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        cols = tcs.ColumnSet(tcols.col_ids.to(dev), tcols.valid.to(dev), tcols.mask.to(dev),
                             tcols.bev_shape, tcols.nz)
        f = t(jf).to(dev).requires_grad_(True)
        wt = w.to(dev).requires_grad_(True)
        torch.sin(tcs.subm_conv_units_batched(f, cols, wt, ncs)).sum().backward()
        grads.append((f.grad.cpu(), wt.grad.cpu()))
    close(grads[0][0], grads[1][0].numpy(), GRAD_TOL)
    close(grads[0][1], grads[1][1].numpy(), GRAD_TOL)
    # Forward, d_src and d_wc at the edge shapes (ragged tiles, tiles without a
    # hit, all nine offsets hit, one hit, an empty sample, 65 to 256 columns,
    # one and two chunks, dense weights), bfloat16 and float32.
    import chip_smoke

    assert chip_smoke.stencil_edge_checks(torch.device("cuda")) <= 1.0
