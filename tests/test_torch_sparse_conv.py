"""Port parity for the per-voxel sparse conv ops and the rank gather
contraction: ``build_hash``, ``subm_neighbors``, ``downsample_coords``,
``sparse_conv3d_gather``, ``gather_by_rank`` and ``subm_conv`` (the plain
version of the CUDA kernel ``csrc/subm_conv.cu``), each against the JAX
function on the same numpy inputs.

Tolerances: index outputs (sorted ids, permutations, ranks, coords,
validity) exact; gathered rows exact (copies); contractions 1e-5 of the
output scale (float32 sums of 27·C products in another order). The Pallas
kernel runs in interpret mode, as in ``tests/test_subm_conv_kernel.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import sparse_conv as jsp
from lyft3d_tpu.ops.subm_conv_kernel import subm_conv_pallas
from lyft3d_tpu_torch.ops import sparse_conv as tsp
from lyft3d_tpu_torch.ops import subm_conv_kernel as tk

TOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def random_set(seed, shape, n, cap):
    """Unique coords in random order, padded to ``cap`` with invalid rows."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    flat = rng.choice(nx * ny * nz, n, replace=False)
    coords = np.zeros((cap, 3), np.int32)
    coords[:n] = np.stack([flat % nx, (flat // nx) % ny, flat // (nx * ny)], -1)
    return coords, np.arange(cap) < n


def both(coords, valid, shape):
    return (jsp.ActiveSet(jnp.asarray(coords), jnp.asarray(valid), shape),
            tsp.ActiveSet(t(coords), t(valid), shape))


def close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("seed,shape,n,cap", [(0, (8, 8, 4), 50, 64), (1, (6, 9, 5), 120, 120),
                                              (2, (16, 16, 8), 200, 256)])
def test_hash_and_neighbors_equal(seed, shape, n, cap):
    ja, ta = both(*random_set(seed, shape, n, cap), shape)
    jh, th = jsp.build_hash(ja), tsp.build_hash(ta)
    np.testing.assert_array_equal(th[0].numpy(), np.asarray(jh[0]))
    np.testing.assert_array_equal(th[1].numpy()[:n], np.asarray(jh[1])[:n])  # valid ids are unique
    assert th[2] == int(jh[2])
    np.testing.assert_array_equal(tsp.kernel_offsets(3).numpy(), np.asarray(jsp.kernel_offsets(3)))
    want = jsp.subm_neighbors(ja, jh, jsp.kernel_offsets(3))
    got = tsp.subm_neighbors(ta, th, tsp.kernel_offsets(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want)[13, :n] >= 0).all()  # the centre tap finds itself
    assert 0 < (np.asarray(want) >= 0).mean() < 1


@pytest.mark.parametrize("seed,shape,n,cap,max_out", [
    (3, (8, 8, 4), 50, 64, 512), (4, (9, 7, 5), 90, 96, 32), (5, (4, 4, 2), 6, 8, 64)],
    ids=["fits", "cap_cuts", "fewer_candidates_than_slots"])
def test_downsample_coords_and_strided_gather_equal(seed, shape, n, cap, max_out):
    coords, valid = random_set(seed, shape, n, cap)
    ja, ta = both(coords, valid, shape)
    jo, to = jsp.downsample_coords(ja, max_out), tsp.downsample_coords(ta, max_out)
    assert to.spatial_shape == jo.spatial_shape
    np.testing.assert_array_equal(to.coords.numpy(), np.asarray(jo.coords))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    feats = np.random.RandomState(seed).randn(cap, 5).astype(np.float32)
    want = jsp.sparse_conv3d_gather(jnp.asarray(feats), ja, jo)
    got = tsp.sparse_conv3d_gather(t(feats), ta, to)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).sum() > 0


def test_batched_equals_per_sample():
    shape = (8, 8, 4)
    sets = [random_set(s, shape, 40 + s, 64) for s in (6, 7)]
    coords, valid = (np.stack(a) for a in zip(*sets))
    feats = np.random.RandomState(6).randn(2, 64, 4).astype(np.float32)
    ta = tsp.ActiveSet(t(coords), t(valid), shape)
    th = tsp.build_hash(ta)
    ranks = tsp.subm_neighbors(ta, th, tsp.kernel_offsets(3))
    rows = tsp.gather_by_rank(t(feats), th[1], ranks)
    out = tsp.downsample_coords(ta, 48)
    for b in range(2):
        one = tsp.ActiveSet(t(coords[b]), t(valid[b]), shape)
        oh = tsp.build_hash(one)
        assert torch.equal(ranks[b], tsp.subm_neighbors(one, oh, tsp.kernel_offsets(3)))
        assert torch.equal(rows[b], tsp.gather_by_rank(t(feats[b]), oh[1], ranks[b]))
        assert torch.equal(out.coords[b], tsp.downsample_coords(one, 48).coords)


@pytest.mark.parametrize("c,cout,tile", [(8, 16, 16), (3, 16, 64), (16, 5, 16)])
def test_subm_conv_ref_matches_pallas_interpret_and_gather_einsum(c, cout, tile):
    shape = (8, 8, 4)
    coords, valid = random_set(8, shape, 50, 64)
    ja, ta = both(coords, valid, shape)
    rng = np.random.RandomState(c)
    feats = (rng.randn(64, c) * valid[:, None]).astype(np.float32)
    w = rng.randn(27, c, cout).astype(np.float32)
    jh, th = jsp.build_hash(ja), tsp.build_hash(ta)
    jranks = jsp.subm_neighbors(ja, jh, jsp.kernel_offsets(3))
    tranks = tsp.subm_neighbors(ta, th, tsp.kernel_offsets(3))
    pallas = subm_conv_pallas(jnp.asarray(feats)[jh[1]], jranks, jnp.asarray(w), tile=tile,
                              interpret=True)
    einsum = jnp.einsum("kvc,kcd->vd", jsp.gather_by_rank(jnp.asarray(feats), jh[1], jranks),
                        jnp.asarray(w))
    f_sorted = t(feats)[th[1]]
    got = tk.subm_conv_ref(f_sorted, tranks, t(w))
    close(got, pallas)
    close(got, einsum)
    before = tk.KERNEL_LAUNCHES
    assert torch.equal(tk.subm_conv(f_sorted, tranks, t(w)), got)  # a CPU tensor takes the plain version
    assert tk.KERNEL_LAUNCHES == before
    both2 = tk.subm_conv(torch.stack([f_sorted, f_sorted * 2]), torch.stack([tranks, tranks]), t(w))
    close(both2[0], got.numpy(), 1e-6)
    close(both2[1], 2 * got.numpy(), 1e-6)


def test_subm_conv_absent_rows_and_argument_checks():
    w = torch.randn(27, 4, 6, generator=torch.Generator().manual_seed(0))
    f = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    out = tk.subm_conv(f, torch.full((27, 8), -1, dtype=torch.int32), w)
    assert out.shape == (8, 6) and not out.any()
    # Different numbers of queries and source rows (the strided conv's shape).
    ranks = torch.randint(-1, 8, (27, 5), generator=torch.Generator().manual_seed(2))
    assert tk.subm_conv(f, ranks, w).shape == (5, 6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.subm_conv(f.double(), ranks, w)
    with pytest.raises(ValueError, match="do not fit"):
        tk.subm_conv(f, ranks, w[:, :3])
    with pytest.raises(ValueError, match="meta"):
        tk.subm_conv(f.to("meta"), ranks.to("meta"), w.to("meta"))


def test_subm_conv_cuda_path_has_no_fallback(monkeypatch):
    from lyft3d_tpu_torch import _build

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "load_library", broken)
    monkeypatch.setattr(tk, "subm_conv_ref", lambda *a: pytest.fail("fell back to the plain version"))
    with pytest.raises(RuntimeError, match="cannot build subm_conv"):
        tk._subm_conv_cuda(torch.zeros(4, 3), torch.zeros(27, 4, dtype=torch.int32),
                           torch.zeros(27, 3, 2))


@pytest.mark.cuda
def test_subm_conv_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    g = torch.Generator().manual_seed(0)
    f = torch.randn(2, 5000, 16, generator=g).cuda()
    ranks = torch.randint(-1, 5000, (2, 27, 5000), generator=g).int().cuda()
    w = torch.randn(27, 16, 32, generator=g).cuda()
    got = tk.subm_conv(f, ranks, w)
    torch.cuda.synchronize()
    want = tk.subm_conv_ref(f, ranks, w)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


# ------------------------------------------------------------------ gradients


def _subm_grad_case(c=4, cout=4):
    shape = (8, 8, 4)
    coords, valid = random_set(9, shape, 30, 40)
    ja, ta = both(coords, valid, shape)
    rng = np.random.RandomState(9)
    feats = (rng.randn(40, c) * valid[:, None]).astype(np.float32)
    w = rng.randn(27, c, cout).astype(np.float32)
    jh, th = jsp.build_hash(ja), tsp.build_hash(ta)
    jranks = jsp.subm_neighbors(ja, jh, jsp.kernel_offsets(3))
    tranks = tsp.subm_neighbors(ta, th, tsp.kernel_offsets(3))
    return feats, w, jh, th, jranks, tranks


def test_subm_conv_gradients_match_jax_custom_vjp():
    """df and dW of ``subm_conv`` against jax.grad through the interpret-mode
    Pallas kernel's custom VJP (invalid rows, −1 ranks). 1e-5 of scale."""
    import jax

    feats, w, jh, th, jranks, tranks = _subm_grad_case()
    want_f, want_w = jax.grad(
        lambda f, ww: jnp.sum(subm_conv_pallas(f, jranks, ww, tile=16, interpret=True) ** 2),
        argnums=(0, 1))(jnp.asarray(feats)[jh[1]], jnp.asarray(w))
    f = t(feats)[th[1]].clone().requires_grad_(True)
    wt = t(w).requires_grad_(True)
    (tk.subm_conv(f, tranks, wt) ** 2).sum().backward()
    close(f.grad, want_f)
    close(wt.grad, want_w)
    assert (np.asarray(jranks) < 0).any() and float(np.abs(want_f).max()) > 0


def test_subm_conv_gradient_generic_ranks_and_bwd_ref():
    """Any rank table (repeats, Q != V): the Function's CPU backward is the
    plain backward, a scatter-add in df."""
    g = torch.Generator().manual_seed(3)
    f = torch.randn(2, 12, 3, generator=g)
    w = torch.randn(27, 3, 5, generator=g)
    ranks = torch.randint(-1, 12, (2, 27, 7), generator=g).int()
    go = torch.randn(2, 7, 5, generator=g)
    df, dw = tk.subm_conv_bwd_ref(f, ranks, w, go)
    want_f = np.zeros((2, 12, 3))
    want_w = np.zeros((27, 3, 5))
    for b in range(2):
        for k in range(27):
            for q in range(7):
                r = int(ranks[b, k, q])
                if r >= 0:
                    want_f[b, r] += go[b, q].numpy() @ w[k].numpy().T
                    want_w[k] += np.outer(f[b, r].numpy(), go[b, q].numpy())
    close(df, want_f)
    close(dw, want_w)
    fr, wr = f.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tk.subm_conv(fr, ranks, wr).backward(go)
    assert torch.equal(fr.grad, df) and torch.equal(wr.grad, dw)


def test_sparse_index_ops_are_differentiable_in_the_features():
    """``take_rows``, ``gather_by_rank`` and ``sparse_conv3d_gather`` against
    jax.grad: exact (sums of copies of cotangent rows, each voxel read at
    most once per offset)."""
    import jax

    shape = (8, 8, 4)
    coords, valid = random_set(3, shape, 50, 64)
    ja, ta = both(coords, valid, shape)
    jo, to = jsp.downsample_coords(ja, 512), tsp.downsample_coords(ta, 512)
    rng = np.random.RandomState(3)
    feats = rng.randn(64, 5).astype(np.float32)
    tgt = rng.randint(-3, 4, (27, 512, 5)).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jsp.sparse_conv3d_gather(f, ja, jo) * tgt))(jnp.asarray(feats))
    f = t(feats).requires_grad_(True)
    (tsp.sparse_conv3d_gather(f, ta, to) * t(tgt)).sum().backward()
    close(f.grad, want, 1e-6)
    jh, th = jsp.build_hash(ja), tsp.build_hash(ta)
    jr = jsp.subm_neighbors(ja, jh, jsp.kernel_offsets(3))
    tr = tsp.subm_neighbors(ta, th, tsp.kernel_offsets(3))
    tgt2 = rng.randint(-3, 4, (27, 64, 5)).astype(np.float32)
    want2 = jax.grad(lambda f: jnp.sum(jsp.gather_by_rank(f, jh[1], jr) * tgt2))(jnp.asarray(feats))
    f2 = t(feats).requires_grad_(True)
    (tsp.gather_by_rank(f2, th[1], tr) * t(tgt2)).sum().backward()
    close(f2.grad, want2, 1e-6)


def test_subm_conv_backward_cuda_path_has_no_fallback(monkeypatch):
    from lyft3d_tpu_torch import _build

    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "load_library", broken)
    monkeypatch.setattr(tk, "subm_conv_bwd_ref", lambda *a: pytest.fail("fell back to the plain version"))
    with pytest.raises(RuntimeError, match="cannot build subm_conv"):
        tk._subm_conv_bwd_cuda(torch.zeros(4, 3), torch.zeros(27, 4, dtype=torch.int32),
                               torch.zeros(27, 3, 2), torch.zeros(4, 2), True, True)


@pytest.mark.cuda
def test_subm_conv_backward_kernels_on_card_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    g = torch.Generator().manual_seed(0)
    f = torch.randn(2, 3000, 16, generator=g).cuda()
    ranks = torch.randint(-1, 3000, (2, 27, 3000), generator=g).int().cuda()
    w = torch.randn(27, 16, 32, generator=g).cuda()
    go = torch.randn(2, 3000, 32, generator=g).cuda()
    df, dw = tk._subm_conv_bwd_cuda(f, ranks, w, go, True, True)
    want_f, want_w = tk.subm_conv_bwd_ref(f, ranks, w, go)
    assert float((df - want_f).abs().max()) <= TOL * float(want_f.abs().max())
    assert float((dw - want_w).abs().max()) <= TOL * float(want_w.abs().max())
    # df and dW at 3 to 96 channels with an empty sample and zero cotangent
    # rows, bfloat16 (tensor cores, flagged rows skipped) and float32.
    import chip_smoke

    assert chip_smoke.subm_edge_checks(torch.device("cuda")) <= 1.0
