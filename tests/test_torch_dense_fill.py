"""Port parity: ``lyft3d_tpu_torch.ops.dense_fill`` against the JAX fill.

The plain version (the CPU path of ``fill_rows_by_id``) is held to the JAX
sorted-hint scatter (``fill_rows_by_id(method="scatter")``) and to the
interpret-mode Pallas kernel ``fill_rows_by_id_pallas`` on the same numpy
inputs. A canvas row is a copy of at most one feature row under the
producer contract (unique ids), so those checks are exact. Duplicate ids
sum, as the Pallas kernel's one-hot matmul does (integer-valued features:
exact; random float32: within 1e-6 of a float64 sum). The CUDA kernel is
held to the plain version on a card (``cuda`` marker) and in
``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import dense_fill as jfill
from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops import dense_fill

ROWS, V, C = 1000, 300, 8


def unique_ids(rng, sort, tail_invalid):
    """Row ids (unique), features and a valid mask; with ``tail_invalid``
    the invalid entries trail the ascending valid ids (the voxelize
    contract), else they are scattered."""
    ids = rng.choice(ROWS, V, replace=False).astype(np.int32)
    if sort:
        ids = np.sort(ids)
    feats = rng.randn(V, C).astype(np.float32)
    if tail_invalid:
        valid = np.arange(V) < int(V * 0.9)
    else:
        valid = rng.rand(V) < 0.85
    return ids, feats, valid


def port(feats, ids, valid, rows=ROWS, **kw):
    return dense_fill.fill_rows_by_id(
        torch.from_numpy(feats), torch.from_numpy(ids), torch.from_numpy(valid), rows, **kw
    ).numpy()


@pytest.mark.parametrize("assume_sorted", [True, False])
def test_matches_jax_scatter_on_unique_ids(assume_sorted):
    rng = np.random.RandomState(0)
    ids, feats, valid = unique_ids(rng, sort=assume_sorted, tail_invalid=assume_sorted)
    want = np.asarray(jfill.fill_rows_by_id(
        jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), ROWS,
        assume_sorted=assume_sorted, method="scatter"))
    np.testing.assert_array_equal(port(feats, ids, valid, assume_sorted=assume_sorted), want)


@pytest.mark.parametrize("rows,tile", [(1000, 256), (1024, 256)])
def test_matches_interpret_pallas(rows, tile):
    rng = np.random.RandomState(1)
    ids = np.sort(rng.choice(rows, V, replace=False)).astype(np.int32)
    feats = rng.randint(-50, 50, (V, C)).astype(np.float32)
    valid = rng.rand(V) < 0.9
    want = np.asarray(jfill.fill_rows_by_id_pallas(
        jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), rows, tile=tile, interpret=True))
    np.testing.assert_array_equal(port(feats, ids, valid, rows=rows), want)


def test_duplicate_ids_sum_like_pallas():
    # 100 ids over 256 rows, many repeated; the Pallas kernel sums a row's
    # duplicates as long as a tile's ids fit in its window of ``tile``.
    rng = np.random.RandomState(2)
    ids = np.sort(rng.randint(0, 256, 100)).astype(np.int32)
    assert len(np.unique(ids)) < 90
    feats = rng.randint(-50, 50, (100, C)).astype(np.float32)
    valid = np.ones(100, bool)
    want = np.asarray(jfill.fill_rows_by_id_pallas(
        jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), 256, tile=128, interpret=True))
    got = port(feats, ids, valid, rows=256, assume_sorted=True)
    np.testing.assert_array_equal(got, want)
    ref = np.zeros((256, C))
    np.add.at(ref, ids, feats.astype(np.float64))
    np.testing.assert_array_equal(got, ref)


def test_duplicate_ids_sum_random_float32():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 100, V).astype(np.int32)  # unsorted, repeated
    feats = rng.randn(V, C).astype(np.float32)
    valid = rng.rand(V) < 0.9
    ref = np.zeros((100, C))
    np.add.at(ref, ids[valid], feats[valid].astype(np.float64))
    np.testing.assert_allclose(port(feats, ids, valid, rows=100), ref, rtol=1e-6, atol=1e-6)


def test_batched_equals_per_sample_and_bf16_copies_exactly():
    rng = np.random.RandomState(4)
    cases = [unique_ids(rng, sort=True, tail_invalid=True) for _ in range(3)]
    ids = torch.from_numpy(np.stack([c[0] for c in cases]))
    feats = torch.from_numpy(np.stack([c[1] for c in cases])).to(torch.bfloat16)
    valid = torch.from_numpy(np.stack([c[2] for c in cases]))
    got = dense_fill.fill_rows_by_id(feats, ids, valid, ROWS, assume_sorted=True)
    assert got.shape == (3, ROWS, C) and got.dtype == torch.bfloat16
    for b in range(3):
        one = dense_fill.fill_rows_by_id(feats[b], ids[b], valid[b], ROWS, assume_sorted=True)
        assert torch.equal(got[b], one)
        keep = valid[b]
        assert torch.equal(got[b][ids[b][keep].long()], feats[b][keep])
    assert int((got != 0).any(-1).sum()) <= int(valid.sum())


def test_invalid_and_out_of_range_ids_drop():
    feats = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    ids = torch.tensor([-1, 2, 7, 8], dtype=torch.int32)  # 8 == num_rows
    valid = torch.tensor([True, True, False, True])
    out = dense_fill.fill_rows_by_id(feats, ids, valid, 8)
    assert out[:, 0].tolist() == [0, 0, 2.0, 0, 0, 0, 0, 0]


def test_dispatch_by_device_type(monkeypatch):
    feats, ids = torch.ones(4, 2), torch.arange(4, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    calls = []
    plain = dense_fill.fill_rows_by_id_scatter
    monkeypatch.setattr(dense_fill, "fill_rows_by_id_scatter",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = dense_fill.KERNEL_LAUNCHES
    assert dense_fill.fill_rows_by_id(feats, ids, valid, 6).shape == (6, 2)
    assert calls == [1] and dense_fill.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="meta"):
        dense_fill.fill_rows_by_id(feats.to("meta"), ids.to("meta"), valid.to("meta"), 6)
    assert calls == [1]


def test_cuda_path_propagates_loader_errors(monkeypatch):
    """The CUDA launch path, with the kernel loader failing, raises and
    returns no plain result."""
    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    monkeypatch.setattr(dense_fill, "fill_rows_by_id_scatter", plain_must_not_run)
    before = dense_fill.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="cannot build dense_fill"):
        dense_fill._fill_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 8, dtype=torch.int32), 16)
    assert dense_fill.KERNEL_LAUNCHES == before


def test_rejects_bad_arguments():
    ids = torch.zeros(4, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dense_fill.fill_rows_by_id(torch.zeros(4, 2, dtype=torch.float64), ids, valid, 8)
    with pytest.raises(ValueError, match="must be"):
        dense_fill.fill_rows_by_id(torch.zeros(4, 2), ids[:3], valid, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_card_matches_plain(dtype):
    """On a machine with a card: the CUDA kernel equals the plain version on
    ascending unique ids with invalid entries at the tail, and sums
    duplicates within float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    g = torch.Generator().manual_seed(0)
    rows, v = 20000, 3000
    ids = torch.stack([torch.sort(torch.randperm(rows, generator=g)[:v]).values for _ in range(2)])
    valid = torch.arange(v) < 2700
    feats = torch.randn(2, v, 64, generator=g).to(dtype)
    args = (feats.cuda(), ids.int().cuda(), valid.expand(2, v).cuda(), rows)
    before = dense_fill.KERNEL_LAUNCHES
    got = dense_fill.fill_rows_by_id(*args, assume_sorted=True)
    torch.cuda.synchronize()
    assert dense_fill.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, dense_fill.fill_rows_by_id_scatter(*args))
    dup = torch.sort(torch.randint(0, 500, (2, v), generator=g), dim=-1).values.int()
    got = dense_fill.fill_rows_by_id(feats.float().cuda(), dup.cuda(),
                                     torch.ones(2, v, dtype=torch.bool, device="cuda"), 500,
                                     assume_sorted=True)
    ref = dense_fill.fill_rows_by_id_scatter(feats.double(), dup, torch.ones(2, v, dtype=torch.bool), 500)
    torch.testing.assert_close(got.cpu().double(), ref, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ gradient
#
# The gradient is a gather of cotangent rows: exact against jax.grad through
# the interpret-mode Pallas kernel's custom VJP and through the scatter.


def _grad_case(seed, sort, batched):
    rng = np.random.RandomState(seed)
    shape = (2,) if batched else ()
    ids = np.stack([rng.choice(ROWS, V, replace=False) for _ in range(2 if batched else 1)]).astype(np.int32)
    if sort:
        ids = np.sort(ids, -1)
    ids = ids.reshape(*shape, V)
    feats = rng.randn(*shape, V, C).astype(np.float32)
    valid = (np.arange(V) < int(V * 0.9)) if sort else (rng.rand(V) < 0.85)
    valid = np.broadcast_to(valid, ids.shape).copy()
    tgt = rng.randn(*shape, ROWS, C).astype(np.float32)
    return ids, feats, valid, tgt


@pytest.mark.parametrize("sort,batched,jmethod", [
    (True, False, "pallas"), (True, False, "scatter"), (False, False, "scatter"),
    (True, True, "scatter"), (False, True, "scatter"),
], ids=["sorted-pallas_interpret", "sorted-scatter", "unsorted-scatter", "batched-sorted",
        "batched-unsorted"])
def test_gradient_matches_jax(sort, batched, jmethod):
    import jax

    ids, feats, valid, tgt = _grad_case(11, sort, batched)

    def jfill_one(f, i, v):
        if jmethod == "pallas":
            return jfill.fill_rows_by_id_pallas(f, i, v, ROWS, tile=256, interpret=True)
        return jfill.fill_rows_by_id(f, i, v, ROWS, assume_sorted=sort, method="scatter")

    def jloss(f):
        fn = jax.vmap(jfill_one) if batched else jfill_one
        return jnp.sum(fn(f, jnp.asarray(ids), jnp.asarray(valid)) * tgt)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    f = torch.from_numpy(feats).requires_grad_(True)
    out = dense_fill.fill_rows_by_id(f, torch.from_numpy(ids), torch.from_numpy(valid), ROWS,
                                     assume_sorted=sort)
    (out * torch.from_numpy(tgt)).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy(), want)
    assert (f.grad.numpy()[~valid] == 0).all() and np.abs(f.grad.numpy()[valid]).min() > 0


def test_gradient_duplicate_ids_each_receive_the_row():
    rng = np.random.RandomState(5)
    ids = np.sort(rng.randint(0, 50, V)).astype(np.int32)
    assert len(np.unique(ids)) < V
    valid = rng.rand(V) < 0.9
    g = rng.randn(50, C).astype(np.float32)
    f = torch.zeros(V, C, requires_grad=True)
    dense_fill.fill_rows_by_id(f, torch.from_numpy(ids), torch.from_numpy(valid), 50,
                               assume_sorted=False).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(f.grad.numpy(), g[ids] * valid[:, None])
    np.testing.assert_array_equal(
        dense_fill.fill_rows_by_id_bwd_ref(torch.from_numpy(g), torch.from_numpy(np.where(valid, ids, 50)), 50).numpy(),
        g[ids] * valid[:, None])


def test_backward_cuda_path_has_no_fallback(monkeypatch):
    def broken(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "load_library", broken)
    monkeypatch.setattr(dense_fill, "fill_rows_by_id_bwd_ref",
                        lambda *a: pytest.fail("fell back to the plain version"))
    with pytest.raises(RuntimeError, match="cannot build dense_fill"):
        dense_fill._fill_bwd_cuda(torch.zeros(6, 4), torch.zeros(3, dtype=torch.int32), 6)


@pytest.mark.cuda
def test_backward_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    rng = np.random.RandomState(0)
    for c, dtype in ((8, torch.float32), (5, torch.float32), (64, torch.bfloat16)):
        ids = torch.from_numpy(np.sort(rng.randint(0, ROWS + 1, (2, V)), -1).astype(np.int32)).cuda()
        g = torch.from_numpy(rng.randn(2, ROWS, c).astype(np.float32)).to(dtype).cuda()
        got = dense_fill._fill_bwd_cuda(g, ids, ROWS)
        assert torch.equal(got, dense_fill.fill_rows_by_id_bwd_ref(g, ids, ROWS))
