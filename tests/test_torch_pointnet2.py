"""Port parity: ``lyft3d_tpu_torch.ops.pointnet2`` against the JAX package's
PointNet++ ops, on the same numpy inputs.

The plain versions (the CPU path of the four kernel wrappers) are held to the
jnp formulations of ``lyft3d_tpu.ops.pointnet2`` and to the Pallas kernels in
interpret mode (``fps_pallas``, ``lyft3d_tpu.ops.select_kernel``). Indices and
counts must be equal; the clouds are checked to hold no distance within 1e-6
(relative) of a squared radius and no point within 1e-4 m of a box face, so
that the last bit of a product cannot decide a comparison. The CUDA kernels
are held to the plain versions on a card (``cuda`` marker) and in
``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import pointnet2 as jp2
from lyft3d_tpu.ops import select_kernel as jsel
from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops import pointnet2 as p2

B, N = 3, 300


def make_cloud(seed, b=B, n=N, frac_valid=0.9, duplicates=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-8, 8, (b, n, 3)).astype(np.float32)
    if duplicates:  # exact copies of earlier points: tied distances
        src = rng.randint(0, n // 2, (b, duplicates))
        dst = rng.randint(n // 2, n, (b, duplicates))
        for i in range(b):
            pts[i, dst[i]] = pts[i, src[i]]
    valid = rng.rand(b, n) < frac_valid
    return pts, valid


def t(x):
    return torch.from_numpy(np.array(x))


def per_sample(fn, *arrays):
    """Run an unbatched JAX function over the leading axis; stack each output."""
    outs = [fn(*[jnp.asarray(a[i]) for a in arrays]) for i in range(arrays[0].shape[0])]
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


# ------------------------------------------------------------------------ FPS


@pytest.mark.parametrize("case", ["invalid_points", "few_valid", "all_valid", "first_invalid"])
def test_fps_equals_jax(case):
    pts, valid = make_cloud(0)
    npoint = 64
    if case == "few_valid":  # fewer valid points than npoint: picks repeat
        valid = np.zeros_like(valid)
        valid[:, [5, 17, 40, 41, 200]] = True
        npoint = 12
    elif case == "all_valid":
        valid = np.ones_like(valid)
    elif case == "first_invalid":
        valid[:, :7] = False
    got = p2.fps(t(pts), t(valid), npoint)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    want = per_sample(lambda p, v: jp2.furthest_point_sample(p, v, npoint), pts, valid)
    assert torch.equal(got, t(want))
    kern = per_sample(lambda p, v: jp2.fps_pallas(p, v, npoint, interpret=True), pts, valid)
    assert torch.equal(got, t(kern))
    picked_valid = np.take_along_axis(valid, got.numpy().astype(np.int64), axis=1)
    assert picked_valid.all()


def test_fps_batched_equals_per_sample():
    pts, valid = make_cloud(1, b=4)
    got = p2.fps(t(pts), t(valid), 32)
    for i in range(4):
        assert torch.equal(got[i:i + 1], p2.fps(t(pts[i:i + 1]), t(valid[i:i + 1]), 32))


@pytest.mark.parametrize("batch,n,shape", [
    # Many clouds (the RCNN's 400 RoI clouds): one block a cloud fills the card.
    (400, 16384, (1, 1024, 16)), (400, 4096, (1, 512, 8)), (400, 1024, (1, 128, 8)),
    (400, 512, (1, 64, 8)), (400, 256, (1, 32, 8)), (400, 128, (1, 32, 4)),
    (400, 300, (1, 64, 8)), (400, 65536, (1, 1024, 64)), (400, 1, (1, 32, 1)),
    # Few clouds of more than 4,096 points: a cluster of 16 CTAs a cloud.
    (4, 16384, (16, 256, 4)), (4, 8192, (16, 256, 2)), (2, 4097, (16, 256, 2)),
    (1, 65536, (16, 256, 16)), (40, 16384, (16, 256, 4)), (131, 4100, (16, 256, 2)),
    # Few small clouds, and many clouds: one block a cloud.
    (4, 4096, (1, 512, 8)), (4, 1024, (1, 128, 8)), (4, 256, (1, 32, 8)), (1, 1, (1, 32, 1)),
    (132, 16384, (1, 1024, 16)),
])
def test_fps_launch_shape_covers_the_cloud(batch, n, shape):
    ctas, threads, slots = p2._fps_launch_shape(batch, n)
    assert (ctas, threads, slots) == shape
    assert ctas * threads * slots >= n and threads % 32 == 0 and slots & (slots - 1) == 0
    assert ctas in (1, 16)
    if batch >= p2.FPS_SMS or n <= 4096:
        assert ctas == 1  # many clouds, and small ones, keep the one-block kernel
    if ctas > 1:
        assert threads == p2.FPS_CLUSTER_THREADS and slots <= 32 and ctas * threads * slots < 2 * n


# ----------------------------------------------------------------- ball query


def assert_clear_of_radii(centers, pts, radii):
    d2 = ((centers[:, :, None, :].astype(np.float64) - pts[:, None, :, :]) ** 2).sum(-1)
    for r in radii:
        assert np.abs(d2 / (r * r) - 1.0).min() > 1e-6


@pytest.mark.parametrize("radii,ks", [((2.0,), (8,)), ((4.0,), (16,)), ((2.0, 4.0), (8, 16)),
                                      ((0.7, 1.3, 3.0), (4, 6, 8))])
def test_ball_query_equals_jax(radii, ks):
    pts, valid = make_cloud(2)
    centers = pts[:, :40].copy()
    centers[:, -1] = 500.0  # a far-away centre: an empty row
    assert_clear_of_radii(centers, pts, radii)
    got = p2.multi_radius_ball_query(t(centers), t(pts), t(valid), radii, ks)
    fused = per_sample(lambda c, p, v: jsel.multi_radius_ball_query_fused(
        c, p, v, radii, ks, interpret=True), centers, pts, valid)
    plain = per_sample(lambda c, p, v: jp2.multi_radius_ball_query(c, p, v, radii, ks),
                       centers, pts, valid)
    assert len(got) == len(radii)
    for (idx, cnt), (f_idx, f_cnt), (j_idx, j_cnt), k in zip(got, fused, plain, ks):
        assert idx.dtype == torch.int32 and idx.shape == (B, 40, k) and cnt.shape == (B, 40)
        assert torch.equal(idx, t(f_idx)) and torch.equal(cnt, t(f_cnt).to(torch.int32))
        assert torch.equal(idx, t(j_idx)) and torch.equal(cnt, t(j_cnt).to(torch.int32))
        assert int(cnt[:, -1].max()) == 0 and int(idx[:, -1].abs().max()) == 0
    # rows with more than k hits, and rows with fewer, both occur
    cnt = got[-1][1][:, :-1]
    assert int((cnt == ks[-1]).sum()) > 0 and int((cnt < ks[-1]).sum()) > 0
    if len(radii) == 1:
        one = p2.ball_query(t(centers), t(pts), t(valid), radii[0], ks[0])
        assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[0][1])


def test_ball_query_more_samples_than_points():
    pts, valid = make_cloud(3, b=1, n=6, frac_valid=1.0)
    idx, cnt = p2.ball_query(t(pts[:, :2]), t(pts), t(valid), 100.0, 9)
    assert cnt.tolist() == [[6, 6]]
    assert idx[0, 0].tolist() == [0, 1, 2, 3, 4, 5, 0, 0, 0]


def test_squared_radius_is_rounded_once():
    # 0.1 * 0.1 in double, then to float32: not float32(0.1) squared.
    assert p2._squared_radii([0.1])[0] == float(np.float32(0.1 * 0.1))
    assert p2._squared_radii([0.1])[0] != float(np.float32(0.1) * np.float32(0.1))


def test_group_points_gathers_per_sample():
    feats = np.random.RandomState(4).randn(B, N, 5).astype(np.float32)
    idx = np.random.RandomState(5).randint(0, N, (B, 7, 4)).astype(np.int32)
    got = p2.group_points(t(feats), t(idx))
    want = per_sample(jp2.group_points, feats, idx)
    assert torch.equal(got, t(want))


# ----------------------------------------------------------------------- 3-NN


@pytest.mark.parametrize("duplicates", [0, 40])
def test_three_nn_equals_jax(duplicates):
    pts, valid = make_cloud(6, duplicates=duplicates)
    unknown = np.random.RandomState(7).uniform(-8, 8, (B, 50, 3)).astype(np.float32)
    if duplicates:  # queries on known points: distance 0, and tied neighbours
        unknown[:, :20] = pts[:, :20]
    dists, idx = p2.three_nn(t(unknown), t(pts), t(valid))
    assert idx.dtype == torch.int32 and idx.shape == (B, 50, 3) and dists.dtype == torch.float32
    f_d, f_idx = per_sample(lambda u, k, v: jsel.knn_fused(u, k, v, 3, interpret=True),
                            unknown, pts, valid)
    j_d, j_idx = per_sample(jp2.three_nn, unknown, pts, valid)
    assert torch.equal(idx, t(f_idx))
    np.testing.assert_allclose(dists.numpy(), f_d, rtol=1e-6, atol=1e-6)
    assert torch.equal(idx, t(j_idx))
    np.testing.assert_allclose(dists.numpy(), j_d, rtol=1e-6, atol=1e-6)
    feats = np.random.RandomState(8).randn(B, N, 4).astype(np.float32)
    got = p2.three_interpolate(t(feats), idx, dists)
    want = per_sample(jp2.three_interpolate, feats, f_idx, f_d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_three_nn_fewer_than_three_valid():
    """Open slots are misses (index M − 1, distance 1e5), the contract of
    ``knn_fused``; the jnp ``three_nn`` agrees on the filled slots."""
    pts, _ = make_cloud(9)
    valid = np.zeros((B, N), bool)
    valid[:, [7, 191]] = True
    valid[2] = False  # no valid known point at all
    unknown = pts[:, :20]
    dists, idx = p2.three_nn(t(unknown), t(pts), t(valid))
    f_d, f_idx = per_sample(lambda u, k, v: jsel.knn_fused(u, k, v, 3, interpret=True),
                            unknown, pts, valid)
    assert torch.equal(idx, t(f_idx))
    np.testing.assert_allclose(dists.numpy(), f_d, rtol=1e-6, atol=1e-6)
    assert torch.equal(idx[:2, :, 2], torch.full((2, 20), N - 1, dtype=torch.int32))
    assert bool((dists[:2, :, 2] == 1e5).all()) and bool((dists[2] == 1e5).all())
    _, j_idx = per_sample(jp2.three_nn, unknown[:2], pts[:2], valid[:2])
    assert torch.equal(idx[:2, :, :2], t(j_idx[..., :2]))
    feats = np.random.RandomState(3).randn(B, N, 4).astype(np.float32)
    got = p2.three_interpolate(t(feats[:2]), idx[:2], dists[:2])
    want = per_sample(jp2.three_interpolate, feats[:2], f_idx[:2], f_d[:2])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_three_nn_two_known_points():
    known = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    dists, idx = p2.three_nn(torch.tensor([[[0.25, 0.0, 0.0]]]), known,
                             torch.ones(1, 2, dtype=torch.bool))
    assert idx.tolist() == [[[0, 1, 1]]]
    assert dists.tolist() == [[[0.25, 0.75, 1e5]]]


# ------------------------------------------------------------------- RoI pool


def make_boxes(seed, r=6):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(-6, 6, (B, r, 3)), rng.uniform(2, 6, (B, r, 3)),
        rng.uniform(-np.pi, np.pi, (B, r, 1)),
    ], axis=-1).astype(np.float32)
    boxes[:, -1, :3] = 300.0  # an empty box
    return boxes


def assert_clear_of_faces(pts, boxes, extra):
    d = pts[:, None, :, :].astype(np.float64) - boxes[:, :, None, :3]
    c, s = np.cos(boxes[..., 6:7]), np.sin(boxes[..., 6:7])
    lx = c * d[..., 0] + s * d[..., 1]
    ly = -s * d[..., 0] + c * d[..., 1]
    for local, size in ((lx, boxes[..., 4:5]), (ly, boxes[..., 3:4]), (d[..., 2], boxes[..., 5:6])):
        assert np.abs(np.abs(local) - (size / 2 + extra)).min() > 1e-4


@pytest.mark.parametrize("k,extra", [(16, 0.5), (64, 1.0), (400, 0.0)])
def test_roi_select_and_pool_equal_jax(k, extra):
    pts, valid = make_cloud(10)
    boxes = make_boxes(12)
    assert_clear_of_faces(pts, boxes, extra)
    feats = np.random.RandomState(13).randn(B, N, 5).astype(np.float32)
    idx, cnt = p2.roi_inside_select(t(pts), t(valid), t(boxes), k, extra)
    assert idx.dtype == torch.int32 and idx.shape == (B, 6, k) and cnt.shape == (B, 6)
    f_idx, f_cnt = per_sample(lambda p, v, bx: jsel.roi_inside_select_fused(
        p, v, bx, num_sampled=k, extra_width=extra, interpret=True), pts, valid, boxes)
    assert torch.equal(idx, t(f_idx)) and torch.equal(cnt, t(f_cnt).to(torch.int32))
    pooled, count, empty = p2.roi_pool3d(t(pts), t(feats), t(valid), t(boxes), k, extra)
    j_pooled, j_count, j_empty = per_sample(lambda p, f, v, bx: jp2.roi_pool3d(
        p, f, v, bx, num_sampled=k, extra_width=extra), pts, feats, valid, boxes)
    assert torch.equal(count, t(j_count).to(torch.int32)) and torch.equal(empty, t(j_empty))
    np.testing.assert_allclose(pooled.numpy(), j_pooled, rtol=1e-6, atol=1e-6)
    assert bool(empty[:, -1].all()) and float(pooled[:, -1].abs().max()) == 0.0
    assert int((count > 0).sum()) >= B * 3 and int(count.max()) <= k


def test_roi_pool_promotes_low_precision_features():
    pts, valid = make_cloud(13, b=1)
    boxes = make_boxes(14)[:1]
    feats = torch.randn(1, N, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    pooled, _, _ = p2.roi_pool3d(t(pts), feats, t(valid), t(boxes), 8, 0.5)
    assert pooled.dtype == torch.float32 and pooled.shape == (1, 6, 8, 7)


# ------------------------------------------------------------------- dispatch


def _args(name, device="cpu"):
    pts, valid = make_cloud(15, b=2, n=64)
    pts, valid = t(pts).to(device), t(valid).to(device)
    boxes = t(make_boxes(16)[:2]).to(device)
    return {
        "fps": (p2.fps, (pts, valid, 8)),
        "ball_query": (p2.multi_radius_ball_query, (pts[:, :5], pts, valid, (2.0, 4.0), (4, 8))),
        "knn": (p2.three_nn, (pts[:, :5], pts, valid)),
        "roi_select": (p2.roi_inside_select, (pts, valid, boxes, 8, 0.5)),
    }[name]


PLAIN = {"fps": "furthest_point_sample", "ball_query": "multi_radius_ball_query_dense",
         "knn": "three_nn_dense", "roi_select": "_roi_inside_select_dense"}
CUDA = {"fps": "_fps_cuda", "ball_query": "_ball_query_cuda", "knn": "_three_nn_cuda",
        "roi_select": "_roi_select_cuda"}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_dispatch_by_device_type(monkeypatch, name):
    calls = []
    plain = getattr(p2, PLAIN[name])
    monkeypatch.setattr(p2, PLAIN[name], lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setattr(_build, "load_library",
                        lambda lib: pytest.fail(f"the CPU path asked for the {lib} library"))
    before = dict(p2.KERNEL_LAUNCHES)
    fn, args = _args(name)
    fn(*args)
    assert calls == [1] and p2.KERNEL_LAUNCHES == before
    fn, args = _args(name, "meta")
    with pytest.raises(ValueError, match="meta"):
        fn(*args)
    assert calls == [1]


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_cuda_path_propagates_loader_errors(monkeypatch, name):
    """The CUDA launch path, with the kernel loader failing, raises and
    returns no plain result."""
    def broken_loader(lib):
        raise RuntimeError(f"cannot build {lib}")

    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    monkeypatch.setattr(p2, PLAIN[name], plain_must_not_run)
    before = dict(p2.KERNEL_LAUNCHES)
    fn, args = _args(name)
    if name == "roi_select":
        pts, valid, boxes, k, extra = args
        args = (p2._box_params(boxes, extra), pts, valid, k)
    with pytest.raises(RuntimeError, match="cannot build"):
        getattr(p2, CUDA[name])(*args)
    assert p2.KERNEL_LAUNCHES == before


def test_rejects_bad_arguments():
    pts, valid = (t(a) for a in make_cloud(17, b=2, n=16))
    with pytest.raises(TypeError, match="float32"):
        p2.fps(pts.double(), valid, 4)
    with pytest.raises(TypeError, match="bool"):
        p2.fps(pts, valid.int(), 4)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        p2.fps(pts[0], valid[0], 4)
    with pytest.raises(ValueError, match="1 to 4 radii"):
        p2.multi_radius_ball_query(pts[:, :2], pts, valid, (1.0,) * 5, (2,) * 5)
    with pytest.raises(ValueError, match="queries must be"):
        p2.three_nn(pts[:1, :2], pts, valid)
    with pytest.raises(ValueError, match="queries must be"):
        p2.roi_inside_select(pts, valid, torch.zeros(2, 3, 6), 4)


@pytest.mark.cuda
def test_kernels_on_card_match_plain():
    """On a machine with a card: each CUDA kernel equals its plain version,
    with invalid points, duplicated points, an empty row and an empty box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    pts, valid = make_cloud(18, b=4, n=5000, duplicates=50)
    pts, valid = t(pts).cuda(), t(valid).cuda()
    before = dict(p2.KERNEL_LAUNCHES)
    sel = p2.fps(pts, valid, 700)
    assert torch.equal(sel, p2.furthest_point_sample(pts, valid, 700))
    centers = p2.group_points(pts, sel[:, :, None])[:, :, 0].clone()
    centers[:, -1] = 500.0
    want = p2.multi_radius_ball_query_dense(centers, pts, valid, (1.0, 2.5), (16, 32))
    # The wrapper (the rule's kernel), then the cell grid, also with 16
    # buckets a sample (neighbouring cells share buckets), and the scan.
    for got in (p2.multi_radius_ball_query(centers, pts, valid, (1.0, 2.5), (16, 32)),
                p2._ball_grid_cuda(centers, pts, valid, (1.0, 2.5), (16, 32)),
                p2._ball_grid_cuda(centers, pts, valid, (1.0, 2.5), (16, 32), buckets=16),
                p2._ball_scan_cuda(centers, pts, valid, (1.0, 2.5), (16, 32))):
        for (g_idx, g_cnt), (w_idx, w_cnt) in zip(got, want):
            assert torch.equal(g_idx, w_idx) and torch.equal(g_cnt, w_cnt)
    w_d, w_idx = p2.three_nn_dense(pts, centers, valid[:, :700])
    for shape in (None, (1, 4), (2, 16)):
        g_d, g_idx = (p2.three_nn(pts, centers, valid[:, :700]) if shape is None
                      else p2._three_nn_cuda(pts, centers, valid[:, :700], shape))
        assert torch.equal(g_idx, w_idx)
        torch.testing.assert_close(g_d, w_d, rtol=1e-6, atol=1e-6)
    boxes = t(make_boxes(19, r=20)).cuda()
    boxes = torch.cat([boxes, boxes[:1]], dim=0)
    g_idx, g_cnt = p2.roi_inside_select(pts, valid, boxes, 128, 1.0)
    w_idx, w_cnt = p2.roi_inside_select_dense(pts, valid, boxes, 128, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(g_idx, w_idx) and torch.equal(g_cnt, w_cnt)
    extra = {"ball_query": 3, "knn": 2}
    assert p2.KERNEL_LAUNCHES == {k: v + 1 + extra.get(k, 0) for k, v in before.items()}
