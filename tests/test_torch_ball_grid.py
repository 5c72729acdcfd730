"""The cell-grid ball query (B6) and the split 3-NN (B7) of
``lyft3d_tpu_torch``, on the CPU: the plain version of the grid's cell
table (``ball_cell_table``), a Python emulation of each kernel's algorithm
over it, and the two shape rules.

The kernels themselves run only on a card (``chip_smoke.py`` phase 8, which
also holds the keys kernel to ``ball_cell_keys``, and
``test_torch_pointnet2.py::test_kernels_on_card_match_plain``). Here the
emulations
follow ``csrc/ball_query.cu`` (27 lanes, one per distinct neighbouring
bucket, merged by lowest index) and ``csrc/knn.cu`` (P interleaved chunks,
each an ordered top 3, merged by (d², index)); each must equal the plain
version and the JAX package's Pallas kernel in interpret mode on the same
numpy inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import select_kernel as jsel
from lyft3d_tpu_torch.ops import pointnet2 as p2


def t(x):
    return torch.from_numpy(np.array(x))


def per_sample(fn, *arrays):
    """Run an unbatched JAX function over the leading axis; stack each output."""
    outs = [fn(*[jnp.asarray(a[i]) for a in arrays]) for i in range(arrays[0].shape[0])]
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


def cloud(case, seed, b=3, n=400, s=40, radii=(0.5, 1.0)):
    """A cloud of ``n`` points in ±3 x ±3 x ±1 m and ``s`` centres on its
    first points, changed as ``case`` says."""
    rng = np.random.RandomState(seed)
    pts = (rng.uniform(-1, 1, (b, n, 3)) * [3.0, 3.0, 1.0]).astype(np.float32)
    valid = rng.rand(b, n) >= 0.1
    if case == "lidar":  # a sensor at the origin: ground and blobs, log-uniform range
        rng_ = 0.2 * 15.0 ** rng.rand(b, n)
        az = rng.uniform(0, 2 * np.pi, (b, n))
        ground = rng.rand(b, n, 1) < 0.6
        z = np.where(ground[..., 0], -0.5 + 0.01 * rng.randn(b, n), rng.uniform(-0.5, 0.5, (b, n)))
        blob = np.stack([rng_ * np.cos(az), rng_ * np.sin(az), z], -1) + rng.randn(b, n, 3) * 0.05
        pts = np.where(ground, np.stack([rng_ * np.cos(az), rng_ * np.sin(az), z], -1), blob)
        pts = pts.astype(np.float32)
    elif case == "faces":  # whole multiples of the cell's side, and one float32 step off
        side = 1.0 / p2._ball_cell_inverse(radii)
        face = (np.round(pts.astype(np.float64) / side) * side).astype(np.float32)
        step = rng.randint(-1, 2, face.shape)
        face = np.where(step > 0, np.nextafter(face, np.float32(np.inf)), face)
        face = np.where(step < 0, np.nextafter(face, np.float32(-np.inf)), face)
        pts = np.where(rng.rand(b, n, 1) < 0.6, face, pts).astype(np.float32)
    elif case == "far":  # clouds around ±1,000 m
        pts[0, :, 0] += 1000.0
        pts[1, :, 1] -= 1000.0
        pts[2:] *= 1e-3  # any others squeezed around the origin: many points a cell
    elif case == "invalid":  # half the centres on invalid points
        valid[:, :s:2] = False
    centers = pts[:, :s].copy()
    if case == "far":
        centers[:, -1] = [1000.0, 1000.0, 0.0]
    return centers, pts, valid


def centre_buckets(centers, inv_side, buckets):
    """The 27 neighbouring buckets of each centre as the grid kernel forms
    them: ``(B, S, 27)`` int64, lane l at offset (l % 3, l / 3 % 3, l / 9) − 1."""
    b, s, _ = centers.shape
    cells = torch.floor(centers.double() * inv_side).clamp(-p2.BALL_CELL_CLAMP, p2.BALL_CELL_CLAMP).long()
    lane = torch.arange(27)
    offset = torch.stack([lane % 3, lane // 3 % 3, lane // 9], dim=-1) - 1
    near = cells[:, :, None, :] + offset
    return p2._cell_bucket(near, buckets) + torch.arange(b)[:, None, None] * buckets


CASES = ["uniform", "faces", "far", "invalid", "lidar"]


@pytest.mark.parametrize("buckets", [None, 16])
@pytest.mark.parametrize("case", CASES)
def test_cell_table_is_complete(case, buckets):
    """Every (centre, valid point) pair with d² < float32(r_max²) lies in one
    of the centre's 27 buckets; indices ascend in a bucket; each valid point
    is listed once and no invalid one."""
    radii = (0.5, 1.0)
    centers, pts, valid = (t(a) for a in cloud(case, seed=CASES.index(case), radii=radii))
    b, n, _ = pts.shape
    buckets = p2._ball_buckets(n) if buckets is None else buckets
    inv = p2._ball_cell_inverse(radii)
    order, starts = p2.ball_cell_table(pts, valid, inv, buckets)
    assert order.dtype == torch.int64 and order.shape == (b * n,)
    assert starts.shape == (b * buckets + 1,)
    assert int(starts[0]) == 0 and int(starts[-1]) == int(valid.sum())
    assert bool((starts[1:] >= starts[:-1]).all())
    # The bucket of each listed entry; a bucket holds the points of one sample.
    bucket_of = torch.repeat_interleave(torch.arange(b * buckets), (starts[1:] - starts[:-1]).long())
    flat = order[: int(starts[-1])]
    sample, listed = flat // n, flat % n
    assert torch.equal(sample, bucket_of // buckets)
    assert bool(valid[sample, listed].all())
    assert torch.equal(torch.sort(sample * n + listed).values, torch.nonzero(valid.flatten())[:, 0])
    same = bucket_of[1:] == bucket_of[:-1]
    assert bool((listed[1:][same] > listed[:-1][same]).all())
    # Completeness.
    point_bucket = torch.full((b, n), -1, dtype=torch.int64)
    point_bucket[sample, listed] = bucket_of
    near = centre_buckets(centers, inv, buckets)
    inside = (p2._sq_dist(centers, pts) < max(p2._squared_radii(radii))) & valid[:, None, :]
    bi, si, ni = torch.nonzero(inside, as_tuple=True)
    assert len(bi) > 100
    assert bool((near[bi, si] == point_bucket[bi, ni][:, None]).any(dim=-1).all())
    if buckets == 16:  # 27 cells in 16 buckets: neighbours share buckets
        assert int(torch.sort(near, dim=-1).values.diff(dim=-1).eq(0).sum()) > 0


def emulate_grid(centers, pts, valid, radii, ks, buckets=None):
    """``csrc/ball_query.cu``'s grid kernel in Python over the port's table."""
    b, s, _ = centers.shape
    n = pts.shape[1]
    buckets = p2._ball_buckets(n) if buckets is None else buckets
    inv = p2._ball_cell_inverse(radii)
    order, starts = p2.ball_cell_table(pts, valid, inv, buckets)
    r2 = p2._squared_radii(radii)
    r2_max = max(r2)
    near = centre_buckets(centers, inv, buckets)
    idx = torch.zeros((b, s, sum(ks)), dtype=torch.int32)
    cnt = torch.zeros((b, s, len(ks)), dtype=torch.int32)
    offsets = np.cumsum([0, *ks])
    for bi in range(b):
        d2_all = p2._sq_dist(centers[bi:bi + 1], pts[bi:bi + 1])[0]
        for si in range(s):
            lanes = []
            for lane in range(27):  # one lane a distinct bucket: the lowest of equals
                bucket = int(near[bi, si, lane])
                if bucket not in [int(near[bi, si, j]) for j in range(lane)]:
                    lanes.append([int(order[j]) - bi * n for j in range(int(starts[bucket]), int(starts[bucket + 1]))])
            heads = [[i for i in lane if float(d2_all[si, i]) < r2_max] for lane in lanes]
            found, first = [0] * len(ks), [0] * len(ks)
            while any(heads):
                m = min(h[0] for h in heads if h)
                owner = next(h for h in heads if h and h[0] == m)
                d2 = float(d2_all[si, m])
                for r, k in enumerate(ks):
                    if found[r] < k and d2 < r2[r]:
                        idx[bi, si, offsets[r] + found[r]] = m
                        first[r] = m if found[r] == 0 else first[r]
                        found[r] += 1
                if all(f >= k for f, k in zip(found, ks)):
                    break
                owner.pop(0)
            for r, k in enumerate(ks):
                idx[bi, si, offsets[r] + found[r]: offsets[r] + k] = first[r]
                cnt[bi, si, r] = found[r]
    return [(part, cnt[..., j]) for j, part in enumerate(torch.split(idx, list(ks), dim=-1))]


def assert_clear_of_radii(centers, pts, radii):
    d2 = ((centers[:, :, None, :].astype(np.float64) - pts[:, None, :, :]) ** 2).sum(-1)
    for r in radii:
        assert np.abs(d2 / (r * r) - 1.0).min() > 1e-6


@pytest.mark.parametrize("case,radii,ks,buckets", [
    ("uniform", (0.5, 1.0), (8, 16), None),
    ("faces", (0.5, 1.0), (8, 16), None),
    ("far", (0.3, 0.6, 1.2), (4, 8, 16), None),
    ("invalid", (0.25, 0.5, 0.75, 1.0), (2, 4, 8, 64), 16),
    ("uniform", (1.6,), (64,), 16),
    # Dense near the sensor, where rows fill and buckets hold many points.
    ("lidar", (0.1, 0.5), (16, 32), None),
    ("lidar", (0.1, 0.5), (4, 32), 16),
])
def test_emulated_grid_merge_equals_plain_and_jax(case, radii, ks, buckets):
    c, p, v = cloud(case, seed=10 + CASES.index(case), b=2, n=300, s=24, radii=radii)
    got = emulate_grid(t(c), t(p), t(v), radii, ks, buckets)
    want = p2.multi_radius_ball_query_dense(t(c), t(p), t(v), radii, ks)
    for (g_idx, g_cnt), (w_idx, w_cnt) in zip(got, want):
        assert torch.equal(g_idx, w_idx) and torch.equal(g_cnt, w_cnt)
    full = sum(int((cnt == k).sum()) for (_, cnt), k in zip(want, ks))
    assert full > 0 and int((want[-1][1] < ks[-1]).sum()) > 0
    # Against the Pallas kernel only where no distance sits on a radius (its
    # d² may round differently from the port's in the last bit).
    if case != "faces":
        assert_clear_of_radii(c, p, radii)
        fused = per_sample(lambda cc, pp, vv: jsel.multi_radius_ball_query_fused(
            cc, pp, vv, radii, ks, interpret=True), c, p, v)
        for (g_idx, g_cnt), (f_idx, f_cnt) in zip(got, fused):
            assert torch.equal(g_idx, t(f_idx)) and torch.equal(g_cnt, t(f_cnt).to(torch.int32))


def emulate_split_knn(unknown, known, valid, parts):
    """``csrc/knn.cu``: known point j goes to part j % P (invalid ones at
    +inf), each part keeps its top 3 by strict ``<`` in index order, and the
    parts' lists merge by (d², index)."""
    b, s, _ = unknown.shape
    m = known.shape[1]
    coded = torch.where(valid[..., None], known, torch.tensor(float("inf")))
    d2 = p2._sq_dist(unknown, coded)
    out_d = torch.empty((b, s, 3))
    out_i = torch.empty((b, s, 3), dtype=torch.int32)
    for bi in range(b):
        for si in range(s):
            lists = []
            for part in range(parts):
                top = []  # (d2, index), kept ordered
                for j in range(part, m, parts):
                    d = float(d2[bi, si, j])
                    if d < (top[-1][0] if len(top) == 3 else float("inf")):  # strict: +inf never enters
                        pos = next((e for e, (td, _) in enumerate(top) if d < td), len(top))
                        top = (top[:pos] + [(d, j)] + top[pos:])[:3]
                lists.append(top)
            merged = sorted((e for lst in lists for e in lst), key=lambda e: (e[0], e[1]))[:3]
            merged += [(float("inf"), None)] * (3 - len(merged))
            for e, (d, j) in enumerate(merged):
                miss = j is None
                out_i[bi, si, e] = m - 1 if miss else j
                out_d[bi, si, e] = 1e5 if miss else d  # a float32 d², rooted below
    return torch.where(out_d == 1e5, out_d, torch.sqrt(out_d.clamp_min(0.0))), out_i


@pytest.mark.parametrize("parts", [1, 4, 16])
@pytest.mark.parametrize("m,case", [(300, "ties"), (2, "few"), (37, "invalid")])
def test_split_three_nn_equals_plain_and_jax(parts, m, case):
    rng = np.random.RandomState(m + parts)
    known = rng.uniform(-3, 3, (2, m, 3)).astype(np.float32)
    valid = rng.rand(2, m) >= 0.1
    unknown = rng.uniform(-3, 3, (2, 30, 3)).astype(np.float32)
    if case == "ties":  # duplicated known points, queries on known points
        known[:, 150:200] = known[:, :50]
        valid[:, 150:200] = valid[:, :50]
        unknown[:, :10] = known[:, :10]
    elif case == "few":
        valid[:] = True
        valid[1, 0] = False
    elif case == "invalid":
        valid[0] = False
        valid[1, :-2] = False
    got_d, got_i = emulate_split_knn(t(unknown), t(known), t(valid), parts)
    want_d, want_i = p2.three_nn_dense(t(unknown), t(known), t(valid))
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    f_d, f_i = per_sample(lambda u, k, v: jsel.knn_fused(u, k, v, 3, interpret=True),
                          unknown, known, valid)
    assert torch.equal(got_i, t(f_i))
    np.testing.assert_allclose(got_d.numpy(), f_d, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch,s,n,r_max,kernel", [
    # The six launches of a PointRCNN call (Lyft test preset, batch 4).
    (4, 4096, 16384, 0.5, "grid"), (4, 1024, 4096, 1.0, "scan"), (4, 256, 1024, 2.0, "scan"),
    (4, 64, 256, 4.0, "scan"), (400, 128, 512, 0.2, "scan"), (400, 32, 128, 0.4, "scan"),
    (8, 4096, 16384, 0.1, "grid"), (4, 4096, 4096, 0.1, "grid"), (4, 4096, 4095, 0.1, "scan"),
    # Radii without cells, and the smallest shapes.
    (4, 4096, 16384, 0.0, "scan"), (4, 4096, 16384, float("inf"), "scan"),
    (4, 4096, 16384, float("nan"), "scan"), (1, 1, 1, 1.0, "scan"),
])
def test_ball_query_rule(batch, s, n, r_max, kernel):
    assert p2._ball_query_kernel(batch, s, n, r_max) == kernel
    if kernel == "grid":
        assert batch * s * n >= p2.BALL_GRID_MIN_PAIRS


@pytest.mark.parametrize("queries,m,shape", [
    # The four FP launches of a PointRCNN call (batch 4).
    (65536, 4096, (2, 4)), (16384, 1024, (1, 8)), (4096, 256, (1, 16)), (1024, 64, (1, 16)),
    (1, 1, (1, 16)), (3, 2, (1, 16)), (32768, 4096, (2, 8)), (10 ** 7, 65536, (2, 4)),
])
def test_knn_launch_shape_is_built(queries, m, shape):
    q, p = p2._knn_launch_shape(queries, m)
    assert (q, p) == shape and (q, p) in p2.KNN_SHAPES
    assert p2.KNN_THREADS % p == 0 and 32 % p == 0
    assert p == 4 or queries // q * p // 2 < p2.KNN_WAVE  # a wider split only below one wave


def test_cell_hash_stays_in_int64():
    """The largest masked cell times the largest prime stays below 2^47, and
    clamped cells ± 1 stay inside int64: the wrapper's and the kernel's
    arithmetic agree without overflow."""
    assert 0xFFFFF * max(p2._CELL_PRIMES) < 2 ** 47
    cells = torch.tensor([[2 ** 62 + 1, -(2 ** 62) - 1, 0], [-1, 1, 2 ** 20]], dtype=torch.int64)
    got = p2._cell_bucket(cells, 1 << 20)
    assert bool(((got >= 0) & (got < 1 << 20)).all())
    # Negative cells map as their two's complement low 20 bits.
    assert int(p2._cell_bucket(torch.tensor([[-1, 0, 0]]), 1 << 20)) == \
        int(p2._cell_bucket(torch.tensor([[0xFFFFF, 0, 0]]), 1 << 20))


@pytest.mark.parametrize("route", ["_ball_grid_cuda", "_ball_scan_cuda"])
def test_ball_query_routes_propagate_loader_errors(monkeypatch, route):
    """Either ball-query kernel's launch path, with the loader failing,
    raises, returns no plain result and counts no launch."""
    from lyft3d_tpu_torch import _build

    def broken_loader(lib):
        raise RuntimeError(f"cannot build {lib}")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    monkeypatch.setattr(p2, "multi_radius_ball_query_dense",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    before = dict(p2.KERNEL_LAUNCHES)
    c, p, v = (t(a) for a in cloud("uniform", seed=3, b=2, n=64, s=5))
    with pytest.raises(RuntimeError, match="cannot build ball_query"):
        getattr(p2, route)(c, p, v, (1.0, 2.0), (4, 8))
    assert p2.KERNEL_LAUNCHES == before


def test_cell_table_rejects_a_bucket_count_that_is_no_power_of_two():
    c, p, v = (t(a) for a in cloud("uniform", seed=4, b=1, n=32, s=2))
    with pytest.raises(ValueError, match="power of two"):
        p2.ball_cell_table(p, v, 1.0, 24)
