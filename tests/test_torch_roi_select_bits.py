"""The RoI-select kernel (B8) of ``lyft3d_tpu_torch``, on the CPU: a torch
emulation of ``csrc/roi_select.cu``'s walk (segments of 32·T points, one
ballot word a thread and box, an exclusive scan of the words' popcounts
over warps, hits written to ``running + prefix`` below k, the block leaving
once each of its G boxes has k hits) at every launch shape the rule can
pick, held ``torch.equal`` to the plain version and to the JAX package's
Pallas kernel in interpret mode on the same numpy inputs.

The kernel itself runs only on a card (``chip_smoke.py`` phase 8 and the
``cuda`` case below).
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


def inside_mask(params, points, valid):
    """``(B, R, N)``: the plain version's in-box test, the kernel's arithmetic."""
    cx, cy, cz, hl, hw, hh, c, s = (params[..., i, None] for i in range(8))
    dx = points[:, None, :, 0] - cx
    dy = points[:, None, :, 1] - cy
    dz = points[:, None, :, 2] - cz
    lx = c * dx + s * dy
    ly = (-s) * dx + c * dy
    return (lx.abs() <= hl) & (ly.abs() <= hw) & (dz.abs() <= hh) & valid[:, None, :]


def emulate_walk(params, points, valid, k, shape):
    """``csrc/roi_select.cu`` for launch shape ``(G, T)``: per block of G
    boxes, the segment walk with its words, prefix and early stop. Asserts
    that every slot below the count is written exactly once. Returns
    ``(idx, count, segments walked a block)``."""
    g_boxes, threads = shape
    b, n, _ = points.shape
    r = params.shape[1]
    seg = 32 * threads
    warps = threads // 32
    mask = inside_mask(params, points, valid)
    idx = torch.zeros((b, r, k), dtype=torch.int32)
    cnt = torch.zeros((b, r), dtype=torch.int32)
    walked = []
    bit = torch.arange(32)
    for s in range(b):
        for row0 in range(0, r, g_boxes):
            rows = [row0 + g for g in range(g_boxes)]
            running = [0 if row < r else k for row in rows]
            first = [0] * g_boxes
            out = torch.full((g_boxes, k), -1, dtype=torch.int64)
            writes = torch.zeros((g_boxes, k), dtype=torch.int64)
            segments = 0
            for seg0 in range(0, n, seg):
                if all(x >= k for x in running):
                    break
                segments += 1
                for g, row in enumerate(rows):
                    hits = torch.zeros(seg, dtype=torch.bool)
                    if row < r:
                        part = mask[s, row, seg0:seg0 + seg]
                        hits[:part.numel()] = part
                    words = hits.view(threads, 32)  # thread t: points seg0 + 32 t + bit
                    popc = words.sum(-1)
                    incl = popc.view(warps, 32).cumsum(-1)  # warp shuffles
                    totals = incl[:, -1]  # lane 31 of each warp
                    before = (totals.cumsum(0) - totals).repeat_interleave(32)
                    slot0 = running[g] + before + incl.flatten() - popc
                    for tid in torch.nonzero(popc).flatten().tolist():
                        pos = seg0 + 32 * tid + bit[words[tid]]
                        slots = int(slot0[tid]) + torch.arange(pos.numel())
                        if int(slot0[tid]) == 0:
                            first[g] = int(pos[0])
                        keep = slots < k
                        out[g, slots[keep]] = pos[keep]
                        writes[g, slots[keep]] += 1
                    running[g] += int(totals.sum())
            walked.append(segments)
            for g, row in enumerate(rows):
                if row >= r:
                    continue
                got = min(running[g], k)
                assert bool((writes[g, :got] == 1).all()) and bool((writes[g, got:] == 0).all())
                out[g, got:] = first[g]
                idx[s, row] = out[g].to(torch.int32)
                cnt[s, row] = got
    return idx, cnt, walked


def cloud(n, seed, b=2):
    """``b`` clouds of ``n`` points uniform in ±10 x ±10 x ±2 m, 5% invalid."""
    rng = np.random.RandomState(seed)
    pts = (rng.uniform(-1, 1, (b, n, 3)) * [10.0, 10.0, 2.0]).astype(np.float32)
    return pts, rng.rand(b, n) >= 0.05


def segment_end_cloud(n, threads, k, seed):
    """Cloud 0 a kilometre away but for points inside box 0 (``boxes`` below)
    whose k-th is the last point of the first segment of 32·T points, with
    hits after it; cloud 1 likewise with its k-th hit the cloud's last point."""
    rng = np.random.RandomState(seed)
    pts = (rng.uniform(-1, 1, (2, n, 3)) * [10.0, 10.0, 2.0]).astype(np.float32)
    pts[..., 0] += 1000.0
    seg = 32 * threads
    for b, last in ((0, seg - 1), (1, n - 1)):
        inside = np.concatenate([rng.choice(last, k - 1, replace=False), [last]])
        if b == 0:
            inside = np.concatenate([inside, seg + rng.choice(n - seg, 40, replace=False)])
        pts[b, inside] = rng.uniform(-0.25, 0.25, (inside.size, 3))
    return pts, np.ones((2, n), bool)


def boxes(pts, r, seed):
    """``r`` boxes a cloud ``[x, y, z, w, l, h, yaw]``: a 2 m box at the
    origin, boxes of 2-6 m on points of the cloud, the last far away."""
    rng = np.random.RandomState(seed)
    b = pts.shape[0]
    pick = rng.randint(0, pts.shape[1], (b, r))
    out = np.concatenate([
        np.take_along_axis(pts, pick[..., None], 1), rng.uniform(2, 6, (b, r, 3)),
        rng.uniform(-np.pi, np.pi, (b, r, 1)),
    ], axis=-1).astype(np.float32)
    out[:, 0] = [0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.3]
    out[:, -1, :3] = 500.0
    return out


def near_face(pts, bx, extra, margin):
    """``(B, R, N)``: whether moving a box's faces ``margin`` m in or out
    changes whether the point is inside (float64)."""
    d = pts[:, None, :, :].astype(np.float64) - bx[:, :, None, :3]
    c, s = np.cos(bx[..., 6:7]), np.sin(bx[..., 6:7])
    local = np.abs(np.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1], d[..., 2]]))
    half = np.stack([bx[..., 4:5], bx[..., 3:4], bx[..., 5:6]]) / 2 + extra
    return (local <= half + margin).all(0) & ~(local <= half - margin).all(0)


def clear_of_faces(pts, bx, extra):
    """The cloud with every point within 1e-3 m of a face moved 1 km along x:
    the JAX kernel forms cos, sin and the half sizes itself, so the last bit
    must not decide a comparison."""
    near = near_face(pts, bx, extra, 1e-3).any(axis=1)
    pts = pts.copy()
    pts[..., 0] += np.where(near, 1000.0, 0.0).astype(np.float32)
    return pts


EXTRA = 0.5
# (what, n, boxes a sample, k, seed); the segment-end cases are built for the
# launch's T below.
CASES = [("N=1000", 1000, 7, 64, 1), ("N=8193", 8193, 9, 512, 2), ("k=1", 5000, 6, 1, 3),
         ("k>N", 300, 5, 512, 4), ("no valid point", 2000, 6, 32, 5),
         ("segment end", None, 3, 100, 6)]


def case_inputs(what, n, r, k, seed, threads):
    if what == "segment end":
        n = 32 * threads + 997
        pts, valid = segment_end_cloud(n, threads, k, seed)
    else:
        pts, valid = cloud(n, seed)
        if what == "no valid point":
            valid[:] = False
    bx = boxes(pts, r, seed + 100)
    return clear_of_faces(pts, bx, EXTRA), valid, bx


@pytest.mark.parametrize("shape", p2.ROI_SHAPES, ids=lambda s: f"G{s[0]}T{s[1]}")
@pytest.mark.parametrize("what,n,r,k,seed", CASES, ids=[c[0] for c in CASES])
def test_emulated_walk_equals_plain(what, n, r, k, seed, shape):
    pts, valid, bx = case_inputs(what, n, r, k, seed, shape[1])
    params = p2._box_params(t(bx), EXTRA)
    got_idx, got_cnt, walked = emulate_walk(params, t(pts), t(valid), k, shape)
    want_idx, want_cnt = p2.roi_inside_select_dense(t(pts), t(valid), t(bx), k, EXTRA)
    assert torch.equal(got_idx, want_idx) and torch.equal(got_cnt, want_cnt)
    if what == "segment end":
        assert int(want_cnt[0, 0]) == k and int(want_cnt[1, 0]) == k
        assert int(want_idx[0, 0, -1]) == 32 * shape[1] - 1 and int(want_idx[1, 0, -1]) == pts.shape[1] - 1
    if what == "no valid point":
        assert not bool(want_cnt.any()) and not bool(want_idx.any())
    if what == "k>N":
        assert int(want_cnt.max()) <= pts.shape[1]


@pytest.mark.parametrize("what,n,r,k,seed", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_jax_interpret_kernel(what, n, r, k, seed):
    """The plain version the emulation is held to equals the Pallas kernel
    on the same clouds (once per case; the segment end for T = 256)."""
    pts, valid, bx = case_inputs(what, n, r, k, seed, 256)
    assert not near_face(pts, bx, EXTRA, 1e-4).any()
    want_idx, want_cnt = p2.roi_inside_select_dense(t(pts), t(valid), t(bx), k, EXTRA)
    f_idx, f_cnt = per_sample(lambda p, v, b: jsel.roi_inside_select_fused(
        p, v, b, num_sampled=k, extra_width=EXTRA, interpret=True), pts, valid, bx)
    assert torch.equal(want_idx, t(f_idx)) and torch.equal(want_cnt, t(f_cnt).to(torch.int32))


def test_early_stop_leaves_after_the_segment_that_fills():
    """A block whose boxes fill in the first segment walks one segment of a
    cloud of several; a block with a box that never fills walks them all."""
    pts, valid = cloud(20000, 7, b=1)
    bx = boxes(pts, 2, 8)
    bx[0, 0, 3:6] = 40.0  # holds the whole cloud
    params = p2._box_params(t(bx), 0.0)
    _, cnt, walked = emulate_walk(params, t(pts), t(valid), 64, (1, 256))
    assert int(cnt[0, 0]) == 64 and walked == [1, 3]


@pytest.mark.parametrize("boxes_total,shape", [
    (4 * 100, (2, 256)), (4 * 512, (4, 256)), (1, (1, 256)), (263, (1, 256)), (264, (2, 256)),
    (528, (4, 256)), (400 * 100, (4, 256)),
])
def test_launch_shape_rule(boxes_total, shape):
    """G doubles while the launch keeps a block an SM (132): the measured
    picks at the PointRCNN call's 400 boxes and the training shape's 2,048."""
    assert p2._roi_launch_shape(boxes_total) == shape and shape in p2.ROI_SHAPES


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """An unbuilt launch shape and a cloud past the kernel's int32 indices
    raise before any launch; nothing falls back to the plain version."""
    pts, valid = cloud(100, 9)
    bx = p2._box_params(t(boxes(pts, 3, 10)), 0.0)
    monkeypatch.setattr(p2, "_roi_select_library", lambda: (lambda *a: pytest.fail("launched")))
    monkeypatch.setattr(p2, "_roi_inside_select_dense", lambda *a: pytest.fail("fell back"))
    before = dict(p2.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="no kernel of 3 boxes"):
        p2._roi_select_cuda(bx, t(pts), t(valid), 8, shape=(3, 256))
    monkeypatch.setattr(p2, "ROI_MAX_POINTS", 50)
    with pytest.raises(ValueError, match="at most 50 points"):
        p2._roi_select_cuda(bx, t(pts), t(valid), 8)
    assert p2.KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_every_launch_shape_on_card_matches_plain():
    """On a machine with a card: every launch shape and the rule's, at each
    case, equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    for what, n, r, k, seed in CASES:
        for shape in (None, *p2.ROI_SHAPES):
            threads = 256 if shape is None else shape[1]
            pts, valid, bx = (t(a).cuda() for a in case_inputs(what, n, r, k, seed, threads))
            want = p2.roi_inside_select_dense(pts, valid, bx, k, EXTRA)
            got = (p2.roi_inside_select(pts, valid, bx, k, EXTRA) if shape is None else
                   p2._roi_select_cuda(p2._box_params(bx, EXTRA), pts, valid, k, shape))
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (what, shape)
