"""The pairwise rotated BEV IoU's CUDA kernel (``csrc/rotated_iou.cu``) and
its wrappers in ``ops/rotated_iou.py``.

On the CPU: the plain version is exactly 0 on every pair that the kernel's
early-out skips (:func:`far_apart`), CPU tensors take the plain version, the
CUDA path raises when its loader fails, and ``chip_smoke.py``'s candidates and
bound of the kernel hold. On a card (the ``cuda`` marker):
the kernel against the plain version on the same card within 1e-4 IoU, at
the path's shapes and at the edges.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke  # its LiDAR-like candidates (phase 7c) and the kernel's bound
from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops import rotated_iou as riou
from lyft3d_tpu_torch.ops.nms import nms_mask_from_iou, rotated_nms

IOU_TOL = chip_smoke.IOU_TOL  # ROADMAP R1's contract, and the benchmark's NMS tie


def edge_boxes():
    """Boxes whose pairs hit the edges: identical, sharing an edge, nested,
    touching at a corner, zero-size padding, yaw at ±π (about x = 40 m)."""
    return np.array([
        (40.0, 10.0, 2.0, 4.0, 0.0),
        (40.0, 10.0, 2.0, 4.0, 0.0),  # identical
        (40.0, 12.0, 2.0, 4.0, 0.0),  # shares the edge y = 11
        (40.1, 10.2, 1.0, 2.0, 0.5),  # nested in the first
        (43.0, 13.0, 2.0, 2.0, 0.0),  # touches (44, 14)...
        (45.0, 15.0, 2.0, 2.0, 0.0),  # ...this one's corner
        (40.0, 10.0, 2.0, 4.0, math.pi),  # the first, turned by π
        (40.0, 10.0, 2.0, 4.0, -math.pi),
        (41.0, 10.5, 1.9, 4.7, math.pi / 2),
        (41.0, 10.5, 1.9, 4.7, -math.pi / 2),
        (0.0, 0.0, 0.0, 0.0, 0.0),  # padding
        (0.0, 0.0, 0.0, 0.0, 0.0),
        (40.0, 10.0, 0.0, 0.0, 0.0),  # padding inside the first
    ], np.float32)


def _zero_size(boxes):
    return (boxes[..., 2] == 0) | (boxes[..., 3] == 0)


def far_apart(boxes1, boxes2):
    """``(…, N, M)`` bool: the pairs of BEV boxes ``(…, N, 5)`` × ``(…, M, 5)``
    that the kernel's early-out skips (``csrc/rotated_iou.cu``, with the
    wrapper's margins ``_FAR_GAP`` and ``_FAR_GAP_EDGE``): centres farther
    apart than the sum of the half-diagonals plus ``_FAR_GAP``, and that gap
    times the shorter edge of the two boxes above ``_FAR_GAP_EDGE``. A
    zero-size box is never far apart."""
    d = torch.hypot(boxes1[..., :, None, 0] - boxes2[..., None, :, 0],
                    boxes1[..., :, None, 1] - boxes2[..., None, :, 1])
    half_diag1 = 0.5 * torch.hypot(boxes1[..., 2], boxes1[..., 3])
    half_diag2 = 0.5 * torch.hypot(boxes2[..., 2], boxes2[..., 3])
    gap = d - (half_diag1[..., :, None] + half_diag2[..., None, :])
    edge1 = torch.minimum(boxes1[..., 2].abs(), boxes1[..., 3].abs())
    edge2 = torch.minimum(boxes2[..., 2].abs(), boxes2[..., 3].abs())
    edge = torch.minimum(edge1[..., :, None], edge2[..., None, :])
    return (gap > riou._FAR_GAP) & (gap * edge > riou._FAR_GAP_EDGE)


# ------------------------------------------------------------------- CPU tests


def _placed_pairs(rng, n, yaws, sizes):
    """Rows ``(n, 5)`` and columns ``(n, 5)`` whose k-th pair is placed at a
    log-uniform gap in [1e-4, 5] m between the two circumscribed circles,
    in a random direction; the float64 gaps of the k-th pairs."""
    def draw():
        xy = rng.uniform(-48, 48, (n, 2))
        if sizes == "metre":
            wl = rng.uniform(0.3, 12.0, (n, 2))
        else:  # thin and small: edges down to a millimetre
            wl = np.exp(rng.uniform(np.log(1e-3), np.log(2.0), (n, 2)))
        if yaws == "random":
            th = rng.uniform(-math.pi, math.pi, n)
        else:
            th = rng.choice(np.array([0.0, math.pi / 2, -math.pi / 2, math.pi, -math.pi]), n)
        return np.concatenate([xy, wl, th[:, None]], axis=1).astype(np.float32)

    rows, cols = draw(), draw()
    if yaws == "equal":
        cols[:, 4] = rows[:, 4]
    r64, c64 = rows.astype(np.float64), cols.astype(np.float64)
    reach = np.hypot(r64[:, 2], r64[:, 3]) / 2 + np.hypot(c64[:, 2], c64[:, 3]) / 2
    gap = np.exp(rng.uniform(np.log(1e-4), np.log(5.0), n))
    ang = rng.uniform(0, 2 * math.pi, n)
    cols[:, 0] = (r64[:, 0] + (reach + gap) * np.cos(ang)).astype(np.float32)
    cols[:, 1] = (r64[:, 1] + (reach + gap) * np.sin(ang)).astype(np.float32)
    c64 = cols.astype(np.float64)
    gap = np.hypot(r64[:, 0] - c64[:, 0], r64[:, 1] - c64[:, 1]) - reach
    return rows, cols, gap


@pytest.mark.parametrize("sizes", ["metre", "thin"])
@pytest.mark.parametrize("yaws", ["random", "axes", "equal"])
def test_plain_overlap_is_zero_where_the_kernel_skips(yaws, sizes):
    """Property behind the kernel's exact early-out: over random boxes, the
    plain version's overlap is exactly 0 on every pair ``far_apart`` names,
    and, for metre-scale boxes, on every pair whose centre distance exceeds
    the sum of the half-diagonals."""
    rng = np.random.default_rng(["random", "axes", "equal"].index(yaws) * 2 + (sizes == "thin"))
    rows, cols, gap = _placed_pairs(rng, 512, yaws, sizes)
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    inter = riou.rotated_overlap_bev_plain(r, c)  # (512, 512): placed pairs on the diagonal
    far = far_apart(r, c)
    assert far.float().mean() > 0.5 and far.diagonal().any() and not far.diagonal().all()
    assert torch.count_nonzero(inter[far]) == 0
    if sizes == "metre":
        diag = inter.diagonal()
        assert torch.count_nonzero(diag[torch.from_numpy(gap > 0)]) == 0
    # the pairs the kernel still works out include some that touch
    assert (~far.diagonal() & (inter.diagonal() == 0)).any()


def test_chip_smoke_iou_bound():
    """``chip_smoke.iou_bound``: the float32 result and the boxes as bytes,
    against ``IOU_PAIR_OPS`` a pair within reach and ``IOU_SKIP_OPS`` one
    whose circumscribed circles lie apart; the share of pairs within reach."""
    smoke = vars(chip_smoke)
    boxes = torch.tensor([[[0.0, 0.0, 2.0, 4.0, 0.3], [3.0, 0.0, 2.0, 4.0, 1.0], [30.0, 0.0, 2.0, 4.0, 0.0]]])
    ms, by, share = smoke["iou_bound"](boxes, boxes[:, :2])
    # within reach: (0, 0), (0, 1), (1, 0), (1, 1); the box at x = 30 reaches neither
    ops = 4 * smoke["IOU_PAIR_OPS"] + 2 * smoke["IOU_SKIP_OPS"]
    n_bytes = 4 * 6 + 20 * 5
    assert share == pytest.approx(4 / 6)
    assert (ms, by) == smoke["bound"](n_bytes, ops)
    by_bytes, by_ops = n_bytes / smoke["HBM_RATE"] * 1e3, ops / smoke["F32_PEAK"] * 1e3
    assert ms == pytest.approx(max(by_bytes, by_ops))
    assert by == ("bytes" if by_bytes >= by_ops else "operations")
    big = torch.from_numpy(smoke["iou_candidates"](2, 500, 0))
    ms, by, share = smoke["iou_bound"](big, big)
    pairs = 2 * 500 * 500
    worked = round(share * pairs)
    ops = smoke["IOU_PAIR_OPS"] * worked + smoke["IOU_SKIP_OPS"] * (pairs - worked)
    assert (ms, by) == smoke["bound"](4 * pairs + 20 * 2 * 1000, ops)
    assert 0 < share < 0.2


def test_chip_smoke_iou_candidates():
    """``chip_smoke.iou_candidates``: seeded float32 boxes of the nine
    classes' sizes, yaw in [-π, π], with near-duplicates that the NMS
    suppresses and pairs that the early-out skips."""
    smoke = vars(chip_smoke)
    a, b = smoke["iou_candidates"](3, 200, 5), smoke["iou_candidates"](3, 200, 5)
    assert a.shape == (3, 200, 5) and a.dtype == np.float32 and np.array_equal(a, b)
    assert not np.array_equal(a, smoke["iou_candidates"](3, 200, 6))
    assert np.abs(a[..., 4]).max() <= math.pi + 1e-6 and (a[..., 2:4] > 0).all()
    t = torch.from_numpy(a)
    iou = riou.rotated_iou_bev_plain(t, t)
    off = ~torch.eye(200, dtype=torch.bool)
    assert float((iou[:, off] > 0.5).float().mean()) > 1e-3
    assert float(far_apart(t, t).float().mean()) > 0.9


def test_path_by_device(monkeypatch):
    """CPU tensors take the plain version and launch nothing; another device
    type, mixed devices or an unknown criterion raise."""
    boxes = torch.from_numpy(edge_boxes()[:4])
    calls = []
    plain = riou.rotated_overlap_bev_plain
    monkeypatch.setattr(riou, "rotated_overlap_bev_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = riou.KERNEL_LAUNCHES
    assert riou.rotated_iou_bev(boxes, boxes).shape == (4, 4)
    assert riou.rotated_overlap_bev(boxes[None], boxes[None]).shape == (1, 4, 4)
    assert calls == [1, 1] and riou.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="meta"):
        riou.rotated_iou_bev(boxes.to("meta"), boxes.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        riou.rotated_overlap_bev(boxes, boxes.to("meta"))
    with pytest.raises(ValueError, match="criterion"):
        riou.rotated_iou_bev(boxes, boxes, criterion=2)
    assert calls == [1, 1]


def test_cuda_path_propagates_loader_errors(monkeypatch):
    """The CUDA launch path, with the kernel loader failing, raises and
    returns no plain result."""
    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    monkeypatch.setattr(riou, "rotated_overlap_bev_plain", plain_must_not_run)
    monkeypatch.setattr(riou, "polygon_intersection_area", plain_must_not_run)
    before = riou.KERNEL_LAUNCHES
    for mode in ("overlap", -1, 0, 1):
        with pytest.raises(RuntimeError, match="cannot build rotated_iou"):
            riou._pairwise_cuda(torch.zeros(2, 8, 5), torch.zeros(2, 3, 5), mode)
    assert riou.KERNEL_LAUNCHES == before


# ------------------------------------------------------------------ card tests


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run_kernel(fn, *args, launches=1):
    before = riou.KERNEL_LAUNCHES
    out = fn(*args)
    torch.cuda.synchronize()
    assert riou.KERNEL_LAUNCHES == before + launches
    return out


def _worst(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_kernel_matches_plain_on_lidar_candidates(criterion):
    """(4, 1,000, 1,000) candidates with clusters of near-duplicates: the
    kernel within 1e-4 of the plain version on the same card, and the
    overlap within float32 rounding of the plain overlap."""
    dev = _card()
    boxes = torch.from_numpy(chip_smoke.iou_candidates(4, 1000, 11)).to(dev)
    got = _run_kernel(riou.rotated_iou_bev, boxes, boxes, criterion)
    want = riou.rotated_iou_bev_plain(boxes, boxes, criterion)
    assert got.shape == (4, 1000, 1000) and got.dtype == torch.float32 and got.is_contiguous()
    gap = _worst(got, want)
    full = 1.0 - float(far_apart(boxes, boxes).float().mean())
    print(f"rotated_iou kernel, lidar 4x1000x1000, criterion {criterion}: worst |IoU gap| "
          f"{gap:.3e}; pairs past the early-out {full:.4%}; pairs overlapping "
          f"{float((want > 0).float().mean()):.4%}")
    assert gap <= IOU_TOL
    assert float((want > 0.5).float().mean()) > 1e-3  # near-duplicates are there
    inter = _run_kernel(riou.rotated_overlap_bev, boxes, boxes)
    torch.testing.assert_close(inter, riou.rotated_overlap_bev_plain(boxes, boxes),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_edges():
    """Identical, edge-sharing, nested, corner-touching, zero-size and
    ±π boxes, every pair, each criterion. A real box against a zero-size one
    is degenerate in both versions (the containment test passes every
    point): the overlaps agree and both IoUs exceed 1; callers mask such
    padding."""
    dev = _card()
    boxes = torch.from_numpy(edge_boxes()).to(dev)
    zero = torch.from_numpy(_zero_size(edge_boxes())).to(dev)
    degenerate = zero[:, None] ^ zero[None, :]
    inter = _run_kernel(riou.rotated_overlap_bev, boxes, boxes)
    torch.testing.assert_close(inter, riou.rotated_overlap_bev_plain(boxes, boxes),
                               rtol=1e-5, atol=1e-5)
    worst = 0.0
    for criterion in (-1, 0, 1):
        got = _run_kernel(riou.rotated_iou_bev, boxes, boxes, criterion)
        want = riou.rotated_iou_bev_plain(boxes, boxes, criterion)
        worst = max(worst, _worst(got[~degenerate], want[~degenerate]))
        if criterion == -1:
            assert bool((got[degenerate] > 1).all()) and bool((want[degenerate] > 1).all())
            assert abs(float(got[0, 1]) - 1) < 1e-6 and abs(float(got[6, 7]) - 1) < 1e-6
            assert float(got[0, 2]) < 1e-6 and float(got[4, 5]) < 1e-6
    print(f"rotated_iou kernel, edge cases: worst |IoU gap| {worst:.3e}")
    assert worst <= IOU_TOL


def _anchors_like_the_path(n):
    """``(n, 5)`` anchors on a grid over ±49.6 m, yaw 0 and π/2, a few sizes."""
    side = int(math.ceil(math.sqrt(n / 2)))
    g = np.linspace(-49.6, 49.6, side, dtype=np.float32)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    xy = np.stack([xx.ravel(), yy.ravel()], 1)
    xy = np.repeat(xy, 2, 0)[:n]
    sizes = np.array([a[0][:2] for a in chip_smoke.LYFT9_ANCHORS], np.float32)
    size = sizes[np.arange(n) % len(sizes)]
    yaw = np.where(np.arange(n) % 2 == 0, 0.0, math.pi / 2).astype(np.float32)
    return np.concatenate([xy, size, yaw[:, None]], 1).astype(np.float32)


@pytest.mark.cuda
def test_kernel_shapes():
    """N = 0, M = 0 (no launch), M = 1, non-contiguous and bfloat16 inputs,
    a batch of one against many, PointRCNN's 4 × 1,024² and the
    69,192 anchors × 64 boxes of the assigner (unbatched)."""
    dev = _card()
    boxes = torch.from_numpy(chip_smoke.iou_candidates(4, 1024, 3)).to(dev)
    for n, m in ((0, 5), (5, 0), (0, 0)):
        out = _run_kernel(riou.rotated_iou_bev, boxes[:, :n], boxes[:, :m], launches=0)
        assert out.shape == (4, n, m)
    cases = {
        "m1": (boxes, boxes[:, 7:8]),
        "noncontiguous": (boxes.transpose(1, 2).contiguous().transpose(1, 2)[:, ::3],
                          boxes[:, 1::2]),
        "broadcast batch": (boxes[:1, :200], boxes[:, :300]),
        "pointrcnn": (boxes, boxes),
        "anchors": (torch.from_numpy(_anchors_like_the_path(69192)).to(dev),
                    torch.from_numpy(chip_smoke.iou_candidates(1, 64, 4)[0]).to(dev)),
    }
    worst = {}
    for name, (b1, b2) in cases.items():
        if name == "noncontiguous":
            assert not b1.is_contiguous() and not b2.is_contiguous()
        got = _run_kernel(riou.rotated_iou_bev, b1, b2)
        want = riou.rotated_iou_bev_plain(b1, b2)
        assert got.shape == want.shape, name
        worst[name] = _worst(got, want)
    half = boxes[:, :300].to(torch.bfloat16)
    got = _run_kernel(riou.rotated_iou_bev, half, half)
    assert got.dtype == torch.bfloat16
    worst["bfloat16 (against float32 on its values)"] = _worst(
        got, riou.rotated_iou_bev_plain(half.float(), half.float()).to(torch.bfloat16))
    print("rotated_iou kernel, shapes: worst |IoU gap| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    assert max(v for k, v in worst.items() if "bfloat16" not in k) <= IOU_TOL
    assert worst["bfloat16 (against float32 on its values)"] <= 1e-2  # one bfloat16 rounding


@pytest.mark.cuda
def test_kernel_iou_3d():
    """``rotated_iou_3d`` (PointRCNN's targets: rois × GT) through the kernel
    against the plain version on the CPU."""
    dev = _card()
    rng = np.random.default_rng(5)
    bev = chip_smoke.iou_candidates(4, 160, 5)
    z = rng.uniform(-1, 1, (4, 160, 1)).astype(np.float32)
    h = rng.uniform(1.0, 3.0, (4, 160, 1)).astype(np.float32)
    boxes = np.concatenate([bev[..., :2], z, bev[..., 2:4], h, bev[..., 4:]], -1)
    rois, gt = torch.from_numpy(boxes[:, :128]), torch.from_numpy(boxes[:, 128:])
    got = _run_kernel(riou.rotated_iou_3d, rois.to(dev), gt.to(dev))
    want = riou.rotated_iou_3d(rois, gt)
    gap = _worst(got.cpu(), want)
    print(f"rotated_iou kernel, 3d 4x128x32: worst |IoU gap| {gap:.3e}")
    assert gap <= IOU_TOL


@pytest.mark.cuda
def test_rotated_nms_keeps_what_the_plain_path_keeps():
    """``rotated_nms`` through the kernel keeps the boxes the plain IoU's NMS
    keeps, in every sample where no IoU lies within 1e-4 of the threshold."""
    dev = _card()
    rng = np.random.default_rng(13)
    boxes = torch.from_numpy(chip_smoke.iou_candidates(8, 1000, 13)).to(dev)
    scores = torch.from_numpy(rng.random((8, 1000)).astype(np.float32)).to(dev)
    valid = scores > 0.05
    thr = 0.5
    keep = _run_kernel(rotated_nms, boxes, scores, thr, valid)
    iou = riou.rotated_iou_bev_plain(boxes, boxes)
    want = nms_mask_from_iou(iou, scores, thr, valid=valid)
    pair = valid[:, :, None] & valid[:, None, :]
    near = (((iou - thr).abs() < IOU_TOL) & pair).flatten(1).any(1)
    same = (keep == want).all(1)
    print(f"rotated_iou kernel, rotated_nms: {int((~near).sum())} of 8 samples without a tie, "
          f"kept {int(keep.sum())} of {int(valid.sum())}")
    assert int((~near).sum()) >= 4
    assert bool(same[~near].all())
