"""The yardstick's arithmetic against hand counts at small shapes: the
least time, the sparse middle's useful pairs, the model's operations, and
the traffic generator's sizes and seeds."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import BENCH
from h100bench.counts import peaks, sparse_middle, voxelnet
from h100bench.reference import second as ref
from h100bench.reference.units import ColumnSet


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert peaks.bound(3.35e12, 0) == (1.0, "bytes")
    assert peaks.bound(0, 2 * 67e12) == (2.0, "operations")
    assert peaks.bound(3.35e9, 989e9, peak=peaks.BF16_PEAK) == (pytest.approx(1e-3), "bytes")


def test_fill_bound_counts_rows_read_and_written_once():
    ids = torch.tensor([[0, 2, 2, 9]])  # 9 is past num_rows = 4: not read
    s, which, share = peaks.fill_bound(ids, 4, c=8, size=2, backward=False)
    assert which == "bytes" and share == 0.75
    assert s == pytest.approx(((3 + 4) * 8 * 2 + 4 * 4) / peaks.HBM_RATE)
    s, _, _ = peaks.fill_bound(ids, 4, c=8, size=2, backward=True)  # distinct rows read: 0 and 2
    assert s == pytest.approx(((2 + 4) * 8 * 2 + 4 * 4) / peaks.HBM_RATE)


def _units(cells, nx, ny, nz, zs):
    """A one-sample unit set holding ``cells`` (x, y, z)."""
    ncs = nz // zs
    ids = sorted({(y * nx + x) * ncs + z // zs for x, y, z in cells})
    mask = torch.zeros(1, len(ids), zs, dtype=torch.bool)
    for x, y, z in cells:
        mask[0, ids.index((y * nx + x) * ncs + z // zs), z % zs] = True
    return ColumnSet(col_ids=torch.tensor([ids], dtype=torch.int32), valid=torch.ones(1, len(ids), dtype=torch.bool),
                     mask=mask, bev_shape=(nx * ncs, ny), nz=zs), ncs


def test_submanifold_pairs_by_hand():
    # Three cells in a row along x and one far away: the row's ends see one
    # neighbour and themselves, its middle two and itself, the far one itself.
    cells = [(1, 1, 1), (2, 1, 1), (3, 1, 1), (6, 6, 6)]
    cols, ncs = _units(cells, 8, 8, 8, 4)
    cfg = ref.config_from_experiment(dict(
        json.loads((BENCH / "configs" / "second_pillars_lyft9.json").read_text())["experiment"],
        point_cloud_range=[0, 0, 0, 0.8, 0.8, 0.8], voxel_size=[0.1, 0.1, 0.1], max_points_per_voxel=1,
        encoder="simple", middle="sparse_units", middle_z_slab=4))
    got = sparse_middle.layer_work([("subm", cols, cols, 4, 16)], cfg)[0]
    assert got["pairs"] == 2 + 3 + 2 + 1 and got["in_rows"] == 4 and got["out_rows"] == 4
    # Strided: output (1, 0, 0) reads inputs x in {1, 2, 3}, y in {-1, 0, 1}, z in {-1, 0, 1}.
    out, _ = _units([(1, 0, 0), (3, 3, 3)], 4, 4, 4, 2)
    got = sparse_middle.layer_work([("strided", cols, out, 16, 16)], cfg)[0]
    # (1, 0, 0) reads (1..3, 1, 1): three pairs; (3, 3, 3) reads (5..7, 5..7, 5..7): (6, 6, 6).
    assert got["pairs"] == 4 and got["out_rows"] == 2
    least = sparse_middle.layer_least_seconds(got)
    assert least == pytest.approx(max(2 * 4 * 256 / peaks.BF16_PEAK,
                                      2 * (4 * 16 + 2 * 16 + 27 * 256) / peaks.HBM_RATE))


def test_rpn_operations_by_hand():
    doc = json.loads((BENCH / "configs" / "second_pillars_lyft9.json").read_text())["experiment"]
    cfg = ref.config_from_experiment(dict(doc, rpn_layer_nums=[1], rpn_strides=[2], rpn_filters=[8],
                                          rpn_up_filters=[4], rpn_up_strides=[1]))
    # 4 x 4 input of 2 channels: a stride-2 conv to 2 x 2 x 8, one 8 -> 8 conv, a 1 x 1 to 4,
    # heads of 18 anchors x (7 + 1 + 2) on 2 x 2.
    macs = 4 * 9 * (2 * 8 + 8 * 8) + 4 * 8 * 4 + 4 * 4 * 18 * 10
    assert voxelnet.rpn_flops(cfg, 2, 4, 4) == 2 * macs


def test_pillar_encoder_operations_count_every_point_slot():
    doc = json.loads((BENCH / "configs" / "second_pillars_lyft9.json").read_text())["experiment"]
    cfg = ref.config_from_experiment(doc)
    nx, ny, _ = cfg.grid.grid_size
    assert voxelnet.forward_flops(cfg, 4, 10, []) - voxelnet.rpn_flops(cfg, 64, ny, nx) == 2 * 10 * 16 * 9 * 64


def test_traffic_is_fixed_in_size_and_set_by_the_seed():
    from h100bench import harness

    traffic = json.loads((BENCH / "traffic" / "lidar_gt_64x262k.json").read_text())
    traffic.update(batch=2, points=1000, pool=2)
    gen = harness.load_generator(traffic["generator"])
    anchors = [((1.9, 4.7, 1.7), -1.0)] * 9
    a = gen.make_pool(traffic, anchors, 2 ** 31 + 5, "cpu")
    b = gen.make_pool(traffic, anchors, 2 ** 31 + 5, "cpu")
    c = gen.make_pool(traffic, anchors, 12, "cpu")
    for x, y, z in zip(a, b, c):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert {k: v.shape for k, v in x.items()} == {k: v.shape for k, v in z.items()}
        assert not torch.equal(x["points"], z["points"])
        assert int(x["points_valid"].sum()) == 2 * (1000 - 50) and int(x["gt_valid"].sum()) == 2 * 32
    r = torch.linalg.vector_norm(a[0]["points"][..., :2], dim=-1)
    assert float(r.max()) < 45.0 and float((r < 10).float().mean()) > 0.3  # dense near the sensor


def test_greedy_nms_by_hand_and_its_near_ties():
    import numpy as np

    iou = np.array([[1.0, 0.6, 0.2, 0.0], [0.6, 1.0, 0.50005, 0.0], [0.2, 0.50005, 1.0, 0.7], [0.0, 0.0, 0.7, 1.0]])
    valid = np.array([True, True, True, False])
    keep, ties = ref.greedy_nms(iou, valid, 0.5, 1e-4)
    # 0 kept; 1 suppressed by 0; 2 overlaps only the suppressed 1: kept; 3 invalid.
    assert keep.tolist() == [True, False, True, False] and ties == 0
    iou[0, 2] = 0.50003  # now 2's fate rests on an IoU within 1e-4 of the threshold
    keep, ties = ref.greedy_nms(iou, valid, 0.5, 1e-4)
    assert keep.tolist() == [True, False, False, False] and ties == 1
    keep, _ = ref.greedy_nms(iou, valid, 0.5, 1e-4, prefer=[None, None, True, None])
    assert keep.tolist() == [True, False, True, False]
