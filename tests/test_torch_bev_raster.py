"""Port parity: ``lyft3d_tpu_torch.ops.bev_raster`` on the CPU (its plain
version, which the CUDA kernel is held to on the card) against the JAX
scatter formulation and the interpret-mode Pallas kernel.

Counts are integers, so every comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lyft3d_tpu.ops import bev_raster as jr
from lyft3d_tpu_torch.ops import bev_raster as tr

SHAPE = tr.DEFAULT_SHAPE  # 336 x 336 x 3
VOXEL = tr.DEFAULT_VOXEL_SIZE
Z_OFF = tr.DEFAULT_Z_OFFSET


def cloud(seed, n=6000):
    """Uniform points, some out of range in every axis, 10% invalid."""
    rng = np.random.RandomState(seed)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-80, 80, n)
    pts[:, 1] = rng.uniform(-80, 80, n)
    pts[:, 2] = rng.uniform(-3.5, 3.5, n)
    valid = rng.rand(n) > 0.1
    return pts, valid


def edge_points():
    """Points exactly on bin edges, x = k·0.4 − 67.2 (and y, z likewise),
    with their float32 neighbours on either side."""
    k = np.arange(0, 337, dtype=np.float64)
    xs = (k * 0.4 - 67.2).astype(np.float32)
    zs = (np.arange(0, 4) * 1.5 + Z_OFF).astype(np.float32)
    xs = np.concatenate([xs, np.nextafter(xs, -np.inf), np.nextafter(xs, np.inf)])
    zs = np.concatenate([zs, np.nextafter(zs, -np.inf), np.nextafter(zs, np.inf)])
    rng = np.random.RandomState(7)
    n = xs.size
    pts = np.stack([xs, rng.permutation(xs), rng.choice(zs, n)], axis=1).astype(np.float32)
    return pts, np.ones(n, bool)


def jax_scatter(pts, valid, shape=SHAPE):
    return np.asarray(jr.bev_rasterize_scatter(jnp.asarray(pts), jnp.asarray(valid), shape))


def port(pts, valid, shape=SHAPE):
    return tr.bev_rasterize(torch.from_numpy(pts), torch.from_numpy(valid), shape).numpy()


def test_voxel_indices_match_jax():
    pts, _ = cloud(0)
    jrow, jcol, jch, jinb = (np.asarray(a) for a in jr.voxel_indices(
        jnp.asarray(pts), SHAPE, VOXEL, Z_OFF))
    row, col, ch, inb = (a.numpy() for a in tr.voxel_indices(
        torch.from_numpy(pts), SHAPE, VOXEL, Z_OFF))
    np.testing.assert_array_equal(inb, jinb)
    for got, want in ((row, jrow), (col, jcol), (ch, jch)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got[inb], want[jinb])


def test_batch_of_two_matches_jax_scatter():
    clouds = [cloud(1), cloud(2)]
    pts = np.stack([c[0] for c in clouds])
    valid = np.stack([c[1] for c in clouds])
    got = port(pts, valid)
    assert got.shape == (2, *SHAPE) and got.dtype == np.float32
    for b in range(2):
        np.testing.assert_array_equal(got[b], jax_scatter(pts[b], valid[b]))
    # An unbatched call gives the same counts as its row of the batch.
    np.testing.assert_array_equal(port(pts[1], valid[1]), got[1])


def test_matches_interpret_mode_pallas_kernel():
    pts, valid = cloud(3, n=3000)
    edge_pts, edge_valid = edge_points()
    pts = np.concatenate([pts, edge_pts])
    valid = np.concatenate([valid, edge_valid])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jr.bev_rasterize_pallas(
            jnp.asarray(pts), jnp.asarray(valid), SHAPE, chunk=1024))
    np.testing.assert_array_equal(port(pts, valid), want)


def test_bin_edge_points_match_jax():
    pts, valid = edge_points()
    got = port(pts, valid)
    np.testing.assert_array_equal(got, jax_scatter(pts, valid))
    assert got.sum() > 0.5 * len(pts)  # most edge points land in the grid


def test_invalid_and_padding_points_dropped():
    pts, valid = cloud(4)
    base = port(pts, valid)
    pts2 = np.concatenate([pts, np.zeros((100, 3), np.float32)])
    valid2 = np.concatenate([valid, np.zeros(100, bool)])
    np.testing.assert_array_equal(port(pts2, valid2), base)
    assert port(pts, np.zeros_like(valid)).sum() == 0


def test_wider_point_rows():
    """(N, 4) rows (x, y, z, lag) raster the same as their first three columns."""
    pts, valid = cloud(5)
    wide = np.concatenate([pts, np.full((len(pts), 1), 9.0, np.float32)], axis=1)
    np.testing.assert_array_equal(port(wide, valid), port(pts, valid))


def test_normalize_bev_matches_jax():
    counts = port(*cloud(6)) + np.arange(SHAPE[2], dtype=np.float32) * 10
    np.testing.assert_array_equal(
        tr.normalize_bev(torch.from_numpy(counts)).numpy(),
        np.asarray(jr.normalize_bev(jnp.asarray(counts))),
    )


@pytest.mark.parametrize("bad", ["float64", "int_valid", "shape", "mismatch", "noncontig"])
def test_argument_checks(bad):
    pts = torch.zeros(8, 3)
    valid = torch.ones(8, dtype=torch.bool)
    if bad == "float64":
        pts = pts.double()
    elif bad == "int_valid":
        valid = valid.int()
    elif bad == "shape":
        pts = torch.zeros(8, 2)
    elif bad == "mismatch":
        valid = torch.ones(7, dtype=torch.bool)
    elif bad == "noncontig":
        pts = torch.zeros(8, 6)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        tr.bev_rasterize(pts, valid)
