"""The BEV raster (B1) in ``lyft3d_tpu_torch``, on the CPU: the chunk rule
as a pure function of the shapes, and an emulation of ``csrc/bev_raster.cu``'s
launch (per chunk of samples a memset of the chunk's grid, then one atomic
add a valid point into it, the grid handed over unzeroed), held
``torch.equal`` to the plain version and to the JAX package's scatter,
bin-edge points included.

The kernel itself runs only on a card (``chip_smoke.py`` phase 3 and the
``cuda`` case below).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import bev_raster as jr
from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops import bev_raster as tr

SHAPE = tr.DEFAULT_SHAPE
VOXEL = tr.DEFAULT_VOXEL_SIZE
Z_OFF = tr.DEFAULT_Z_OFFSET


def emulate_chunks(points, valid, shape, chunk):
    """The launch on ``(B, N, ≥3)`` points: for each chunk of ``chunk``
    samples (the last may be short), its grid zeroed, then thread i of the
    chunk's kernel adds 1 into sample ``i // N`` of the chunk at its point's
    cell. The grid starts as NaN (the wrapper's is not zeroed), so a cell no
    memset reaches shows."""
    h, w, c = shape
    b, n, _ = points.shape
    cells = h * w * c
    row, col, ch, inb = tr.voxel_indices(points, shape, VOXEL, Z_OFF)
    cell = torch.where(inb & valid, (row.long() * w + col) * c + ch, -1).reshape(-1)
    grid = torch.full((b * cells,), float("nan"))
    for first in range(0, b, chunk):
        samples = min(chunk, b - first)
        span = slice(first * cells, (first + samples) * cells)
        assert bool(torch.isnan(grid[span]).all())  # each cell zeroed once
        grid[span] = 0.0
        i = torch.arange(samples * n)
        keys = cell[first * n + i]
        ok = keys >= 0
        flat = (first + i[ok] // n) * cells + keys[ok]
        grid.index_put_((flat,), torch.ones(flat.numel()), accumulate=True)
    return grid.reshape(b, h, w, c)

def uniform_cloud(b, n, seed, extent=70.0):
    rng = np.random.RandomState(seed)
    pts = np.empty((b, n, 3), np.float32)
    pts[..., :2] = rng.uniform(-extent, extent, (b, n, 2))
    pts[..., 2] = rng.uniform(-3.5, 3.5, (b, n))
    return pts, rng.rand(b, n) > 0.1


def edge_cloud(b, seed):
    """Points on the x, y and z bin edges and one float32 step to either side."""
    xs = (np.arange(0, 337, dtype=np.float64) * 0.4 - 67.2).astype(np.float32)
    zs = (np.arange(0, 4) * 1.5 + Z_OFF).astype(np.float32)
    xs = np.concatenate([xs, np.nextafter(xs, -np.inf), np.nextafter(xs, np.inf)])
    zs = np.concatenate([zs, np.nextafter(zs, -np.inf), np.nextafter(zs, np.inf)])
    rng = np.random.RandomState(seed)
    pts = np.stack([np.stack([rng.permutation(xs), rng.permutation(xs), rng.choice(zs, xs.size)], -1)
                    for _ in range(b)]).astype(np.float32)
    return pts, np.ones((b, xs.size), bool)


def hot_cloud(b, n, seed):
    """A sensor's sweep: most points in a few cells near the origin (many
    lanes of a warp on one cell), the rest spread out."""
    rng = np.random.RandomState(seed)
    pts = np.empty((b, n, 3), np.float32)
    hot = rng.rand(b, n) < 0.7
    pts[..., :2] = np.where(hot[..., None], rng.uniform(-0.6, 0.6, (b, n, 2)),
                            rng.uniform(-60, 60, (b, n, 2)))
    pts[..., 2] = np.where(hot, -1.7, rng.uniform(-2, 2.4, (b, n)))
    return pts, rng.rand(b, n) > 0.05


CLOUDS = {"uniform": lambda b: uniform_cloud(b, 3000, 1), "edges": lambda b: edge_cloud(b, 2),
          "hot": lambda b: hot_cloud(b, 2000, 3)}


@pytest.mark.parametrize("shape,batch,chunk", [(SHAPE, 2, 1), (SHAPE, 3, 2), ((337, 333, 3), 3, 2),
                                               ((337, 333, 3), 3, 3), ((40, 24, 5), 5, 2), ((9, 7, 2), 4, 3)],
                         ids=["336-b2-c1", "336-b3-c2", "337x333-b3-c2", "337x333-b3-c3", "40x24x5-b5-c2",
                              "9x7x2-b4-c3"])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_chunk_emulation_equals_plain_and_jax(cloud, shape, batch, chunk):
    pts, valid = CLOUDS[cloud](batch)
    got = emulate_chunks(torch.from_numpy(pts), torch.from_numpy(valid), shape, chunk)
    want = tr.bev_rasterize_scatter(torch.from_numpy(pts), torch.from_numpy(valid), shape)
    assert torch.equal(got, want)
    for s in range(len(pts)):
        j = jr.bev_rasterize_scatter(jnp.asarray(pts[s]), jnp.asarray(valid[s]), shape)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(j))
    if cloud == "edges" and shape == SHAPE:
        assert float(want.sum()) > 0.5 * valid.sum()


@pytest.mark.parametrize("batch,n,shape,chunk", [
    (32, 65536, SHAPE, 16), (24, 65536, SHAPE, 24), (16, 65536, SHAPE, 16), (8, 65536, SHAPE, 8),
    (1, 65536, SHAPE, 1), (33, 65536, SHAPE, 17), (48, 65536, SHAPE, 24),
    (32, 65536, (337, 333, 3), 16), (32, 65536, (1024, 1024, 3), 32), (4, 65536, (1024, 1024, 3), 4),
    (0, 65536, SHAPE, 1), (128, 65536, (4096, 16, 3), 32),
])
def test_chunk_rule(batch, n, shape, chunk):
    assert tr._raster_chunk(batch, n, shape) == chunk


def test_chunk_rule_keeps_chunks_equal_and_within_bytes():
    """Chunks differ by less than one sample in size, and they are the
    fewest whose grids stay within RASTER_CHUNK_BYTES wherever one sample's
    does and the points reach every sector; else the batch is one chunk."""
    for shape in (SHAPE, (337, 333, 3), (200, 200, 4), (1024, 1024, 3)):
        nbytes = 4 * shape[0] * shape[1] * shape[2]
        for batch in range(1, 101):
            chunk = tr._raster_chunk(batch, 65536, shape)
            chunks = -(-batch // chunk)
            assert chunks * chunk - batch < chunks
            if shape[0] * shape[1] * shape[2] > 8 * 65536:
                assert chunk == batch
            else:
                assert chunk * nbytes <= max(tr.RASTER_CHUNK_BYTES, nbytes)
                # no fewer chunks would keep within the bytes
                assert (chunks - 1) * max(1, tr.RASTER_CHUNK_BYTES // nbytes) < batch


class _Launch:
    """A stand-in for the kernel library that records the launch arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_wrapper_takes_the_rule_and_refuses_what_the_kernel_cannot_count(monkeypatch):
    """The wrapper launches with the rule's chunk or the one it is given,
    refuses an empty chunk and a cloud past exact float32 counts, and counts
    only launches."""
    pts = torch.zeros(2, 8, 3)
    valid = torch.ones(2, 8, dtype=torch.bool)
    launch = _Launch()
    monkeypatch.setattr(tr, "_kernel_library", lambda: launch)
    monkeypatch.setattr(tr.torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(tr.torch.cuda, "current_device", lambda: 0)
    before = tr.KERNEL_LAUNCHES
    tr._bev_rasterize_cuda(torch.zeros(32, 8, 3), torch.ones(32, 8, dtype=torch.bool), SHAPE, VOXEL, Z_OFF)
    assert launch.calls[-1][13] == tr._raster_chunk(32, 8, SHAPE) == 32
    tr._bev_rasterize_cuda(pts, valid, SHAPE, VOXEL, Z_OFF, chunk=1)
    assert launch.calls[-1][13] == 1 and tr.KERNEL_LAUNCHES == before + 2
    with pytest.raises(ValueError, match="at least one sample"):
        tr._bev_rasterize_cuda(pts, valid, SHAPE, VOXEL, Z_OFF, chunk=0)
    monkeypatch.setattr(tr, "RASTER_MAX_POINTS", 8)
    with pytest.raises(ValueError, match="exact below 8 points"):
        tr._bev_rasterize_cuda(pts, valid, SHAPE, VOXEL, Z_OFF)
    assert len(launch.calls) == 2 and tr.KERNEL_LAUNCHES == before + 2


def test_cuda_path_propagates_loader_errors(monkeypatch):
    """With the kernel library failing to build, the wrapper raises and
    returns no plain result."""
    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    monkeypatch.setattr(tr, "bev_rasterize_scatter", lambda *a, **k: pytest.fail("fell back"))
    before = tr.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="cannot build bev_raster"):
        tr._bev_rasterize_cuda(torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=torch.bool),
                               SHAPE, VOXEL, Z_OFF)
    assert tr.KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_chunks_on_card_match_plain():
    """On a machine with a card: the rule's chunk and chunks of 1, 2 and 3
    samples, equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full check")
    for cloud in sorted(CLOUDS):
        pts, valid = (torch.from_numpy(a).cuda() for a in CLOUDS[cloud](3))
        for shape in (SHAPE, (337, 333, 3), (1024, 1024, 3), (9, 7, 2)):
            want = tr.bev_rasterize_scatter(pts, valid, shape)
            assert torch.equal(tr.bev_rasterize(pts, valid, shape), want)
            for chunk in (1, 2, 3):
                got = tr._bev_rasterize_cuda(pts, valid, shape, VOXEL, Z_OFF, chunk=chunk)
                assert torch.equal(got, want), (cloud, shape, chunk)
