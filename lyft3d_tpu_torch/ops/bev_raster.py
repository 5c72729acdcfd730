"""Lidar → BEV voxel-count raster (port of ``lyft3d_tpu/ops/bev_raster.py``).

:func:`bev_rasterize` is the kernel wrapper. It chooses its path by the
device of the points alone:

- CUDA tensor: launches the hand-written kernel of ``csrc/bev_raster.cu``
  (built by ``nvcc`` at first use), global atomics into a grid zeroed chunk
  by chunk, in chunks of samples that the shape rule :func:`_raster_chunk`
  picks. A launch the card refuses raises. There is no fallback.
- CPU tensor: runs the plain version, :func:`bev_rasterize_scatter`.
- anything else: raises.

The JAX package's matmul / sort / Pallas formulations and their dispatch
exist for the TPU's MXU and slow scatters; on a GPU the raster is one scatter
of ones, so they are not ported. ``rasterize_boxes_bev`` makes training
targets only and comes with the training port.

Points keep the JAX layout: ``(N, ≥3)`` for one sweep or ``(B, N, ≥3)`` for a
batch (``vmap`` becomes the leading dimension), float32, with a bool valid
mask of the same leading shape.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lyft3d_tpu_torch import _build

__all__ = [
    "voxel_indices",
    "bev_rasterize_scatter",
    "bev_rasterize",
    "normalize_bev",
    "KERNEL_LAUNCHES",
]

# Lyft BEV defaults (same as the JAX package).
DEFAULT_SHAPE = (336, 336, 3)
DEFAULT_VOXEL_SIZE = (0.4, 0.4, 1.5)
DEFAULT_Z_OFFSET = -2.0
MAX_INTENSITY = 16.0

# The raster kernel's rule (csrc/bev_raster.cu, `_raster_chunk`).
RASTER_CHUNK_BYTES = 32 << 20  # float32 grid of one chunk, at most, where the points reach it all
RASTER_MAX_POINTS = 1 << 24  # float32 counts are exact below this many points a sample

# Number of times bev_rasterize launched the CUDA kernel in this process.
KERNEL_LAUNCHES = 0


def voxel_indices(points, shape, voxel_size, z_offset):
    """Points ``(..., ≥3)`` → (row, col, ch) int32 voxel indices + in-bounds mask.

    Same float32 arithmetic as the JAX version: ``floor(x / vx + w / 2)``,
    ``floor(y / vy + h / 2)``, ``floor((z - z_offset) / vz)``. The voxel size
    is a tensor on the points' device so that the division is a true IEEE
    division on every device (PyTorch's CUDA division by a host scalar
    multiplies by the reciprocal, which moves points on bin edges). Bounds
    are tested before the integer conversion; indices of out-of-bounds points
    are 0.
    """
    h, w, c = shape
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    fcol = torch.floor(points[..., 0] / vsize[0] + w / 2.0)
    frow = torch.floor(points[..., 1] / vsize[1] + h / 2.0)
    fch = torch.floor((points[..., 2] - z_offset) / vsize[2])
    inb = (fcol >= 0) & (fcol < w) & (frow >= 0) & (frow < h) & (fch >= 0) & (fch < c)

    def to_index(f):
        return torch.where(inb, f, 0.0).to(torch.int32)

    return to_index(frow), to_index(fcol), to_index(fch), inb


def bev_rasterize_scatter(
    points,
    valid,
    shape: Tuple[int, int, int] = DEFAULT_SHAPE,
    voxel_size=DEFAULT_VOXEL_SIZE,
    z_offset: float = DEFAULT_Z_OFFSET,
):
    """Plain version: scatter-add of ones → ``(…, H, W, C)`` float32 counts.

    Dropped points (invalid or out of bounds) are added to one extra dump
    cell that is cut off at the end, as the JAX version's ``mode="drop"``.
    """
    h, w, c = shape
    lead = points.shape[:-1]
    pts = points.reshape(-1, lead[-1], points.shape[-1])
    ok = valid.reshape(-1, lead[-1])
    b = pts.shape[0]
    ncell = h * w * c
    row, col, ch, inb = voxel_indices(pts, shape, voxel_size, z_offset)
    ok = inb & ok
    sample = torch.arange(b, device=pts.device, dtype=torch.int64)[:, None]
    flat = sample * ncell + ((row.long() * w + col) * c + ch)
    flat = torch.where(ok, flat, b * ncell)
    counts = torch.zeros(b * ncell + 1, dtype=torch.float32, device=pts.device)
    counts.index_put_(
        (flat.reshape(-1),),
        torch.ones(flat.numel(), dtype=torch.float32, device=pts.device),
        accumulate=True,
    )
    return counts[:-1].reshape(*lead[:-1], h, w, c)


def _check_args(points, valid):
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if points.dim() not in (2, 3) or points.shape[-1] < 3:
        raise ValueError(f"points must be (N, >=3) or (B, N, >=3), got {tuple(points.shape)}")
    if tuple(valid.shape) != tuple(points.shape[:-1]):
        raise ValueError(
            f"valid {tuple(valid.shape)} must match points {tuple(points.shape[:-1])}"
        )
    if valid.device != points.device:
        raise ValueError(f"points on {points.device} but valid on {valid.device}")
    if not (points.is_contiguous() and valid.is_contiguous()):
        raise ValueError("points and valid must be contiguous")


def _kernel_library():
    lib = _build.load_library("bev_raster")
    fn = lib.bev_raster_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # points, valid, grid
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # batch, n, stride
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, c
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,  # chunk, device, stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _raster_chunk(batch: int, n: int, shape: Tuple[int, int, int]) -> int:
    """The one rule of the raster launch, from the shapes alone: samples a
    chunk, each chunk's grid zeroed just before its kernel. Where ``n``
    points a sample can reach every 32-byte sector of the grid (``H·W·C ≤
    8n``), the chunks are as few as keep each chunk's float32 grid within
    :data:`RASTER_CHUNK_BYTES`, and of equal size; a grid with more sectors
    than points is one chunk. On an H100 (PERF.md §6, time queued on the
    card): 32 samples of 336 × 336 × 3 in two chunks beat one launch on a
    uniform and on a LiDAR-like sweep, 24 samples in one launch beat two on
    the LiDAR-like one, and 1,024 × 1,024 × 3 grids, whose sectors the points
    barely reach, run fastest in one launch at 4 to 32 samples."""
    h, w, c = shape
    cells = h * w * c
    if cells > 8 * n:
        return max(1, batch)
    most = max(1, RASTER_CHUNK_BYTES // (4 * cells))
    chunks = max(1, -(-batch // most))
    return max(1, -(-batch // chunks))


def _bev_rasterize_cuda(points, valid, shape, voxel_size, z_offset, chunk=None):
    """Launch ``csrc/bev_raster.cu`` on PyTorch's current stream, in chunks
    of :func:`_raster_chunk` samples, or of ``chunk`` where it is given."""
    global KERNEL_LAUNCHES
    _check_args(points, valid)
    launch = _kernel_library()
    h, w, c = shape
    batched = points.dim() == 3
    b = points.shape[0] if batched else 1
    n = points.shape[-2]
    if n >= RASTER_MAX_POINTS:
        raise ValueError(f"bev_rasterize: float32 counts are exact below {RASTER_MAX_POINTS} "
                         f"points a sample, got {n}")
    chunk = _raster_chunk(b, n, shape) if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"bev_rasterize: a chunk holds at least one sample, got {chunk}")
    grid = torch.empty((b, h, w, c), dtype=torch.float32, device=points.device)
    vx, vy, vz = (float(v) for v in voxel_size)
    err = launch(
        ctypes.c_void_p(points.data_ptr()),
        ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(grid.data_ptr()),
        b, n, points.shape[-1], h, w, c, vx, vy, vz, float(z_offset), chunk,
        points.device.index if points.device.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(torch.cuda.current_stream(points.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"bev_raster kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return grid if batched else grid[0]


def bev_rasterize(
    points,
    valid,
    shape: Tuple[int, int, int] = DEFAULT_SHAPE,
    voxel_size=DEFAULT_VOXEL_SIZE,
    z_offset: float = DEFAULT_Z_OFFSET,
):
    """Counts per BEV cell, ``(…, H, W, C)`` float32: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor, an error otherwise."""
    kind = points.device.type
    if kind == "cuda":
        return _bev_rasterize_cuda(points, valid, shape, voxel_size, z_offset)
    if kind == "cpu":
        _check_args(points, valid)
        return bev_rasterize_scatter(points, valid, shape, voxel_size, z_offset)
    raise ValueError(f"bev_rasterize runs on cuda or cpu tensors, not {kind!r}")


def normalize_bev(counts, max_intensity: float = MAX_INTENSITY):
    """Counts → [0, 1] intensities."""
    return torch.clamp(counts / max_intensity, 0.0, 1.0)
