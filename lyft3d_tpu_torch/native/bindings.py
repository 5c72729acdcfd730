"""ctypes bindings + lazy build of the native host runtime (loader.cpp).

Builds ``libl3dnative.so`` with g++ on first use into the port's build
directory (``build/lyft3d_tpu_torch/`` under the checkout, beside the CUDA
kernels; never next to the source); every entry point has a documented numpy
fallback so the framework runs without a toolchain. The library is compiled
to a private name and renamed into place, so that processes building at once
never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from lyft3d_tpu_torch._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "loader.cpp"
_SO = BUILD_DIR / "libl3dnative.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return ctypes.CDLL(str(_SO))
    tmp = _SO.parent / f".{_SO.name}.{os.getpid()}.{threading.get_ident()}"
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp), "-lpthread"],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
        return ctypes.CDLL(str(_SO))
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
        _build_failed = True
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.l3d_read_lidar.restype = ctypes.c_int64
                lib.l3d_read_lidar.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64,
                ]
                lib.l3d_transform_points.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_double),
                ]
                lib.l3d_load_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ]
                lib.l3d_bev_raster.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.POINTER(ctypes.c_float),
                ]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _get() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_lidar(path, max_points: int = 1 << 20) -> np.ndarray:
    """(N, 4) float32 [x, y, z, intensity] from a Lyft .bin."""
    lib = _get()
    if lib is None:  # numpy fallback, capped at max_points as the native read is
        raw = np.fromfile(str(path), np.float32)
        n = min(raw.size // 5, max_points)
        return raw[: n * 5].reshape(n, 5)[:, :4].copy()
    out = np.empty((max_points, 4), np.float32)
    n = lib.l3d_read_lidar(str(path).encode(), _fptr(out), max_points)
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n]


def transform_points(points: np.ndarray, tm: np.ndarray) -> np.ndarray:
    """In-place SE(3) transform of (N, ≥3) float32 points; returns them."""
    lib = _get()
    points = np.ascontiguousarray(points, np.float32)
    if lib is None:
        points[:, :3] = points[:, :3] @ tm[:3, :3].T.astype(np.float32) + tm[
            :3, 3
        ].astype(np.float32)
        return points
    tm64 = np.ascontiguousarray(tm, np.float64)
    lib.l3d_transform_points(
        _fptr(points), points.shape[0], points.shape[1],
        tm64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return points


def load_batch(paths: Sequence, transforms: np.ndarray, max_points: int,
               n_threads: int = 4):
    """Threaded read+transform of many sweeps → ((B, max_points, 4), (B,))."""
    lib = _get()
    b = len(paths)
    transforms = np.ascontiguousarray(transforms, np.float64).reshape(b, 4, 4)
    if lib is None:
        out = np.zeros((b, max_points, 4), np.float32)
        counts = np.zeros(b, np.int64)
        for i, p in enumerate(paths):
            pts = read_lidar(p, max_points)
            pts = transform_points(pts, transforms[i])
            counts[i] = len(pts)
            out[i, : len(pts)] = pts
        return out, counts
    out = np.zeros((b, max_points, 4), np.float32)
    counts = np.zeros(b, np.int64)
    arr = (ctypes.c_char_p * b)(*[str(p).encode() for p in paths])
    lib.l3d_load_batch(
        arr, b,
        transforms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _fptr(out), max_points,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads,
    )
    return out, counts


def bev_raster(points: np.ndarray, shape, voxel_size, z_offset: float) -> np.ndarray:
    """(H, W, C) float32 counts (native twin of ops.bev_raster)."""
    lib = _get()
    h, w, c = shape
    points = np.ascontiguousarray(points, np.float32)
    if lib is None:
        from lyft3d_tpu_torch.data.bev_dataset import numpy_bev_raster
        from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig

        cfg = BEVConfig(shape=tuple(shape), voxel_size=tuple(voxel_size),
                        z_offset=z_offset)
        return numpy_bev_raster(points, cfg) * 16.0
    grid = np.empty((h, w, c), np.float32)
    lib.l3d_bev_raster(
        _fptr(points), points.shape[0], points.shape[1],
        h, w, c, voxel_size[0], voxel_size[1], voxel_size[2], z_offset,
        _fptr(grid),
    )
    return grid
