"""Build the package's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface. On first use in a
process it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/lyft3d_tpu_torch/lib<name>.so`` under the checkout's root and loaded
with :mod:`ctypes`; wrappers pass pointers as ``c_void_p`` and PyTorch's
current stream. Nothing is compiled or loaded when a module is imported, so
the CPU-only install imports every module without ``nvcc`` or a GPU.

A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lyft3d_tpu_torch"
# No --use_fast_math: the raster's bin edges depend on IEEE division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# A shared library, once loaded, belongs to the whole process. One lock per
# library, so that different libraries build in parallel threads.
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build lyft3d_tpu_torch's kernels"
        )
    return path


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build_dir/lib<name>.so``; returns its path."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / f"lib{name}.so"
    # Compile to a private name, then rename: concurrent processes never
    # load a half-written library.
    tmp = build_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _current(out: Path) -> bool:
    """Whether ``out`` was built after the last change to any source of
    ``csrc/`` (a library and the headers it includes)."""
    if not out.exists():
        return False
    newest = max(f.stat().st_mtime for f in CSRC_DIR.iterdir() if f.suffix in (".cu", ".cuh"))
    return out.stat().st_mtime >= newest


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on the first call in this
    process unless ``BUILD_DIR`` holds one built from the current sources
    (the ranks of a data-parallel run load what their parent built)."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            out = BUILD_DIR / f"lib{name}.so"
            lib = ctypes.CDLL(str(out if _current(out) else build(name)))
            _LIBS[name] = lib
        return lib
