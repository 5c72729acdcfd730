"""Dense-canvas fill from (row-id, feature-row) pairs (port of
``lyft3d_tpu/ops/dense_fill.py``).

The PointPillars BEV scatter writes V feature rows into a large dense
canvas at their row ids. :func:`fill_rows_by_id` is the kernel wrapper. It
masks and (unless ``assume_sorted``) sorts the ids, then chooses its path by
the device of the features alone:

- CUDA tensor: launches the hand-written kernel ``csrc/dense_fill.cu``
  (built by ``nvcc`` at first use) or raises. There is no fallback.
- CPU tensor: runs the plain version, :func:`fill_rows_by_id_scatter`.
- anything else: raises.

Both sum duplicate ids, as the Pallas kernel does; under the producer
contract (unique ids) the canvas holds exact copies of the rows. Rows not
covered by a valid id are zero. The JAX package's sorted-hint scatter and
its ``method`` switch exist for the TPU and are not ported.

The gradient with respect to the features is a row gather of the canvas
cotangent, ``gf[i] = g[ids[i]]`` (zero for a dropped row; duplicate ids each
receive the row): :class:`FillRowsById` computes it with a kernel of the same
source file on a CUDA tensor, chosen by :func:`_fill_bwd_kernel` (rows of a
multiple of 16 bytes: ``fill_bwd_warp_kernel``; others:
``dense_fill_bwd_kernel``), and with the plain
:func:`fill_rows_by_id_bwd_ref` on a CPU tensor. The sort that
``fill_rows_by_id`` puts in front of the kernel is plain autograd.

Layout: ``(V, C)`` rows with ``(V,)`` ids and valid mask for one sample, or
``(B, V, C)`` with ``(B, V)`` for a batch (``vmap`` becomes the leading
dimension); the canvas is ``(…, num_rows, C)`` in the features' dtype,
contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from lyft3d_tpu_torch import _build

__all__ = [
    "fill_rows_by_id",
    "fill_rows_by_id_scatter",
    "fill_rows_by_id_bwd_ref",
    "FillRowsById",
    "KERNEL_LAUNCHES",
    "BWD_KERNEL_LAUNCHES",
]

# Number of times fill_rows_by_id launched the CUDA kernel in this process.
KERNEL_LAUNCHES = 0
# Number of times its backward launched the CUDA gather kernel.
BWD_KERNEL_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _masked_ids(row_ids, valid, num_rows: int):
    """int32 ids with invalid entries, and ids outside ``[0, num_rows)``,
    forced to the sentinel ``num_rows``."""
    ok = valid & (row_ids >= 0) & (row_ids < num_rows)
    return torch.where(ok, row_ids, num_rows).to(torch.int32)


def fill_rows_by_id_scatter(features, row_ids, valid, num_rows: int):
    """Plain version: ``index_add_`` into ``(B·(num_rows + 1), C)`` with one
    sentinel row per sample, cut off at the end. Duplicate ids sum."""
    lead = features.shape[:-1]
    c = features.shape[-1]
    feats = features.reshape(-1, lead[-1], c)
    ids = _masked_ids(row_ids, valid, num_rows).reshape(-1, lead[-1]).long()
    b = feats.shape[0]
    base = torch.arange(b, device=feats.device, dtype=torch.int64)[:, None] * (num_rows + 1)
    canvas = torch.zeros(b * (num_rows + 1), c, dtype=features.dtype, device=features.device)
    canvas.index_add_(0, (base + ids).reshape(-1), feats.reshape(-1, c))
    return canvas.view(b, num_rows + 1, c)[:, :num_rows].reshape(*lead[:-1], num_rows, c)


def fill_rows_by_id_bwd_ref(grad_canvas, ids, num_rows: int):
    """Plain backward: ``gf[…, i, :] = grad_canvas[…, ids[…, i], :]``, zero
    where the id is the sentinel ``num_rows``."""
    hit = (ids >= 0) & (ids < num_rows)
    index = ids.clamp(0, num_rows - 1).long()[..., None].expand(*ids.shape, grad_canvas.shape[-1])
    return torch.gather(grad_canvas, -2, index) * hit[..., None].to(grad_canvas.dtype)


def _check_args(features, row_ids, valid):
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if row_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"row_ids must be int32 or int64, got {row_ids.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if features.dim() not in (2, 3):
        raise ValueError(f"features must be (V, C) or (B, V, C), got {tuple(features.shape)}")
    lead = tuple(features.shape[:-1])
    if tuple(row_ids.shape) != lead or tuple(valid.shape) != lead:
        raise ValueError(
            f"row_ids {tuple(row_ids.shape)} and valid {tuple(valid.shape)} must be {lead}"
        )
    if not (row_ids.device == valid.device == features.device):
        raise ValueError(
            f"features on {features.device}, row_ids on {row_ids.device}, valid on {valid.device}"
        )


# Canvas bytes a forward tile owns: enough stores a block to hide its window
# search. Rows a tile: the power of two nearest below, in [128, 4096].
FILL_TILE_BYTES = 32 * 1024

_ARGTYPES = {
    "dense_fill_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feats, ids, out
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch, v, num_rows
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c, dtype, vec, tile_rows
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
    "dense_fill_bwd_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g, ids, gf
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch, v, num_rows
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c, dtype, route
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ],
}
# The backward's kernels, by the name ``_fill_bwd_cuda(..., kernel=)`` takes,
# and their routes in dense_fill_bwd_launch: "warp" (32 rows a warp, every
# load issued before a store) for rows of a multiple of 16 bytes, "lanes" (a
# row by a group of lanes, element by element) for the others.
_BWD_ROUTES = {"warp": 1, "lanes": 0}
FILL_BWD_KERNELS = tuple(_BWD_ROUTES)


def _kernel_library(entry: str = "dense_fill_launch"):
    lib = _build.load_library("dense_fill")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return fn


def _fill_tile_rows(row_bytes: int) -> int:
    """Canvas rows of a forward tile for rows of ``row_bytes``."""
    rows = 1 << max(0, (FILL_TILE_BYTES // row_bytes).bit_length() - 1)
    return min(4096, max(128, rows))


def _access_elems(c: int, size: int, *ptrs: int) -> int:
    """Elements of the widest access (16 bytes at most) that divides a row of
    ``c`` elements of ``size`` bytes and keeps every pointer aligned."""
    elems = 16 // size
    while elems > 1 and (c % elems or any(p % (elems * size) for p in ptrs)):
        elems //= 2
    return elems


def _fill_bwd_kernel(c: int, dtype, aligned: bool = True) -> str:
    """The rule: the warp kernel for rows of a multiple of 16 bytes on 16-byte
    aligned tensors, the lane kernel for every other row."""
    if aligned and (c * _ITEM_BYTES[dtype]) % 16 == 0:
        return "warp"
    return "lanes"


def _fill_cuda(features, ids, num_rows: int):
    """Launch ``csrc/dense_fill.cu`` on PyTorch's current stream. ``ids`` are
    int32, ascending per sample, with invalid entries at ``num_rows``."""
    global KERNEL_LAUNCHES
    launch = _kernel_library()
    batched = features.dim() == 3
    feats = (features if batched else features[None]).contiguous()
    ids = (ids if batched else ids[None]).contiguous()
    b, v, c = feats.shape
    out = torch.empty((b, num_rows, c), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out if batched else out[0]
    size = feats.element_size()
    vec = _access_elems(c, size, feats.data_ptr(), out.data_ptr())
    err = launch(
        feats.data_ptr(), ids.data_ptr(), out.data_ptr(), b, v, num_rows, c,
        _DTYPE_CODES[feats.dtype], vec, _fill_tile_rows(c * size), feats.device.index,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dense_fill kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out if batched else out[0]


def _fill_bwd_cuda(grad_canvas, ids, num_rows: int, kernel=None):
    """Launch the backward's kernel of ``csrc/dense_fill.cu`` on PyTorch's
    current stream: ``(…, num_rows, C)`` canvas cotangent → ``(…, V, C)``.
    ``kernel`` (one of :data:`FILL_BWD_KERNELS`) overrides the rule,
    :func:`_fill_bwd_kernel`; a kernel that cannot take the rows raises."""
    global BWD_KERNEL_LAUNCHES
    launch = _kernel_library("dense_fill_bwd_launch")
    batched = grad_canvas.dim() == 3
    g = (grad_canvas if batched else grad_canvas[None]).contiguous()
    ids = (ids if batched else ids[None]).contiguous()
    b, v = ids.shape
    c = g.shape[-1]
    out = torch.empty((b, v, c), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out if batched else out[0]
    row_bytes = c * g.element_size()
    aligned = g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    kernel = kernel or _fill_bwd_kernel(c, g.dtype, aligned)
    if kernel not in _BWD_ROUTES:
        raise ValueError(f"unknown fill backward kernel {kernel!r}; one of {FILL_BWD_KERNELS}")
    if kernel == "warp" and (row_bytes % 16 or not aligned):
        raise ValueError(f"the warp kernel takes 16-byte aligned rows of a multiple of 16 "
                         f"bytes, not {row_bytes}")
    err = launch(
        g.data_ptr(), ids.data_ptr(), out.data_ptr(), b, v, num_rows, c,
        _DTYPE_CODES[g.dtype], _BWD_ROUTES[kernel], g.device.index,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dense_fill backward kernel launch failed with CUDA error {err}")
    BWD_KERNEL_LAUNCHES += 1
    return out if batched else out[0]


class FillRowsById(torch.autograd.Function):
    """The fill on sorted, masked int32 ids (sentinel ``num_rows``) with its
    gradient: forward and backward each take the CUDA kernel for a CUDA
    tensor and the plain version for a CPU tensor."""

    @staticmethod
    def forward(ctx, features, ids, num_rows: int):
        ctx.save_for_backward(ids)
        ctx.num_rows = num_rows
        if features.device.type == "cuda":
            return _fill_cuda(features, ids, num_rows)
        return fill_rows_by_id_scatter(features, ids, ids < num_rows, num_rows)

    @staticmethod
    def backward(ctx, grad_canvas):
        (ids,) = ctx.saved_tensors
        grad_canvas = grad_canvas.contiguous()
        if grad_canvas.device.type == "cuda":
            return _fill_bwd_cuda(grad_canvas, ids, ctx.num_rows), None, None
        return fill_rows_by_id_bwd_ref(grad_canvas, ids, ctx.num_rows), None, None


def fill_rows_by_id(features, row_ids, valid, num_rows: int, assume_sorted: bool = False):
    """``(…, V, C)`` feature rows + ``(…, V)`` ``row_ids`` → ``(…, num_rows, C)``
    canvas: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error otherwise. Differentiable with respect to ``features``
    (:class:`FillRowsById`).

    Invalid entries are dropped. With ``assume_sorted`` the valid ids must
    ascend within each sample with the invalid entries at the tail (the
    ``voxelize`` contract); otherwise they are sorted here (stably) first.
    """
    kind = features.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"fill_rows_by_id runs on cuda or cpu tensors, not {kind!r}")
    _check_args(features, row_ids, valid)
    ids = _masked_ids(row_ids, valid, num_rows)
    if not assume_sorted:
        ids, order = torch.sort(ids, dim=-1, stable=True)
        features = torch.gather(features, -2, order[..., None].expand(features.shape))
    return FillRowsById.apply(features, ids, num_rows)
