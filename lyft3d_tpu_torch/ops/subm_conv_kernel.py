"""Fused rank gather + contraction of a sparse 3D conv (port of
``lyft3d_tpu/ops/subm_conv_kernel.py``).

``out[v] = Σ_k f_sorted[ranks[k, v]] @ weights[k]`` with rank −1 meaning an
absent neighbour: the (K, V, C) neighbour tensor of the gather + einsum
formulation is never written to device memory. :func:`subm_conv` is the
kernel wrapper and chooses its path by the device of the features alone:

- CUDA tensor: launches the hand-written kernel ``csrc/subm_conv.cu`` (built
  by ``nvcc`` at first use) or raises. There is no fallback.
- CPU tensor: runs the plain version, :func:`subm_conv_ref`.
- anything else: raises.

It replaces the Pallas TPU kernel ``_kernel`` behind ``subm_conv_pallas``,
without the ``tile``/``interpret`` arguments and with a leading batch
dimension where the JAX package ``vmap``s.

The gradient (:class:`SubmConv`; XLA code in the JAX package) has two sides,
each a hand-written kernel of the same source file on a CUDA tensor:
``dW[k] = Σ f_sorted[ranks[k]]ᵀ g`` (the tiles of ``csrc/wgrad_tile.cuh``:
tensor cores for bfloat16, which skip queries whose cotangent row is zero by a
flag a row; float32 FMAs for float32) and
``df[ranks[k, v]] += g[v] @ W[k]ᵀ`` (``subm_dgrad_kernel``, a scatter with
float32 atomics that holds for any rank table). On a CPU tensor both come
from :func:`subm_conv_bwd_ref`, the plain forward differentiated by autograd.
"""

from __future__ import annotations

import ctypes

import torch

from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops._wgrad import wgrad_buffers
from lyft3d_tpu_torch.ops.sparse_conv import take_rows

__all__ = [
    "subm_conv",
    "subm_conv_ref",
    "subm_conv_bwd_ref",
    "SubmConv",
    "KERNEL_LAUNCHES",
    "DGRAD_KERNEL_LAUNCHES",
    "WGRAD_KERNEL_LAUNCHES",
]

# Number of times subm_conv launched the CUDA kernel in this process.
KERNEL_LAUNCHES = 0
# Number of times its backward launched the feature-gradient kernel and the
# weight-gradient kernel.
DGRAD_KERNEL_LAUNCHES = 0
WGRAD_KERNEL_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

def subm_conv_ref(f_sorted, ranks, weights):
    """Plain version: gather by rank, zero the absent rows, one einsum in
    float32, cast back to the features' dtype."""
    v = f_sorted.shape[-2]
    k, q = ranks.shape[-2:]
    rows = take_rows(f_sorted, ranks.clamp(0, v - 1).reshape(*ranks.shape[:-2], k * q).long())
    rows = rows.reshape(*ranks.shape, f_sorted.shape[-1]).float()
    rows = rows * ((ranks >= 0) & (ranks < v))[..., None].float()
    out = torch.einsum("...kvc,kcd->...vd", rows, weights.to(f_sorted.dtype).float())
    return out.to(f_sorted.dtype)


def subm_conv_bwd_ref(f_sorted, ranks, weights, grad_out):
    """Plain backward: :func:`subm_conv_ref` differentiated by autograd.
    Returns ``(df, dW)`` in the dtypes of ``f_sorted`` and ``weights``."""
    with torch.enable_grad():
        f = f_sorted.detach().requires_grad_(True)
        w = weights.detach().requires_grad_(True)
        out = subm_conv_ref(f, ranks, w)
        return torch.autograd.grad(out, (f, w), grad_out)


def _check_args(f_sorted, ranks, weights):
    if f_sorted.dtype not in _DTYPE_CODES:
        raise TypeError(f"f_sorted must be float32 or bfloat16, got {f_sorted.dtype}")
    if ranks.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ranks must be int32 or int64, got {ranks.dtype}")
    if f_sorted.dim() not in (2, 3) or ranks.dim() != f_sorted.dim() or weights.dim() != 3:
        raise ValueError(
            f"f_sorted (…, V, C), ranks (…, K, Q) and weights (K, C, Cout) expected, got "
            f"{tuple(f_sorted.shape)}, {tuple(ranks.shape)}, {tuple(weights.shape)}"
        )
    if ranks.shape[:-2] != f_sorted.shape[:-2]:
        raise ValueError(f"batch of ranks {tuple(ranks.shape)} and f_sorted {tuple(f_sorted.shape)} differ")
    if weights.shape[0] != ranks.shape[-2] or weights.shape[1] != f_sorted.shape[-1]:
        raise ValueError(
            f"weights {tuple(weights.shape)} do not fit ranks {tuple(ranks.shape)} and "
            f"f_sorted {tuple(f_sorted.shape)}"
        )
    if not (ranks.device == weights.device == f_sorted.device):
        raise ValueError(
            f"f_sorted on {f_sorted.device}, ranks on {ranks.device}, weights on {weights.device}"
        )


_P, _I = ctypes.c_void_p, ctypes.c_int
# The launch functions of csrc/subm_conv.cu; the last argument is the stream.
_SIGNATURES = {
    "subm_conv_launch": [_P] * 4 + [_I] * 8,
    "subm_dgrad_launch": [_P] * 4 + [_I] * 8,
    "subm_wgrad_launch": [_P] * 6 + [_I] * 9,
}


def _kernel_library(entry: str = "subm_conv_launch"):
    lib = _build.load_library("subm_conv")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[entry] + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check_not_empty(**sizes):
    """The kernels take no empty shape (nothing would be launched)."""
    if min(sizes.values()) < 1:
        raise ValueError("the rank gather kernels take no empty shape on a CUDA tensor, got "
                         + ", ".join(f"{k} = {v}" for k, v in sizes.items()))


def _subm_conv_cuda(f_sorted, ranks, weights):
    """Launch ``csrc/subm_conv.cu`` on PyTorch's current stream."""
    global KERNEL_LAUNCHES
    batched = f_sorted.dim() == 3
    feats = (f_sorted if batched else f_sorted[None]).contiguous()
    rk = (ranks if batched else ranks[None]).to(torch.int32).contiguous()
    w = weights.to(feats.dtype).contiguous()
    b, vs, c = feats.shape
    k, vq = rk.shape[1:]
    cout = w.shape[-1]
    _check_not_empty(b=b, vs=vs, vq=vq, k=k, c=c, cout=cout)
    out = torch.empty((b, vq, cout), dtype=feats.dtype, device=feats.device)
    launch = _kernel_library()
    dev = feats.device.index if feats.device.index is not None else torch.cuda.current_device()
    err = launch(
        ctypes.c_void_p(feats.data_ptr()), ctypes.c_void_p(rk.data_ptr()),
        ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, vs, vq, k, c, cout, _DTYPE_CODES[feats.dtype], dev,
        ctypes.c_void_p(torch.cuda.current_stream(feats.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"subm_conv kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out if batched else out[0]


def _subm_bwd_cuda(entry: str, *args):
    """Call a backward launch function: tensors become pointers (``None`` a
    null pointer), ints stay; the device and current stream of the first
    tensor are appended."""
    launch = _kernel_library(entry)
    a = args[0]
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    values = [ctypes.c_void_p(t.data_ptr()) if isinstance(t, torch.Tensor)
              else (ctypes.c_void_p(None) if t is None else t) for t in args]
    err = launch(*values, dev, ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")


def _subm_conv_bwd_cuda(f_sorted, ranks, weights, grad_out, need_df: bool, need_dw: bool):
    """Launch the backward kernels of ``csrc/subm_conv.cu`` on PyTorch's
    current stream; ``weights`` already in the features' dtype."""
    global DGRAD_KERNEL_LAUNCHES, WGRAD_KERNEL_LAUNCHES
    batched = f_sorted.dim() == 3
    feats = (f_sorted if batched else f_sorted[None]).contiguous()
    rk = (ranks if batched else ranks[None]).to(torch.int32).contiguous()
    g = (grad_out if batched else grad_out[None]).to(feats.dtype).contiguous()
    w = weights.contiguous()
    b, vs, c = feats.shape
    k, vq = rk.shape[1:]
    cout = w.shape[-1]
    _check_not_empty(b=b, vs=vs, vq=vq, k=k, c=c, cout=cout)
    dims = (b, vs, vq, k, c, cout, _DTYPE_CODES[feats.dtype])
    df = dw = None
    if need_df:
        df = torch.zeros((b, vs, c), dtype=torch.float32, device=feats.device)
        _subm_bwd_cuda("subm_dgrad_launch", g, rk, w, df, *dims)
        DGRAD_KERNEL_LAUNCHES += 1
        df = (df if batched else df[0]).to(f_sorted.dtype)
    if need_dw:
        dw, queues, tiles = wgrad_buffers(k, c, cout, feats.device)
        flags = None
        if feats.dtype == torch.bfloat16:
            # The tensor-core tile reads 16-byte vectors where rows allow it,
            # and drops queries whose cotangent row is zero by a flag a row.
            if feats.data_ptr() % 16:
                feats = feats.clone()
            flags = torch.empty((b, vq), dtype=torch.uint8, device=feats.device)
        _subm_bwd_cuda("subm_wgrad_launch", feats, rk, g, flags, dw, queues, tiles, *dims)
        WGRAD_KERNEL_LAUNCHES += 1
        dw = dw.to(weights.dtype)
    return df, dw


class SubmConv(torch.autograd.Function):
    """The rank gather-GEMM with its gradient; ``weights`` in the features'
    dtype. Forward and backward each take the CUDA kernels for a CUDA tensor
    and the plain version for a CPU tensor."""

    @staticmethod
    def forward(ctx, f_sorted, ranks, weights):
        ctx.save_for_backward(f_sorted, ranks, weights)
        if f_sorted.device.type == "cuda":
            return _subm_conv_cuda(f_sorted, ranks, weights)
        return subm_conv_ref(f_sorted, ranks, weights)

    @staticmethod
    def backward(ctx, grad_out):
        f_sorted, ranks, weights = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        need_df, _, need_dw = ctx.needs_input_grad
        if grad_out.device.type == "cuda":
            df, dw = _subm_conv_bwd_cuda(f_sorted, ranks, weights, grad_out, need_df, need_dw)
        else:
            df, dw = subm_conv_bwd_ref(f_sorted, ranks, weights, grad_out)
        return (df if need_df else None), None, (dw if need_dw else None)


def subm_conv(f_sorted, ranks, weights):
    """``out[…, v] = Σ_k f_sorted[…, ranks[…, k, v]] @ weights[k]``, absent (−1)
    rows zero.

    ``f_sorted`` ``(…, V, C)`` features in sorted-id order (``build_hash``'s
    permutation applied), float32 or bfloat16; ``ranks`` ``(…, K, Q)`` integer
    sorted-order ranks (``subm_neighbors``); ``weights`` ``(K, C, Cout)``, cast
    to the features' dtype. Returns ``(…, Q, Cout)`` in that dtype, summed in
    float32: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error otherwise. Differentiable with respect to ``f_sorted``
    and ``weights`` (:class:`SubmConv`).
    """
    kind = f_sorted.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"subm_conv runs on cuda or cpu tensors, not {kind!r}")
    _check_args(f_sorted, ranks, weights)
    return SubmConv.apply(f_sorted, ranks, weights.to(f_sorted.dtype))
