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

On a CUDA tensor bfloat16 runs on the tensor cores (``conv_mma_kernel`` of
``csrc/conv_mma.cuh``, shared with the stencil; :func:`subm_mma_variant` says
what it is launched with) and float32 on float32 FMAs, the type of the 1e-5
gradient checks.

The gradient (:class:`SubmConv`; XLA code in the JAX package) has two sides,
each a hand-written kernel of the same source file on a CUDA tensor:
``dW[k] = Σ f_sorted[ranks[k]]ᵀ g`` (the tiles of ``csrc/wgrad_tile.cuh``:
tensor cores for bfloat16, which skip queries whose cotangent row is zero by a
flag a row; float32 FMAs for float32) and ``df[ranks[k, v]] += g[v] @ W[k]ᵀ``,
which on a submanifold table is the forward kernel again over the reverse
ranks (:func:`reverse_ranks`, :func:`subm_conv_dgrad`): no atomics, a fixed
sum order. On a CPU tensor both come from :func:`subm_conv_bwd_ref`, the
plain forward differentiated by autograd, which holds for any rank table.
"""

from __future__ import annotations

import ctypes

import torch

from lyft3d_tpu_torch import _build
from lyft3d_tpu_torch.ops._wgrad import wgrad_buffers
from lyft3d_tpu_torch.ops.column_sparse import _aligned, _scatter_dropping, _scratch
from lyft3d_tpu_torch.ops.sparse_conv import take_rows

__all__ = [
    "subm_conv",
    "subm_conv_ref",
    "subm_conv_bwd_ref",
    "subm_conv_dgrad",
    "subm_mma_variant",
    "reverse_ranks",
    "SubmConv",
    "KERNEL_LAUNCHES",
    "DGRAD_KERNEL_LAUNCHES",
    "WGRAD_KERNEL_LAUNCHES",
]

# Number of times subm_conv launched the CUDA kernel in this process.
KERNEL_LAUNCHES = 0
# Number of times its backward launched the kernel for the feature gradient
# (the forward kernel on the reverse ranks) and the weight-gradient kernel.
DGRAD_KERNEL_LAUNCHES = 0
WGRAD_KERNEL_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MMA_MAX_OFFSETS = 27  # csrc/subm_conv.cu kMaxOffsets
MMA_MAX_WIDTH = 256  # widest contraction and output of the tensor-core kernel


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


def subm_mma_variant(k: int, c: int, cout: int) -> dict:
    """What the bfloat16 route of ``csrc/subm_conv.cu`` is launched with for
    ``k`` offsets, ``c`` input and ``cout`` output channels: ``kp`` (``c``
    rounded up to 16: 16-byte row copies), ``slice`` (the contraction a
    pipeline stage holds, the largest of 64, 32 and 16 that divides ``kp``),
    ``n_pad`` (``cout`` rounded up to 16), the block's warps, queries, columns
    and stages, its dynamic shared memory (the ring, and the block's 27 x 128
    positions), and ``pad_rows``: whether the rows are first copied into
    zero-padded bfloat16 rows of ``kp`` (``c`` not a multiple of 16). Raises
    for shapes the kernel does not take."""
    if k < 1 or c < 1 or cout < 1:
        raise ValueError(f"the rank gather kernel needs k, c, cout ≥ 1, got {k}, {c}, {cout}")
    kp, n_pad = -(-c // 16) * 16, -(-cout // 16) * 16
    if k > MMA_MAX_OFFSETS or kp > MMA_MAX_WIDTH or n_pad > MMA_MAX_WIDTH:
        raise ValueError(
            f"the bfloat16 rank gather kernel takes up to {MMA_MAX_OFFSETS} offsets and "
            f"{MMA_MAX_WIDTH} channels in and out, got {k}, {c} and {cout}"
        )
    slice_ = next(w for w in (64, 32, 16) if kp % w == 0)
    wide = n_pad > 128
    stages = {64: (3, 2), 32: (4, 3), 16: (6, 4)}[slice_][wide]
    cols = next(w for w in (16, 32, 64, 128, 256) if n_pad <= w)
    # The ring of stages, and the block's positions kept behind it.
    smem = stages * (128 + cols) * (slice_ + 8) * 2 + MMA_MAX_OFFSETS * 128 * 4
    return dict(kp=kp, slice=slice_, n_pad=n_pad, warps=16 if wide else 8, queries=128, cols=cols,
                stages=stages, smem_bytes=smem, pad_rows=kp != c)


def reverse_ranks(ranks, vs: int):
    """The reverse of a submanifold rank table: ``ranks`` ``(…, K, Q)`` →
    ``(…, K, vs)`` int32 with ``rev[…, k, ranks[…, k, q]] = q``, −1 where no
    query reads source row ``v`` at offset ``k`` (a rank outside ``[0, vs)``
    is absent). One scatter through a buffer one longer.

    Contract: each (offset, source row) pair is read by at most one query.
    Every :func:`~lyft3d_tpu_torch.ops.sparse_conv.subm_neighbors` table meets
    it (coords are unique within a sample, so each offset is injective). A
    table that repeats a pair fails a gather-back check under
    ``torch._assert_async``: at once on a CPU tensor, as a device-side assert
    on a CUDA tensor (no host sync)."""
    if vs == 0:
        return torch.full((*ranks.shape[:-1], 0), -1, dtype=torch.int32, device=ranks.device)
    q = ranks.shape[-1]
    r = ranks.long()
    present = (r >= 0) & (r < vs)
    index = torch.where(present, r, vs)
    queries = torch.arange(q, dtype=torch.int32, device=ranks.device).expand(ranks.shape)
    rev = _scatter_dropping(vs, -1, index, queries)
    back = torch.gather(rev, -1, index.clamp(max=vs - 1))
    torch._assert_async(((back == queries) | ~present).all(),
                        "reverse_ranks: an (offset, source row) pair is read by more than one query")
    return rev.contiguous()


def subm_conv_dgrad(grad_out, ranks, weights, vs: int):
    """``df (…, vs, C)`` of :func:`subm_conv` for the cotangent ``grad_out``
    ``(…, Q, Cout)``: the forward over the reverse ranks with the weights
    transposed, ``df[u] = Σ_k g[rev[k, u]] @ W[k]ᵀ``, in ``grad_out``'s dtype
    (float32 sums rounded once). On a CUDA tensor one call of the forward's
    kernel, which builds the reverse table on the card and checks the
    contract of :func:`reverse_ranks` without a host sync; counted as a
    feature-gradient launch. On a CPU tensor :func:`reverse_ranks` and
    :func:`subm_conv_ref`."""
    wt = weights.transpose(-1, -2)
    if grad_out.device.type == "cuda":
        return _subm_conv_cuda(grad_out, ranks, wt, reverse_rows=vs)
    return subm_conv_ref(grad_out, reverse_ranks(ranks, vs), wt)


_P, _I = ctypes.c_void_p, ctypes.c_int
# The launch functions of csrc/subm_conv.cu; the last argument is the stream.
_SIGNATURES = {
    "subm_conv_launch": [_P] * 9 + [_I] * 11,
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


def _subm_conv_cuda(f_sorted, ranks, weights, out_dtype=None, reverse_rows=None):
    """Launch ``csrc/subm_conv.cu`` on PyTorch's current stream: the
    tensor-core route for bfloat16 (row padding where C is no multiple of 16,
    weight preparation and the kernel in one call), the FMA kernel for
    float32. The output is in the features' dtype; the bfloat16 route can
    also write its float32 sums unrounded (``out_dtype=torch.float32``, for
    checks at float32 precision).

    With ``reverse_rows`` V this is the feature gradient's launch, counted
    apart: ``ranks`` is the forward's table ``(…, K, rows of f_sorted)`` with
    values in ``[0, V)``, the call builds its reverse ``(…, K, V)`` on the
    card as the positions and writes V rows, and a table that reads an
    (offset, row) pair twice fails ``torch._assert_async`` (a device-side
    assert, no host sync)."""
    global KERNEL_LAUNCHES, DGRAD_KERNEL_LAUNCHES
    batched = f_sorted.dim() == 3
    feats = (f_sorted if batched else f_sorted[None]).contiguous()
    rk = (ranks if batched else ranks[None]).to(torch.int32).contiguous()
    w = weights.to(feats.dtype).contiguous()
    b, vs, c = feats.shape
    k, n = rk.shape[1:]
    vq = n if reverse_rows is None else reverse_rows
    cout = w.shape[-1]
    _check_not_empty(b=b, vs=vs, vq=vq, k=k, c=c, cout=cout)
    if reverse_rows is not None and n != vs:
        raise ValueError(f"the feature gradient's table reads {n} rows, the cotangent has {vs}")
    launch = _kernel_library()
    kp = n_pad = 0
    pad_rows = False
    if feats.dtype == torch.bfloat16:
        var = subm_mma_variant(k, c, cout)
        kp, n_pad, pad_rows = var["kp"], var["n_pad"], var["pad_rows"]
        feats = _aligned(feats)
    bf16 = feats.dtype == torch.bfloat16
    wt, wmask, rows, rev, bad = _scratch(
        feats.device, 2 * k * n_pad * kp if bf16 else 0, 4 * k * 16 if bf16 else 0,
        2 * b * vs * kp if pad_rows else 0, 4 * b * k * vq if reverse_rows is not None else 0,
        4 if reverse_rows is not None else 0)
    out_dtype = feats.dtype if out_dtype is None else out_dtype
    if feats.dtype == torch.float32 and out_dtype != torch.float32:
        raise ValueError("the float32 rank gather kernel writes float32")
    out = torch.empty((b, vq, cout), dtype=out_dtype, device=feats.device)
    dev = feats.device.index if feats.device.index is not None else torch.cuda.current_device()
    err = launch(
        *(ctypes.c_void_p(None if t is None else t.data_ptr())
          for t in (feats, rk, w, out, rows, wt, wmask, rev, bad)),
        b, vs, vq, k, c, cout, kp, n_pad, _DTYPE_CODES[feats.dtype], _DTYPE_CODES[out_dtype], dev,
        ctypes.c_void_p(torch.cuda.current_stream(feats.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"subm_conv kernel launch failed with CUDA error {err}")
    if reverse_rows is None:
        KERNEL_LAUNCHES += 1
    else:
        DGRAD_KERNEL_LAUNCHES += 1
        torch._assert_async(bad.view(torch.int32)[0] == 0,
                            "subm_conv backward: an (offset, source row) pair is read by more than one query")
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
    global WGRAD_KERNEL_LAUNCHES
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
        df = _subm_conv_cuda(g, rk, w.transpose(1, 2), reverse_rows=vs)
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
    and the plain version for a CPU tensor. On a CUDA tensor the backward's
    ``df`` holds the rank table to the contract of :func:`reverse_ranks` (at
    most one query for each offset and source row) and fails loudly on a
    table outside it; the CPU backward takes any table."""

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
    and ``weights`` (:class:`SubmConv`); on a CUDA tensor the gradient needs
    a table in which each (offset, source row) pair is read by at most one
    query, as every ``subm_neighbors`` table is (:func:`reverse_ranks`).
    """
    kind = f_sorted.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"subm_conv runs on cuda or cpu tensors, not {kind!r}")
    _check_args(f_sorted, ranks, weights)
    return SubmConv.apply(f_sorted, ranks, weights.to(f_sorted.dtype))
