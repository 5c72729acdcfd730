"""Data and tensor parallelism over the host's cards (port of
``lyft3d_tpu/parallel/mesh.py``: its ``data`` and ``model`` axes).

Under ``jax.jit`` over a batch sharded on the ``data`` axis, XLA computes the
function of the global batch: every reduction over the batch spans all
devices. Here one process runs a rank on each card (:func:`spawn`), each
rank holds its contiguous slice of the global batch (:func:`shard_batch`)
and the ranks meet in ``torch.distributed`` collectives: NCCL on the cards,
gloo on the CPU or where the caller asks for it by name. Nothing falls back:
a card run whose NCCL fails to initialise raises, and a rank that raises
takes the run down.

**The gradient rule.** Each rank's loss is a value whose mean over the ranks
is the global batch's loss, and the float32 gradients are averaged over the
ranks (:func:`all_reduce_gradients`: one flat bucket, summed, divided by the
rank count). A loss that is a mean over the batch, or over samples each
normalised on its own (SECOND's ``voxelnet_loss``, PointRCNN's ``rpn_loss``
and ``rcnn_loss``, which the JAX trainers ``vmap`` a frame at a time), is
such a value as it stands, because the ranks' shards are equal. A normaliser
that spans the batch is all-reduced before the division (the weighted
cross-entropy's ``Σ w``, :func:`~lyft3d_tpu_torch.train.losses.weighted_softmax_ce`),
and BatchNorm in train mode takes its statistics over the global batch
(:func:`all_reduce_sum` in its forward, whose backward all-reduces the
statistics' gradients). Metrics are averaged over the ranks
(:func:`average_metrics`).

With one rank nothing spawns and no process group exists: the trainers pass
``group=None`` and run the single-process path.

**The mesh.** :func:`make_mesh` describes a ``(data, model)`` layout of
ranks as the JAX ``make_mesh`` lays its devices out: rank ``r`` sits at
``divmod(r, M)``. ``spawn(..., model_parallel=M)`` gives each rank a
:class:`DataGroup` whose ``size`` and ``rank`` are its data axis (D ranks,
each with a shard of the batch) and whose ``model_size`` and ``model_rank``
are its model axis, with a process group for each: the ranks with the same
``m`` (the data group, over which everything above runs) and the ranks with
the same ``d`` (the model group, which only
:func:`~lyft3d_tpu_torch.parallel.tensor.tensor_parallel_params` uses). The
model ranks of one data index hold the same shard of the batch. With
``model_parallel=1`` the data group is the default process group and
nothing differs from a data-parallel run.

The JAX module's ``ensure_devices`` (which forces JAX's virtual CPU
platform) and ``data_parallel_sharding`` (pjit's in/out shardings) have no
meaning for ``torch.distributed`` and have no counterpart here.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lyft3d_tpu_torch.parallel.tensor import tensor_parallel_params

__all__ = [
    "DataGroup",
    "Mesh",
    "make_mesh",
    "make_data_mesh",
    "make_data_group",
    "rank_placement",
    "shard_batch",
    "replicate",
    "barrier",
    "ranks_agree",
    "all_reduce_sum",
    "all_reduce_gradients",
    "average_metrics",
    "sync_batch_norms",
    "reseed_for_rank",
    "make_train_step_dp",
    "bev_rasterize_point_sharded",
    "spawn",
    "tensor_parallel_params",
]


@dataclass(frozen=True)
class DataGroup:
    """This process's place in a run that :func:`spawn` started: ``size``
    data ranks, this one ``rank`` on the data axis, its ``device`` and the
    ``backend`` of the process groups. ``data_group`` is the process group of
    the data axis (``None``: the default group, as in a run without a model
    axis), over which every collective of this module runs;
    ``model_size``, ``model_rank`` and ``model_group`` are the model axis
    (one rank and no group without one). Code given ``group=None`` runs
    alone, with no collective."""

    size: int
    rank: int
    device: torch.device
    backend: str
    model_size: int = 1
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def world_rank(self) -> int:
        """The rank in the default process group: ``rank · model_size + model_rank``."""
        return self.rank * self.model_size + self.model_rank


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` layout of ranks: ``devices[d, m]`` is the rank at
    data index ``d`` and model index ``m``, row-major as the JAX ``make_mesh``
    reshapes its device list."""

    devices: np.ndarray
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _ranks_available(n_devices: Optional[int], device, what: str, backend: Optional[str] = None) -> int:
    """``n_devices``, or every card on ``device="cuda"`` (one rank on the
    CPU); more ranks than cards raise, unless gloo ranks share one card
    (``backend="gloo"``)."""
    if torch.device(device).type != "cuda":
        return n_devices or 1
    if backend == "gloo":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: no CUDA device found")
        return n_devices or 1
    cards = torch.cuda.device_count()
    avail = n_devices or cards
    if avail < 1:
        raise RuntimeError(f"{what}: no CUDA device found")
    if avail > cards:
        raise ValueError(f"{what}: {avail} ranks asked for, {cards} cards found")
    return avail


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device="cuda") -> Mesh:
    """The ``(data, model)`` layout of ``n_devices`` ranks (every card on
    ``device="cuda"`` where not given, one rank on the CPU):
    ``shape == {"data": n // model_parallel, "model": model_parallel}``."""
    n = _ranks_available(n_devices, device, "make_mesh")
    if n % model_parallel:
        raise ValueError(f"make_mesh: {n} ranks do not split into model groups of {model_parallel}")
    return Mesh(np.arange(n).reshape(n // model_parallel, model_parallel))


def make_data_mesh(batch_size: int, n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The largest data-only mesh whose size divides ``batch_size``
    (:func:`make_data_group`'s rank count)."""
    return make_mesh(make_data_group(batch_size, n_devices, device), device=device)


def make_data_group(batch_size: int, n_devices: Optional[int] = None, device="cuda",
                    backend: Optional[str] = None) -> int:
    """The rank count of a data-parallel run: ``make_data_mesh``'s rule, the
    largest divisor of ``batch_size`` that is at most ``n_devices`` (so no
    shard is uneven). ``n_devices=None`` means every card on ``device="cuda"``
    and one rank on the CPU; on the CPU a larger ``n_devices`` runs that many
    gloo ranks, and so does one card with ``backend="gloo"``
    (:func:`rank_placement`)."""
    avail = _ranks_available(n_devices, device, "make_data_group", backend)
    return max(d for d in range(1, avail + 1) if batch_size % d == 0)


def rank_placement(device, backend: Optional[str] = None) -> Dict[str, Any]:
    """:func:`spawn`'s ``device`` and ``backend`` for the ranks of a trainer
    run on ``device``: a card each over NCCL (``backend=None``), or, with
    ``backend="gloo"``, every rank on the card ``device`` names (card 0 where
    it names none; NCCL takes one rank a card); gloo ranks on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and backend == "gloo":
        return {"device": f"cuda:{device.index or 0}", "backend": "gloo"}
    return {"device": device.type, "backend": backend}


def shard_batch(group: Optional[DataGroup], batch):
    """This rank's contiguous slice of the leading axis of ``batch``, in rank
    order, as ``NamedSharding(mesh, P("data"))`` places the global batch: of
    a tensor, an array or a list (of tokens, frames, …), and of each value of
    a dict or tuple (nested). ``batch`` itself without a group. Uneven shards
    raise."""
    if group is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(group, v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return type(batch)(shard_batch(group, v) for v in batch)
    n = len(batch)
    if n % group.size:
        raise ValueError(f"shard_batch: a batch of {n} does not split over {group.size} ranks")
    k = n // group.size
    return batch[group.rank * k: (group.rank + 1) * k]


def _collective_tensors(module_or_tensors) -> List[torch.Tensor]:
    if isinstance(module_or_tensors, nn.Module):
        return list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
    if torch.is_tensor(module_or_tensors):
        return [module_or_tensors]
    if isinstance(module_or_tensors, dict):
        module_or_tensors = module_or_tensors.values()
    return [t for item in module_or_tensors for t in _collective_tensors(item)]


@torch.no_grad()
def replicate(group: Optional[DataGroup], module_or_tensors):
    """Data rank 0's values into every rank of the data group, in place: the
    parameters and buffers of a module, or each tensor of a tensor, list,
    tuple or dict (nested). Returns its argument."""
    if group is not None:
        for t in _collective_tensors(module_or_tensors):
            dist.broadcast(t.data, src=group.model_rank, group=group.data_group)
    return module_or_tensors


def barrier(group: Optional[DataGroup]) -> None:
    """Every rank waits here for the others."""
    if group is None:
        return
    if group.backend == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


@torch.no_grad()
def ranks_agree(group: Optional[DataGroup], module_or_tensors) -> bool:
    """Whether every rank of the data group holds data rank 0's values, bit
    for bit, in each tensor (or the parameters and buffers of a module); the
    same answer on every rank of the run."""
    if group is None:
        return True
    same = True
    for t in _collective_tensors(module_or_tensors):
        ref = t.detach().clone()
        dist.broadcast(ref, src=group.model_rank, group=group.data_group)
        same = same and torch.equal(ref, t.detach())
    flag = torch.tensor([float(same)], device=group.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group; its backward sums the ranks'
    cotangents, so each rank's gradient is that of the sum of every rank's
    loss."""

    @staticmethod
    def forward(ctx, x, process_group):
        ctx.process_group = process_group
        out = x.clone()
        dist.all_reduce(out, group=process_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.process_group)
        return grad, None


def all_reduce_sum(group: Optional[DataGroup], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group (``x`` itself without a group),
    differentiable: the backward all-reduces the gradient."""
    return x if group is None else _AllReduceSum.apply(x, group.data_group)


@torch.no_grad()
def all_reduce_gradients(group: Optional[DataGroup], params: Sequence[torch.Tensor]) -> int:
    """Average the float32 ``.grad`` of ``params`` over the data group, in one
    flat bucket (summed, then divided by the rank count): a replicated
    parameter's gradient and a tensor-parallel slice's alike, since the
    slices of one model rank meet only the same slices. A parameter without a
    gradient on some rank counts zeros there; one that no rank gave a
    gradient keeps ``None``, as a single-process step leaves it. Returns the
    bucket's bytes (0 without a group)."""
    if group is None:
        return 0
    params = list(params)
    for p in params:
        if p.grad is not None and p.grad.dtype != torch.float32:
            raise TypeError(f"all_reduce_gradients takes float32 gradients, not {p.grad.dtype}")
    parts = [p.grad.reshape(-1) if p.grad is not None
             else torch.zeros(p.numel(), dtype=torch.float32, device=group.device) for p in params]
    present = torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=group.device)
    bucket = torch.cat(parts + [present])
    dist.all_reduce(bucket, group=group.data_group)
    n = bucket.numel() - len(params)
    bucket[:n].div_(group.size)
    views = bucket[:n].split([p.numel() for p in params])
    for p, g, had in zip(params, views, bucket[n:].tolist()):
        if had:
            if p.grad is None:
                p.grad = g.view(p.shape).clone()
            else:
                p.grad.copy_(g.view(p.shape))
    return bucket.numel() * bucket.element_size()


@torch.no_grad()
def average_metrics(group: Optional[DataGroup], metrics: Dict) -> Dict:
    """Each scalar metric averaged over the data group, as float32 tensors
    (in one all-reduce); ``metrics`` itself without a group."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).to(group.device).reshape(())
                        for k in keys])
    dist.all_reduce(vals, group=group.data_group)
    vals /= group.size
    return dict(zip(keys, vals.unbind()))


def sync_batch_norms(module: nn.Module, group: Optional[DataGroup]) -> nn.Module:
    """Let every :class:`~lyft3d_tpu_torch.models.layers.BatchNorm` of
    ``module`` take its train-mode statistics over the global batch of
    ``group`` (``None``: this rank's batch alone). Returns ``module``."""
    from lyft3d_tpu_torch.models.layers import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


def reseed_for_rank(source, group: Optional[DataGroup]):
    """``source`` (a loader or dataset with a ``np.random.RandomState`` as
    ``rng``, copied into every rank) with its generator re-seeded from a draw
    of the copied one and the rank, so that the ranks augment their shards
    with streams of their own rather than one stream each. Unchanged without
    a group. Returns ``source``."""
    if group is not None and isinstance(getattr(source, "rng", None), np.random.RandomState):
        source.rng = np.random.RandomState([int(source.rng.randint(2 ** 31 - 1)), group.rank])
    return source


def make_train_step_dp(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       group: Optional[DataGroup]) -> Callable:
    """``step(batch) -> loss``: ``loss_fn(batch)`` on this rank's shard of the
    global batch, backward, the gradients of the optimizer's (float32)
    parameters averaged over the data group, ``optimizer.step()``. The loss
    comes back detached, averaged over the data group: the global loss where
    ``loss_fn`` is a mean over the batch. The counterpart of the JAX
    ``make_train_step_dp`` (the reference's ``DataParallel``), which takes the
    global batch and shards it; here each rank holds its shard. Under a
    model axis the module's wide layers are sharded by
    :func:`~lyft3d_tpu_torch.parallel.tensor.tensor_parallel_params` and
    ``optimizer`` works on the slices; the global-norm clip of a
    :class:`~lyft3d_tpu_torch.train.optim.ChainOptimizer` sees the whole
    model's norm."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        all_reduce_gradients(group, params)
        optimizer.step()
        return average_metrics(group, {"loss": loss.detach()})["loss"]

    return step


def bev_rasterize_point_sharded(group: Optional[DataGroup], points, valid, **raster_kw):
    """Point-parallel BEV raster: the raster kernel on this rank's contiguous
    slice of the points, then the count grids summed over the ranks. Counts
    are integers below 2^24, so the float32 sum is exact and every rank holds
    the single-launch grid.

    ``points`` ``(…, N, 3+)`` with N divisible by the rank count, ``valid``
    ``(…, N)`` (a batch of sweeps is split along its points, each sweep over
    every rank); ``raster_kw`` as :func:`~lyft3d_tpu_torch.ops.bev_raster.bev_rasterize`
    takes them. Returns ``(…, H, W, C)`` float32 counts."""
    from lyft3d_tpu_torch.ops.bev_raster import bev_rasterize

    if group is not None:
        n = points.shape[-2]
        if n % group.size:
            raise ValueError(f"bev_rasterize_point_sharded: {n} points do not split over {group.size} ranks")
        k = n // group.size
        take = slice(group.rank * k, (group.rank + 1) * k)
        points, valid = points[..., take, :].contiguous(), valid[..., take].contiguous()
    counts = bev_rasterize(points, valid, **raster_kw)
    if group is not None:
        dist.all_reduce(counts, group=group.data_group)
    return counts


def _mesh_groups(rank: int, size: int, model_parallel: int, backend: str, device: torch.device):
    """This rank's :class:`DataGroup`. Every rank creates every subgroup, in
    the same order (data groups, then model groups), as ``new_group``
    requires."""
    m_size = model_parallel
    d_size = size // m_size
    data_group = model_group = None
    if m_size > 1:
        grid = make_mesh(size, m_size, device="cpu").devices
        for m in range(m_size):
            g = dist.new_group(grid[:, m].tolist())
            if rank % m_size == m:
                data_group = g
        for d in range(d_size):
            g = dist.new_group(grid[d].tolist())
            if rank // m_size == d:
                model_group = g
    return DataGroup(size=d_size, rank=rank // m_size, device=device, backend=backend,
                     model_size=m_size, model_rank=rank % m_size, data_group=data_group,
                     model_group=model_group)


def _rank_main(rank: int, payload: bytes, size: int, backend: str, device: str, workdir: str,
               model_parallel: int = 1) -> None:
    fn, args = pickle.loads(payload)

    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // size))
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "rendezvous"),
                            world_size=size, rank=rank)
    try:
        out = fn(_mesh_groups(rank, size, model_parallel, backend, dev), *args)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "result.pt"))
    except BaseException:
        # When one rank raises, the others fail in their next collective: the
        # first to fail is the cause, so each failure keeps its time.
        with open(os.path.join(workdir, f"failed-{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(workdir: str, size: int) -> str:
    failures = []
    for rank in range(size):
        path = os.path.join(workdir, f"failed-{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                when, text = f.read().split("\n", 1)
            failures.append((float(when), rank, text))
    if not failures:
        return ""
    _, rank, text = min(failures)
    return f"rank {rank} of {size} raised first:\n{text}"


def spawn(fn: Callable, n_devices: int, args: Iterable = (), backend: Optional[str] = None,
          device="cuda", model_parallel: int = 1):
    """Run ``fn(group, *args)`` on ``n_devices`` ranks, one process each
    (``torch.multiprocessing``'s spawn), and return rank 0's result.
    ``model_parallel=M`` lays the ranks out as ``make_mesh(n_devices, M)``:
    ``group`` carries the rank's data and model groups (see the module
    docstring).

    ``device="cuda"`` puts rank ``r`` on card ``r`` (``torch.cuda.set_device``)
    with NCCL; a card named by index (``"cuda:0"``) takes every rank, which
    NCCL refuses for more than one, so that needs ``backend="gloo"``;
    ``"cpu"`` runs gloo ranks on the CPU. The ranks meet through a file
    store in a fresh temporary directory (no TCP port). ``fn`` and ``args``
    are pickled (with ``pickle``, so each rank gets its own copy of every
    tensor) into each rank: ``fn`` must be a module-level function, and
    tensors in ``args`` should be on the CPU. If any rank raises, the others
    are stopped and this raises ``RuntimeError`` with its traceback."""
    import torch.multiprocessing as mp

    make_mesh(n_devices, model_parallel, device="cpu")  # refuses an uneven model axis
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn: no CUDA device found (pass device='cpu' to run on the CPU)")
        if dev.index is None and n_devices > torch.cuda.device_count():
            raise ValueError(f"spawn: {n_devices} ranks, {torch.cuda.device_count()} cards")
        if dev.index is not None and backend == "nccl" and n_devices > 1:
            raise ValueError("spawn: NCCL takes one rank a card; pass backend='gloo' to share one")
    elif backend != "gloo":
        raise ValueError(f"spawn: the CPU runs gloo ranks, not {backend!r}")
    workdir = tempfile.mkdtemp(prefix="lyft3d_ranks_")
    try:
        try:
            # Plain pickle: torch.multiprocessing would hand every rank the
            # same shared memory for a CPU tensor, and each would train it.
            payload = pickle.dumps((fn, tuple(args)))
            mp.start_processes(_rank_main, args=(payload, n_devices, backend, str(dev), workdir, model_parallel),
                               nprocs=n_devices, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            cause = _first_failure(workdir, n_devices) or f"rank {e.error_index} of {n_devices}: {e}"
            raise RuntimeError(f"data-parallel run failed: {cause}") from None
        return torch.load(os.path.join(workdir, "result.pt"), weights_only=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

