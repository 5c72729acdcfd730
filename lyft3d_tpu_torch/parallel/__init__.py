"""Data and tensor parallelism over the host's cards (``torch.distributed``)."""

from lyft3d_tpu_torch.parallel.mesh import (
    DataGroup,
    Mesh,
    make_data_group,
    make_data_mesh,
    make_mesh,
    replicate,
    shard_batch,
    spawn,
)
from lyft3d_tpu_torch.parallel.tensor import tensor_parallel_params

__all__ = ["DataGroup", "Mesh", "make_mesh", "make_data_mesh", "make_data_group", "shard_batch",
           "replicate", "spawn", "tensor_parallel_params"]
