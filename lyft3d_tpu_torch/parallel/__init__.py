"""Data parallelism over the host's cards (``torch.distributed``)."""

from lyft3d_tpu_torch.parallel.mesh import (
    DataGroup,
    make_data_group,
    replicate,
    shard_batch,
    spawn,
)

__all__ = ["DataGroup", "make_data_group", "shard_batch", "replicate", "spawn"]
