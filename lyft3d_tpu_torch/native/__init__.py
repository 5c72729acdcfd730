"""Native (C++) host runtime bindings — see loader.cpp."""

from lyft3d_tpu_torch.native.bindings import (
    native_available,
    read_lidar,
    transform_points,
    load_batch,
    bev_raster,
)

__all__ = ["native_available", "read_lidar", "transform_points", "load_batch",
           "bev_raster"]
