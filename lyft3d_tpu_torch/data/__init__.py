"""Dataset layer: Lyft JSON-table DB, point clouds, map masks, splits.

Host-side IO and relational lookups (pure Python/numpy — never on the
device); the device boundary is the fixed-shape arrays these produce.
"""

from lyft3d_tpu_torch.data.lyftdb import LyftDB
from lyft3d_tpu_torch.data.pointcloud import LidarPointCloud
from lyft3d_tpu_torch.data.map_mask import MapMask

__all__ = ["LyftDB", "LidarPointCloud", "MapMask"]
