"""Pure geometry and box math (host-side numpy; device mirrors live in ops/)."""

from lyft3d_tpu_torch.core.quaternion import (
    quat_multiply,
    quat_inverse,
    quat_rotate,
    quat_to_rotation_matrix,
    quat_from_axis_angle,
    quat_from_yaw,
    quaternion_yaw,
)
from lyft3d_tpu_torch.core.geometry import (
    transform_matrix,
    view_points,
    points_in_box,
)
from lyft3d_tpu_torch.core.box import Box

__all__ = [
    "quat_multiply",
    "quat_inverse",
    "quat_rotate",
    "quat_to_rotation_matrix",
    "quat_from_axis_angle",
    "quat_from_yaw",
    "quaternion_yaw",
    "transform_matrix",
    "view_points",
    "points_in_box",
    "Box",
]
