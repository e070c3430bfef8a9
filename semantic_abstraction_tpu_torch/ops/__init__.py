"""Device ops of the port. The kernel wrappers live in their own modules
(``ops.fused_mha``, ``ops.channel_moments``, ``ops.cam_accumulate``,
``ops.lamb_update``, ``ops.tail_backward``) and are imported where they
are used."""
from .fusion import TSDFVolume, get_view_frustum, meshwrite, pcwrite, rigid_transform
from .geometry import (
    check_pts_in_frustum,
    depth_to_pointcloud,
    filter_pts_bounds,
    project_pts_to_2d,
    transform_pointcloud,
)
from .marching import marching_tetrahedra
from .sampling import grid_sample_3d, resize_matrix
from .voxel import VoxelGrid

__all__ = [
    "TSDFVolume",
    "VoxelGrid",
    "check_pts_in_frustum",
    "depth_to_pointcloud",
    "filter_pts_bounds",
    "get_view_frustum",
    "grid_sample_3d",
    "marching_tetrahedra",
    "meshwrite",
    "pcwrite",
    "project_pts_to_2d",
    "resize_matrix",
    "rigid_transform",
    "transform_pointcloud",
]
