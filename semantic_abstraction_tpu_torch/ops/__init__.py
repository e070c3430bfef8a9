"""Device ops of the port. The kernel wrappers live in their own modules
(``ops.fused_mha``, ``ops.channel_moments``, ``ops.cam_accumulate``) and
are imported where they are used."""
from .sampling import grid_sample_3d, resize_matrix
from .voxel import VoxelGrid

__all__ = ["VoxelGrid", "grid_sample_3d", "resize_matrix"]
