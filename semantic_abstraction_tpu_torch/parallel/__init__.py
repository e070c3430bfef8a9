from .distributed import (
    ForwardLoss,
    all_gather_host_objects,
    data_parallel,
    data_parallel_from_args,
    destroy_distributed,
    is_initialized,
    maybe_initialize_distributed,
    mesh_size_from_args,
    rank,
    world_size,
)

__all__ = [
    "ForwardLoss",
    "all_gather_host_objects",
    "data_parallel",
    "data_parallel_from_args",
    "destroy_distributed",
    "is_initialized",
    "maybe_initialize_distributed",
    "mesh_size_from_args",
    "rank",
    "world_size",
]
