"""The port's input pipeline: HDF5 scene readers, host-side numpy
transforms and a thread-prefetched loader (a copy of the JAX package's
``data/``). Imports without ``h5py``, which only reading or writing a scene
file needs."""
from .hdf5 import (
    deref_h5py,
    resize_and_add_data,
    get_datastructure,
    init_dataset,
    write_to_hdf5,
)
from .transforms import (
    depth_to_pointcloud_np,
    check_pts_in_frustum_np,
    filter_pts_bounds_np,
    euler2mat,
    compose_affine,
    random_domain_transform,
    transform_filter_subsample,
    weighted_sample,
    compute_empty_mask,
    balanced_class_subsample,
    resize_bilinear_np,
    balanced_subsample_probabilities,
)
from .datasets import (
    SYNONYMS,
    INV_SYNONYMS,
    DataConfig,
    SceneUnderstandDataset,
    SceneCompletionDataset,
    ObjectLocalizationDataset,
)
from .loader import collate, ShardedSampler, DataLoader

__all__ = [
    "deref_h5py",
    "resize_and_add_data",
    "get_datastructure",
    "init_dataset",
    "write_to_hdf5",
    "depth_to_pointcloud_np",
    "check_pts_in_frustum_np",
    "filter_pts_bounds_np",
    "euler2mat",
    "compose_affine",
    "random_domain_transform",
    "transform_filter_subsample",
    "weighted_sample",
    "compute_empty_mask",
    "balanced_class_subsample",
    "resize_bilinear_np",
    "balanced_subsample_probabilities",
    "SYNONYMS",
    "INV_SYNONYMS",
    "DataConfig",
    "SceneUnderstandDataset",
    "SceneCompletionDataset",
    "ObjectLocalizationDataset",
    "collate",
    "ShardedSampler",
    "DataLoader",
]
