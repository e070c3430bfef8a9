"""HDF5 scene-file schema helpers.

Preserves the reference's on-disk dataset container so existing THOR/NYU
scene files work unchanged (reference: generate_relevancy.py:21-60,
utils.py:297-317 write_to_hdf5, dataset.py:19-20 deref_h5py).

Layout per scene .hdf5:
- top-level resizable gzip-9 datasets: rgb, depth, seg, saliencies,
  tsdf_value_pts, tsdf_xyz_pts, full_xyz_pts, full_objid_pts
- group "data": region references into those datasets (rgb, depth, seg,
  full_xyz_pts, full_objid_pts), cam_intr, cam_pose, objid_to_class,
  descriptions/{target_obj_name, target_obj_id, reference_obj_name,
  spatial_relation_name}, and saliencies/<rgb_key>|<config> region-ref
  arrays with |saliency_text_labels / |saliency_text_label_features
  siblings.

A copy of ``semantic_abstraction_tpu/data/hdf5.py`` for the port. ``h5py``
is imported where a file is opened, so the package imports on a machine
without it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def deref_h5py(dataset, refs) -> np.ndarray:
    """Resolve region references into a stacked float array
    (reference dataset.py:19-20). Empty ref lists keep the item shape
    (the reference returns a shapeless (0,) array and crashes downstream)."""
    if len(refs) == 0:
        return np.zeros((0,) + tuple(dataset.shape[1:]), np.float32)
    return np.array([dataset[ref][0] for ref in refs]).astype(np.float32)


def resize_and_add_data(dataset, data) -> List:
    """Append rows to a resizable dataset, returning their region refs
    (reference generate_relevancy.py:21-31)."""
    data = np.asarray(data)
    n0 = dataset.shape[0]
    assert dataset.shape[1:] == data.shape[1:]
    dataset.resize(n0 + data.shape[0], axis=0)
    dataset[n0:] = data
    return [dataset.regionref[n0 + i, ...] for i in range(data.shape[0])]


def get_datastructure(image_shape, relevancy_shape, tsdf_dim,
                      num_output_pts) -> Dict[str, dict]:
    """Top-level dataset specs (reference generate_relevancy.py:34-48)."""
    image_shape = list(image_shape)
    relevancy_shape = list(relevancy_shape)
    return {
        "rgb": {"dtype": "uint8", "item_shape": image_shape + [3]},
        "depth": {"dtype": "f", "item_shape": image_shape},
        "seg": {"dtype": "i", "item_shape": image_shape},
        "saliencies": {"dtype": "f", "item_shape": relevancy_shape},
        "tsdf_value_pts": {"dtype": "f", "item_shape": [int(np.prod(tsdf_dim))]},
        "tsdf_xyz_pts": {"dtype": "f", "item_shape": [int(np.prod(tsdf_dim)), 3]},
        "full_xyz_pts": {"dtype": "f", "item_shape": [num_output_pts, 3]},
        "full_objid_pts": {"dtype": "i", "item_shape": [num_output_pts]},
    }


def init_dataset(file_path: str, data_structure: Dict[str, dict]) -> None:
    """Create the resizable gzip-9 chunked datasets
    (reference generate_relevancy.py:50-60)."""
    import h5py

    with h5py.File(file_path, mode="w") as file:
        for key, info in data_structure.items():
            file.create_dataset(
                name=key,
                shape=tuple([0] + info["item_shape"]),
                dtype=info["dtype"],
                chunks=tuple([1] + info["item_shape"]),
                compression="gzip",
                compression_opts=9,
                maxshape=tuple([None] + info["item_shape"]),
            )


def write_to_hdf5(group, key: str, value, dtype=None, replace: bool = False):
    """Typed recursive writer (reference utils.py:297-317)."""
    if value is None:
        return
    if key in group:
        if replace:
            del group[key]
        else:
            raise KeyError(f"{key} already present")
    if isinstance(value, (str, int, float)):
        group.attrs[key] = value
    elif isinstance(value, dict):
        subgroup = group.create_group(key) if key not in group else group[key]
        for k, v in value.items():
            write_to_hdf5(subgroup, k, v)
    else:
        group.create_dataset(
            name=key, data=value, dtype=dtype,
            compression="gzip", compression_opts=9,
        )
