"""Receptacle (container) geometry for THOR datagen.

Reference: generate_thor_data.py:111-145 (process_receptacle_line,
check_inside_receptacle). The Unity exporter writes one line per
receptacle trigger box: ``name|(r00,r01,..)(..)..|(sx,sy,sz)|(cx,cy,cz)``;
membership is an oriented-bounding-box test in the receptacle's local
frame.

A copy of ``semantic_abstraction_tpu/datagen/receptacles.py`` (numpy, host only), so that the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def parse_receptacle_line(line: str) -> dict:
    name, matrix_str, size_str, center_str = line.strip().split("|")
    matrix = np.array(
        matrix_str.replace(")(", ",").replace("(", "").replace(")", "").split(","),
        dtype=np.float64,
    ).reshape(4, 4)
    size = np.array(size_str.strip("()").split(","), dtype=np.float64)
    center = np.array(center_str.strip("()").split(","), dtype=np.float64)
    return {
        "receptacle_name": name,
        "transform_matrix": matrix,
        "bbox_size": size,
        "bbox_center": center,
    }


def check_inside_receptacle(xyz_pts: np.ndarray, receptacle_info: dict) -> np.ndarray:
    """(N, 3) world points -> bool mask of points inside the OBB."""
    inv = np.linalg.inv(receptacle_info["transform_matrix"])
    local = xyz_pts @ inv[:3, :3].T + inv[:3, 3]
    half = np.asarray(receptacle_info["bbox_size"]) / 2.0
    return ((local >= -half) & (local <= half)).all(axis=-1)


def receptacle_masks_for_scene(xyz_pts: np.ndarray, lines) -> dict:
    infos = [parse_receptacle_line(l) for l in lines]
    return {
        info["receptacle_name"]: check_inside_receptacle(xyz_pts, info)
        for info in infos
    }
