"""Spatial-relation mining for THOR scene datagen.

Behavioral re-architecture of the reference's relation miner
(reference: generate_thor_data.py get_all_relations :170-592): the same
three relation sources — (a) receptacle parentage -> "on"/"in" (with
whole-receptacle supervision when the target is hidden), (b) the
"banana in a <container>" hidden-object augmentation, (c) displacement
dot-product directional relations (behind / left / right / in-front,
threshold 0.6) with behind-region carving of empty space — restructured
into an accumulator + per-source helpers, with the O(N^2) nearest /
grouping loops vectorized.

Carving (mutating full_objid_pts to supervise hidden regions) is done on
a scene dict exactly like the reference so downstream HDF5 layout is
unchanged.

A copy of ``semantic_abstraction_tpu/datagen/relations.py`` (numpy, host only), so that the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Set

import numpy as np

from .naming import camel_case_split, normalize_object_type

CONTAINER_OBJ_CLASSES = {
    "cabinet", "fridge", "drawer", "bathtub basin", "bowl", "box", "cup",
    "desk", "garbage can", "laundry hamper", "microwave", "mug", "pot",
    "safe", "sink basin", "toaster",
}
NO_LOCALIZATION_OBJ_CLASSES = {
    "wall", "ceiling", "floor", "empty", "countertop", "drawer", "counter",
    "banana",
}
# classes nobody localizes against (reference :216-224)
_BAD_REFERENCE = {"floor", "rug", "baseboard", "light fixture", "decal"}
DIRECTION_DOT_THRESHOLD = 0.6


class RelationAccumulator:
    """Dedup + exclusivity rules (reference should_add_relation :210-238)."""

    def __init__(self):
        self.descriptions: Set[str] = set()
        self.unfiltered = []
        self.rows = {
            "target_obj_name": [],
            "target_obj_material": [],
            "target_obj_id": [],
            "reference_obj_name": [],
            "reference_obj_material": [],
            "spatial_relation_name": [],
        }

    def should_add(self, target: str, relation: str, reference: str) -> bool:
        if target == reference:
            return False
        if "ceiling" in reference or reference in _BAD_REFERENCE or target in _BAD_REFERENCE:
            return False
        if f"{target} {relation} a {reference}" in self.descriptions:
            return False
        if relation not in {"in", "on"}:
            # containment/support relations preempt directional ones
            for a, b in ((target, reference), (reference, target)):
                if (f"{a} in a {b}" in self.descriptions
                        or f"{a} on a {b}" in self.descriptions):
                    return False
        return True

    def add(self, target: str, relation: str, reference: str, target_id: int,
            target_material: str = "", reference_material: str = ""):
        self.descriptions.add(f"{target} {relation} a {reference}")
        self.rows["target_obj_name"].append(target)
        self.rows["target_obj_id"].append(target_id)
        self.rows["target_obj_material"].append(target_material)
        self.rows["reference_obj_name"].append(reference)
        self.rows["reference_obj_material"].append(reference_material)
        self.rows["spatial_relation_name"].append(relation)


def _materials(info: Optional[dict]) -> str:
    if not info or info.get("salientMaterials") is None:
        return ""
    return "|".join(info["salientMaterials"])


def _matching_receptacle_mask(receptacle_masks: Dict[str, dict], class_name: str):
    masks = [
        rv["mask"]
        for rk, rv in receptacle_masks.items()
        if normalize_object_type(rk.split("_")[0]) == class_name
    ]
    if not masks:
        return None
    return np.logical_or.reduce(tuple(masks))


def _receptacle_relations_for(acc, scene_data, receptacle_masks,
                              objects_info, remapped_visible_obj_ids,
                              all_remapped_obj_ids, visibility_pts_mask,
                              objects_in_scene, target_key, obj_info):
    """"X on/in a Y" from simulator parentReceptacles
    (reference :248-337), carving hidden targets over the receptacle."""
    target_name = normalize_object_type(obj_info["objectType"])
    for reference_key in obj_info.get("parentReceptacles") or []:
        if reference_key not in remapped_visible_obj_ids:
            continue
        if target_key not in all_remapped_obj_ids:
            logging.warning("%s not in mapped objids %s", target_key,
                            reference_key)
            continue
        if (all_remapped_obj_ids[target_key] not in objects_in_scene
                or all_remapped_obj_ids[reference_key] not in objects_in_scene):
            continue
        parent_info = objects_info[reference_key]
        if parent_info["objectType"] == "Floor":
            continue
        reference_name = normalize_object_type(parent_info["objectType"])
        relation = "in" if reference_name in CONTAINER_OBJ_CLASSES else "on"
        acc.unfiltered.append(f"{target_name} {relation} a {reference_name}")
        if not acc.should_add(target_name, relation, reference_name):
            continue
        acc.add(
            target_name, relation, reference_name,
            target_id=all_remapped_obj_ids[target_key],
            target_material=_materials(obj_info),
            reference_material=_materials(parent_info),
        )
        if target_key not in remapped_visible_obj_ids:
            # hidden target: supervise the whole (invisible part of
            # the) receptacle region
            mask = _matching_receptacle_mask(receptacle_masks, reference_name)
            if mask is None:
                continue
            scene_data["full_objid_pts"][
                :, np.logical_and(mask, ~visibility_pts_mask)
            ] = all_remapped_obj_ids[target_key]


def _banana_augmentation_for(acc, scene_data, receptacle_masks,
                             remapped_visible_obj_ids, visibility_pts_mask,
                             container_key, obj_info):
    """"banana in a <container>" supervision over invisible container
    interiors (reference :339-387)."""
    container_name = normalize_object_type(obj_info["objectType"])
    if container_name not in CONTAINER_OBJ_CLASSES:
        return
    if container_key not in remapped_visible_obj_ids:
        return
    mask = _matching_receptacle_mask(receptacle_masks, container_name)
    if mask is None:
        return
    description = f"banana in a {container_name}"
    acc.unfiltered.append(description)
    if not acc.should_add("banana", "in", container_name):
        return
    hidden_obj_id = len(scene_data["objid_to_class"])
    acc.add(
        "banana", "in", container_name, target_id=hidden_obj_id,
        reference_material=_materials(obj_info),
    )
    scene_data["objid_to_class"] = np.array(
        scene_data["objid_to_class"].astype(str).tolist()
        + [f"banana[{hidden_obj_id}]"]
    ).astype("S")
    scene_data["full_objid_pts"][
        :, np.logical_and(mask, ~visibility_pts_mask)
    ] = hidden_obj_id


def _carve_behind_region(scene_data, reference_name, target_obj_id,
                         visibility_pts_mask, resize_scale: int = 10):
    """Assign empty space occluded by the reference object to the hidden
    target (reference :454-522): per coarse pixel cell, any point deeper
    than the reference's back surface, invisible, and currently empty."""
    objid_to_class = scene_data["objid_to_class"].astype(str)
    class_names = [c.split("[")[0] for c in objid_to_class]
    if "empty" not in class_names:
        return
    empty_id = class_names.index("empty")
    full_ids = scene_data["full_objid_pts"][0]
    empty_mask = full_ids == empty_id
    ref_mask = np.isin(
        full_ids,
        [i for i, c in enumerate(class_names) if c == reference_name],
    )
    if not ref_mask.any():
        return
    xyz = scene_data["full_xyz_pts"][0]
    cam_pose = scene_data["cam_pose"]
    cam_intr = scene_data["cam_intr"]
    inv = np.linalg.inv(cam_pose)
    cam_pts = xyz @ inv[:3, :3].T + inv[:3, 3]
    pix_z = cam_pts[:, 2]
    safe_z = np.where(pix_z == 0, 1e-12, pix_z)
    pix_x = np.round(cam_pts[:, 0] * cam_intr[0, 0] / safe_z + cam_intr[0, 2]).astype(int)
    pix_y = np.round(cam_pts[:, 1] * cam_intr[1, 1] / safe_z + cam_intr[1, 2]).astype(int)
    pix = np.stack([pix_x, pix_y], axis=1)
    corner = pix.min(axis=0)
    # reference semantics (generate_thor_data.py:495-506): np.digitize
    # into bins arange(0, im_w/im_h, resize_scale) — i.e. min(v//rs + 1,
    # n_bins). The SATURATION is load-bearing: points projecting beyond
    # the image extent collapse into the last cell (common — the full GT
    # cloud spans far more than the image once divided by small z), and
    # without it the cell grid is unbounded (a near-zero-z point projects
    # to ~1e5 px -> a multi-GB back-surface array).
    im_h, im_w = scene_data["depth"][0].shape
    shifted = pix - corner
    n_x = len(np.arange(0, im_w, resize_scale))
    n_y = len(np.arange(0, im_h, resize_scale))
    cells = np.stack(
        [
            np.minimum(shifted[:, 0] // resize_scale + 1, n_x),
            np.minimum(shifted[:, 1] // resize_scale + 1, n_y),
        ],
        axis=1,
    )

    ref_cells = cells[ref_mask]
    ref_z = pix_z[ref_mask]
    # back surface depth per coarse cell (vectorized segment max)
    dims = cells.max(axis=0) + 1
    lin_all = cells[:, 0] * dims[1] + cells[:, 1]
    lin_ref = ref_cells[:, 0] * dims[1] + ref_cells[:, 1]
    back = np.full(dims[0] * dims[1], -1.0)
    np.maximum.at(back, lin_ref, ref_z)
    accessed = back[lin_all]
    behind = (accessed < pix_z) & (accessed != -1)
    target_mask = behind & ~visibility_pts_mask & empty_mask
    scene_data["full_objid_pts"][:, target_mask] = target_obj_id


def _mine_directional_relations(acc, scene_data, objects_info,
                                remapped_visible_obj_ids, visibility_pts_mask,
                                dot_threshold=DIRECTION_DOT_THRESHOLD):
    """behind / left / right / in-front from centroid displacement
    (reference :389-592)."""
    objid_to_class = scene_data["objid_to_class"].astype(str)
    full_ids = scene_data["full_objid_pts"][0]
    xyz = scene_data["full_xyz_pts"][0]
    for reference_key, reference_id in remapped_visible_obj_ids.items():
        reference_name = objid_to_class[reference_id].split("[")[0]
        for target_id in set(full_ids.tolist()):
            target_id = int(target_id)
            target_name = objid_to_class[target_id].split("[")[0]
            if reference_id == target_id:
                continue
            if (target_name in NO_LOCALIZATION_OBJ_CLASSES
                    or reference_name in NO_LOCALIZATION_OBJ_CLASSES):
                continue
            t_mask = full_ids == target_id
            r_mask = full_ids == reference_id
            if not t_mask.any() or not r_mask.any():
                continue
            t_pts = xyz[t_mask]
            r_pts = xyz[r_mask]
            displacement = r_pts.mean(axis=0) - t_pts.mean(axis=0)
            distance = np.linalg.norm(displacement)
            direction = displacement / max(distance, 1e-12)
            r_bounds = r_pts.max(axis=0) - r_pts.min(axis=0)
            distance_threshold = min(
                max(max(r_bounds[0], r_bounds[1]) * 2.0, 0.1), 1.0
            )
            if distance > distance_threshold:
                continue
            reference_material = _materials(objects_info.get(reference_key))
            target_is_visible = target_id in scene_data["seg"]
            acc.unfiltered.append(f"{target_name} behind a {reference_name}")
            if (np.dot(direction, [-1, 0, 0]) > dot_threshold
                    and acc.should_add(target_name, "behind", reference_name)):
                acc.add(target_name, "behind", reference_name, target_id,
                        reference_material=reference_material)
                if not target_is_visible:
                    _carve_behind_region(
                        scene_data, reference_name, target_id,
                        visibility_pts_mask,
                    )
            if reference_name in {"cabinet"}:
                continue
            if target_id not in remapped_visible_obj_ids.values():
                continue
            right = np.dot(direction, [0, 1, 0]) > dot_threshold
            left = np.dot(direction, [0, -1, 0]) > dot_threshold
            front = np.dot(direction, [1, 0, 0]) > dot_threshold
            if right:
                acc.unfiltered.append(
                    f"{target_name} on the right of a {reference_name}")
            elif left:
                acc.unfiltered.append(
                    f"{target_name} on the left of a {reference_name}")
            elif front:
                acc.unfiltered.append(
                    f"{target_name} in front of a {reference_name}")
            if right and acc.should_add(target_name, "on the right of",
                                        reference_name):
                acc.add(target_name, "on the right of", reference_name,
                        target_id, reference_material=reference_material)
            elif left and acc.should_add(target_name, "on the left of",
                                         reference_name):
                acc.add(target_name, "on the left of", reference_name,
                        target_id, reference_material=reference_material)
            elif front and acc.should_add(target_name, "in front of",
                                          reference_name):
                acc.add(target_name, "in front of", reference_name,
                        target_id, reference_material=reference_material)


def get_all_relations(
    scene_data: dict,
    receptacle_masks: Dict[str, dict],
    objects_info: Dict[str, dict],
    remapped_visible_obj_ids: Dict[str, int],
    all_remapped_obj_ids: Dict[str, int],
    visibility_pts_mask: np.ndarray,
) -> dict:
    """Mine all description rows for one scene; mutates ``scene_data``
    (hidden-region carving) like the reference."""
    objects_in_scene = set(np.unique(scene_data["full_objid_pts"]).tolist())
    acc = RelationAccumulator()
    # ONE loop over objects_info with the banana augmentation interleaved
    # after each object's receptacle block — the reference's structure
    # (:250-387). Phase-split execution inverted carve/dedup precedence:
    # e.g. a hidden spoon in a cabinet must overwrite the cabinet's
    # earlier banana carve (spoon wins in the reference), and a real
    # banana row vs its augmentation dedups by whichever comes first.
    for obj_key, obj_info in objects_info.items():
        _receptacle_relations_for(
            acc, scene_data, receptacle_masks, objects_info,
            remapped_visible_obj_ids, all_remapped_obj_ids,
            visibility_pts_mask, objects_in_scene, obj_key, obj_info,
        )
        _banana_augmentation_for(
            acc, scene_data, receptacle_masks, remapped_visible_obj_ids,
            visibility_pts_mask, obj_key, obj_info,
        )
    _mine_directional_relations(
        acc, scene_data, objects_info, remapped_visible_obj_ids,
        visibility_pts_mask,
    )
    return acc.rows
