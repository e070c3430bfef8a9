from .naming import camel_case_split, class_reduction_rule, normalize_object_type
from .receptacles import (
    check_inside_receptacle,
    parse_receptacle_line,
    receptacle_masks_for_scene,
)
from .relations import (
    CONTAINER_OBJ_CLASSES,
    NO_LOCALIZATION_OBJ_CLASSES,
    RelationAccumulator,
    get_all_relations,
)
from .scene import (
    ALL_SCENES,
    CAM_INTR,
    SCENE_BOUNDS,
    TEST_SCENES,
    gt_alignment_transform,
    parse_exported_gt,
    scene_data_from_thor_datapoint,
)

__all__ = [
    "camel_case_split",
    "class_reduction_rule",
    "normalize_object_type",
    "check_inside_receptacle",
    "parse_receptacle_line",
    "receptacle_masks_for_scene",
    "CONTAINER_OBJ_CLASSES",
    "NO_LOCALIZATION_OBJ_CLASSES",
    "RelationAccumulator",
    "get_all_relations",
    "ALL_SCENES",
    "CAM_INTR",
    "SCENE_BOUNDS",
    "TEST_SCENES",
    "gt_alignment_transform",
    "parse_exported_gt",
    "scene_data_from_thor_datapoint",
]
