"""THOR dataset-generation CLI of the port.

Counterpart of ``semantic_abstraction_tpu/cli/generate_thor_data.py``
(reference: generate_thor_data.py — run_simulator :695-814, ray task pool
:1021-1186, HDF5 write :1053-1061). The AI2-THOR Unity binary (and the
external SceneVolumeExporter) is the rendering dependency, imported only
when a datapoint is simulated; Ray's task pool is a stdlib ``spawn`` pool.
Datagen is host work: the scene assembly (``datagen/scene.py``) runs its
TSDF on the CPU, so no card is needed and none is used. Seed-indexed
output files make restarts resume for free (reference :1032-1034).

  python -m semantic_abstraction_tpu_torch.cli.generate_thor_data \
      OUTPUT_DIR --exported-scenes PATH [--num-datapoints N] [--workers W]
"""
from __future__ import annotations

import argparse
import logging
import os
from copy import deepcopy

import numpy as np


def run_simulator(scene_id: str, domain_randomization: bool,
                  rng: np.random.RandomState, num_attempts: int = 10,
                  dist: float = 3.0):
    """Sample a good viewpoint in a THOR room (reference :695-814):
    teleport attempts with the reference's quality heuristics (wall <80%
    of view, >=4 classes, >=20% of pixels within dist±1m, reflective
    depth inpainted)."""
    try:
        from ai2thor.controller import Controller
        from ai2thor.platform import CloudRendering
    except ImportError as e:  # pragma: no cover - ai2thor is an optional dependency
        raise SystemExit(
            "ai2thor is required for THOR datagen (Unity rendering); it is "
            "not available in this image. Consume pre-exported datasets "
            "instead."
        ) from e

    from ..datagen.naming import process_class_name
    from ..datagen.scene import FOV_W, HEIGHT, WIDTH

    controller = None
    try:
        controller = Controller(
            agentMode="default", visibilityDistance=1.5, scene=scene_id,
            gridSize=0.05, snapToGrid=False, rotateStepDegrees=5,
            renderDepthImage=True, renderInstanceSegmentation=True,
            width=WIDTH, height=HEIGHT, fieldOfView=FOV_W,
            platform=CloudRendering,
        )
    except Exception as e:
        logging.error(e)
        if controller is not None:
            controller.stop()
        return None

    reachable = controller.step(action="GetReachablePositions").metadata[
        "actionReturn"
    ]
    datapoint = None
    for _ in range(num_attempts):
        position = reachable[rng.randint(len(reachable))]
        rotation = dict(x=0, y=rng.uniform(0, 360), z=0)
        try:
            event = controller.step(
                action="Teleport", position=position, rotation=rotation,
                horizon=0, standing=True,
            )
        except Exception as e:
            logging.error(e)
            controller.stop()
            return None
        classes = list(
            set(process_class_name(v) for v in event.color_to_object_id.values())
        )
        semantic = np.zeros(event.instance_segmentation_frame.shape[:2], int)
        for color, objname in event.color_to_object_id.items():
            mask = (event.instance_segmentation_frame == color).all(axis=-1)
            semantic[mask] = classes.index(process_class_name(objname))
        # Unity reflective surfaces report reflection-probe depth: inpaint
        depth = deepcopy(event.depth_frame)
        reflective = depth > 10.0
        if reflective.any():
            depth[reflective] = np.interp(
                np.flatnonzero(reflective), np.flatnonzero(~reflective),
                depth[~reflective],
            )
        if "Wall" in classes and (semantic == classes.index("Wall")).mean() > 0.8:
            continue
        in_range = (depth < dist + 1.0) & (depth > dist - 1.0)
        if len(np.unique(semantic)) < 4 or in_range.mean() < 0.2:
            continue
        dr_rgb = np.zeros(1)
        if domain_randomization:
            controller.step(action="RandomizeMaterials")
            dr_rgb = controller.step(action="RandomizeMaterials").frame
        controller.stop()
        datapoint = {
            "scene_id": scene_id,
            "rgb": deepcopy(event.frame),
            "depth": depth,
            "instance": deepcopy(event.instance_segmentation_frame),
            "color_to_object_id": deepcopy(event.color_to_object_id),
            "semantic": semantic,
            "classes": classes,
            "position": list(event.metadata["agent"]["position"].values()),
            "camera_horizon": event.metadata["agent"]["cameraHorizon"],
            "rotation": list(event.metadata["agent"]["rotation"].values()),
            "objects_info": event.metadata["objects"],
            "domain_randomized_rgb": dr_rgb,
        }
        break
    if datapoint is None:
        controller.stop()
    return datapoint


def write_scene_hdf5(path: str, scene_data: dict):
    """Write one scene file in the reference schema (resizable gzip-9
    datasets + 'data' group of region refs; generate_relevancy.py:33-60)."""
    import h5py

    from ..data.hdf5 import get_datastructure, init_dataset, resize_and_add_data

    image_shape = scene_data["rgb"].shape[1:3]
    tsdf_dim = (64, 64, 64)
    struct = get_datastructure(
        image_shape, list(image_shape), tsdf_dim,
        scene_data["full_xyz_pts"].shape[1],
    )
    struct.pop("saliencies")  # written later by generate_relevancy dataset
    init_dataset(path, struct)
    with h5py.File(path, "a") as f:
        g = f.create_group("data")
        for key in ("rgb", "depth", "seg", "tsdf_value_pts", "tsdf_xyz_pts",
                    "full_xyz_pts", "full_objid_pts"):
            refs = resize_and_add_data(f[key], scene_data[key])
            g[key] = np.array(refs, dtype=h5py.regionref_dtype)
        if np.asarray(scene_data["domain_randomized_rgb"]).ndim == 4:
            g.create_dataset(
                "domain_randomized_rgb", data=scene_data["domain_randomized_rgb"],
                compression="gzip", compression_opts=9,
            )
        g["cam_intr"] = scene_data["cam_intr"]
        g["cam_pose"] = scene_data["cam_pose"]
        g["objid_to_class"] = scene_data["objid_to_class"]
        dg = g.create_group("descriptions")
        d = scene_data["descriptions"]
        dg["target_obj_name"] = np.array(d["target_obj_name"], dtype="S128")
        dg["target_obj_id"] = np.array(d["target_obj_id"], np.int32)
        dg["reference_obj_name"] = np.array(d["reference_obj_name"], dtype="S128")
        dg["spatial_relation_name"] = np.array(
            d["spatial_relation_name"], dtype="S64"
        )
        dg["target_obj_material"] = np.array(d["target_obj_material"], dtype="S128")
        dg["reference_obj_material"] = np.array(
            d["reference_obj_material"], dtype="S128"
        )


def generate_datapoint(args_tuple):
    seed, scene_id, out_dir, exported, dr, dist, num_output_pts = args_tuple
    from ..datagen.scene import scene_data_from_thor_datapoint

    out_path = os.path.join(out_dir, f"{scene_id}_{seed}.hdf5")
    if os.path.exists(out_path):
        return out_path  # resume-friendly skip (reference :1032-1034)
    try:
        rng = np.random.RandomState(seed)
        datapoint = run_simulator(scene_id, dr, rng, dist=dist)
        if datapoint is None:
            return None
        scene_data = scene_data_from_thor_datapoint(
            rng, datapoint, dist, exported, num_output_pts=num_output_pts
        )
        if scene_data is None:
            return None
        write_scene_hdf5(out_path, scene_data)
        return out_path
    except Exception:
        # one bad datapoint must not abort the pool and discard hours of
        # simulator work on the other tasks
        logging.exception("datapoint %s_%s failed; continuing",
                          scene_id, seed)
        return None


def main(argv=None):
    from ..datagen.scene import ALL_SCENES, NUM_OUTPUT_PTS, TEST_SCENES

    parser = argparse.ArgumentParser(prog="generate_thor_data")
    parser.add_argument("output_dir", type=str)
    parser.add_argument("--exported-scenes", type=str, required=True,
                        help="SceneVolumeExporter dump directory")
    parser.add_argument("--num-datapoints", type=int, default=10000)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--dist", type=float, default=3.0)
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument("--num-output-pts", type=int, default=None,
                        help="GT points per scene (default: the reference's "
                             "1M, datagen/scene.NUM_OUTPUT_PTS)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    os.makedirs(args.output_dir, exist_ok=True)

    scenes = TEST_SCENES if args.test_only else ALL_SCENES
    # only scenes whose GT export exists (reference :1119-1149 filters on
    # full_xyz_pts.txt); a missing export otherwise fails every datapoint
    # of that scene
    scenes = [
        s for s in scenes
        if os.path.exists(os.path.join(args.exported_scenes, s,
                                       "full_xyz_pts.txt"))
        or os.path.exists(os.path.join(args.exported_scenes, f"{s}.pkl"))
    ]
    if not scenes:
        raise SystemExit(
            f"no exported scenes found under {args.exported_scenes} "
            "(need <scene>/full_xyz_pts.txt or a <scene>.pkl cache)"
        )
    num_output_pts = (NUM_OUTPUT_PTS if args.num_output_pts is None
                      else args.num_output_pts)
    tasks = []
    for seed in range(args.num_datapoints):
        scene_id = scenes[seed % len(scenes)]
        dr = scene_id in TEST_SCENES
        tasks.append(
            (seed, scene_id, args.output_dir, args.exported_scenes, dr,
             args.dist, num_output_pts)
        )
    if args.workers <= 1:
        results = [generate_datapoint(t) for t in tasks]
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.workers) as pool:
            results = list(pool.imap_unordered(generate_datapoint, tasks))
    done = sum(1 for r in results if r)
    logging.info("generated %d/%d datapoints", done, len(tasks))


if __name__ == "__main__":
    main()
