"""A copy of the benchmark's files at sizes the CPU runs in seconds, for the
tests: the same cells, drivers, readers and limits over small widths, a
small image and small batches. ``run_cell`` drives one run in this process
on the CPU, past the harness's look for a card."""
from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_CLIP = dict(embed_dim=32, image_resolution=112, vision_layers=12, vision_width=64,
                 vision_patch_size=16, text_width=64, text_heads=1, text_layers=2,
                 compute_dtype="float32")
TINY_NET = dict(voxel_shape=[16, 16, 16], unet_num_channels=8, unet_f_maps=4,
                unet_num_groups=2, unet_num_levels=3, pts_feat_extractor_hidden_dim=16,
                num_input_pts=512, num_output_pts=1024, num_patches=2, compute_dtype="float32")
TINY_TRAFFIC = {
    "images-480x640-9labels": dict(height=48, width=64, labels=["vase", "wall", "carpet"],
                                   checked_requests=1),
    "resident-pool8": dict(pool=4, traced_steps=1),
}



def make_copy(dest: str) -> str:
    """The benchmark folder and BENCHMARK.json under ``dest``, the
    configurations and traffic cut to tiny sizes -> the copy's folder."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), os.path.join(dest, "BENCHMARK.json"))
    for name, tiny in (("clip-vit-b32", TINY_CLIP), ("semabs3d-ovssc", TINY_NET)):
        edit_json(os.path.join(bench, "configs", name + ".json"), tiny)
    for name, tiny in TINY_TRAFFIC.items():
        edit_json(os.path.join(bench, "traffic", name + ".json"), tiny)
    return bench


def edit_json(path: str, changes: dict) -> None:
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def run_cell(bench: str, workload: str, seed: int = 11, seconds: float = 0.5,
             trace: bool = False) -> dict:
    """One run on the CPU -> the result's line."""
    import torch

    from benchmark import harness

    torch.set_num_threads(2)
    run = harness.Run(harness.Manifest(bench), workload, seed, seconds, trace, device="cpu")
    return harness.execute(run)
