"""Seconds and peak memory of a relevancy image at several tile batch sizes,
on the card: the sweep a relevancy cell's ``tile_batch_size`` is chosen by.

    python scripts/torch_tile_batch_sweep.py --workload vitl14-relevancy-ours \
        --seed 12345 --sizes 32 64 96 128 [--images 1]

One extractor of the cell's configuration (the benchmark's ``build``); for
each size, a warm-up image, then ``--images`` timed images of the cell's
traffic, each ending with its maps on the host. Prints one JSON line a
size: seconds an image, the peak memory of the timed images, the tile
chunks the plan takes, K1's and K2's launches an image, and the distinct
warnings raised (the batched backward warns where vmap falls back to a
loop). A size that runs out of memory prints ``"oom"``.
"""
import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sizes", type=int, nargs="+", required=True)
    ap.add_argument("--images", type=int, default=1)
    opts = ap.parse_args(argv)
    harness.card_or_exit(1)
    from semantic_abstraction_tpu_torch.clip.saliency import (_chunk_size, saliency_configs,
                                                               tile_plan)
    from semantic_abstraction_tpu_torch.ops.cam_accumulate import cam_accumulate
    from semantic_abstraction_tpu_torch.ops.fused_mha import fused_mha

    run = harness.Run(harness.Manifest(), opts.workload, opts.seed, 0.0, False)
    t = run.traffic
    path = harness.load_module(os.path.join(harness.BENCH_DIR, "paths", t["path"] + ".py"),
                                 "path_" + t["path"])
    sal = path.build(run)
    request = path.serve(run, sal)
    config = saliency_configs[t["saliency_config"]](t["height"])
    images = 1 + config.augmentations
    plans = [p for p in tile_plan((t["height"], t["width"]), config.crops, images)
             if p.offsets.shape[0]]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "workload": opts.workload,
                      "seed": opts.seed}), flush=True)
    for size in opts.sizes:
        sal.tile_batch_size = size
        out = {"tile_batch_size": size,
               "chunks": [_chunk_size(images * p.offsets.shape[0], size) for p in plans]}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                request(2**40 + size)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fused_mha.launches = cam_accumulate.launches = 0
                t0 = time.perf_counter()
                for k in range(opts.images):
                    request(k)
                torch.cuda.synchronize()
                out["s_per_image"] = (time.perf_counter() - t0) / opts.images
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                out["fused_mha_per_image"] = fused_mha.launches / opts.images
                out["cam_accumulate_per_image"] = cam_accumulate.launches / opts.images
            except torch.cuda.OutOfMemoryError as e:
                out["oom"] = str(e).splitlines()[0][:200]
        torch.cuda.empty_cache()
        out["warnings"] = sorted({f"{w.category.__name__}: {str(w.message)[:300]}"
                                  for w in caught})
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
