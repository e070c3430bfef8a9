"""The data-parallel OVSSC loop on several cards, against one process.

Launched as users launch the train CLI, one process a card:

    python -m torch.distributed.run --nproc_per_node 4 scripts/torch_ddp_cards.py \
        [--steps 10] [--compared 3]

Every rank runs the port's ``runtime.experiment`` at full width
(``build_setup`` + ``train`` of ``SemAbs3DConfig()`` at the train CLI's
defaults, bf16, ``--batch_size 1``: one row a rank) over
``chip_smoke.MemoryScenes`` fed by 4 loader threads, the step under DDP over
NCCL. Before training, the eval half runs on the initial weights in f32:
``run_eval_split(gather=True)`` over 6 in-memory eval scenes, each rank a
shard (the wrap-pad duplicates NaN'd), the frames and per-sample scalars
gathered with ``all_gather_object``. Every rank's gathered frame and, after
training, every rank's parameters must be identical. Then the group is torn
down and rank 0 runs the same in one process at ``--batch_size`` = the
world size (the same global batches, as the sampler shards its shuffled
order by stride): the first ``--compared`` steps' loss and grad norm within
rtol 1e-3 and 1e-2 (bf16 steps whose sums run in another order: phase 16
of ``chip_smoke.py``), the eval frame's rows equal and its metrics within
1e-3. Rank 0 prints steps/s of both runs, the loader wait, peak memory and
the K3 launches a step, with the cards' name and power limit.

``--device cpu --tiny`` rehearses it on the CPU over gloo at the small
widths of ``tests/test_cli_train.py`` (launches are not counted there).
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TINY = ["--voxel_shape", "16", "16", "16", "--unet_f_maps", "4", "--unet_num_channels", "8",
        "--unet_num_groups", "2", "--unet_num_levels", "3",
        "--pts_feat_extractor_hidden_dim", "16"]
EVAL_SCENES = 6


def loop_args(batch_size: int, device: str, tiny: bool):
    from semantic_abstraction_tpu_torch.cli import common

    return common.config_parser().parse_args(
        ["--file_path", "(in memory)", "--epochs", "1", "--eval_freq", "1000",
         "--save_freq", "1000", "--num_workers", "4", "--seed", "0",
         "--batch_size", str(batch_size), "--device", device] + (TINY if tiny else []))


def run(args, steps: int, tiny: bool, length: int):
    """The eval half on the initial weights, then ``steps`` loader-fed
    train steps over ``length`` in-memory items (one length for both runs:
    the sampler's shuffle depends on it) -> (eval frame, eval means, timing
    record, launches, peak GB, the state)."""
    import torch

    import chip_smoke
    from semantic_abstraction_tpu_torch.data import DataLoader, ShardedSampler
    from semantic_abstraction_tpu_torch.ops.channel_moments import (
        channel_moments, channel_moments_backward)
    from semantic_abstraction_tpu_torch.runtime import experiment as exp
    from semantic_abstraction_tpu_torch.runtime.train import make_eval_step

    size = dict(h=48, w=64, rel_h=24, rel_w=32, full_pts=5000, num_input=512,
                num_output=1024) if tiny else {}
    cuda = torch.device(args.device).type == "cuda"
    train_ds = chip_smoke.MemoryScenes("ovssc", length=length, **size)
    setup = exp.build_setup(args, "ovssc", "semantic_abstraction", {"train": train_ds})
    dp = setup["data_parallel"]
    shards, shard_id = ((torch.distributed.get_world_size(), torch.distributed.get_rank())
                        if dp else (1, 0))
    eval_ds = chip_smoke.MemoryScenes("ovssc", n_scenes=EVAL_SCENES, length=EVAL_SCENES,
                                      seed=100, **size)
    loader = DataLoader(eval_ds, batch_size=1, num_workers=2,
                        sampler=ShardedSampler(EVAL_SCENES, num_shards=shards,
                                               shard_id=shard_id, shuffle=False))
    eval_step = make_eval_step(setup["forward_loss"], setup["cfg"],
                               compute_dtype=torch.float32)
    means, frame = exp.run_eval_split(
        setup["state"], eval_step, loader, "ovssc", eval_ds.cfg.scene_bounds,
        exp.eval_cutoffs_for("ovssc", detailed=True), ((32, 32, 32),),
        device=setup["device"], gather=dp)
    timings = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    channel_moments.launches = channel_moments_backward.launches = 0
    with tempfile.TemporaryDirectory() as log_dir:
        exp.train(args, setup, log_dir=log_dir, max_steps_per_epoch=steps, timings=timings)
    launches = {"channel_moments": channel_moments.launches,
                "channel_moments_backward": channel_moments_backward.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    return frame, means, timings[0], launches, peak, setup["state"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--compared", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="small widths and scenes: a CPU rehearsal")
    opts = ap.parse_args()

    import numpy as np
    import pandas as pd
    import torch
    import torch.distributed as dist

    import chip_smoke
    from semantic_abstraction_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.maybe_initialize_distributed(opts.device)
    if not parallel.is_initialized():
        raise SystemExit("launch with python -m torch.distributed.run --nproc_per_node N")
    world, rank = parallel.world_size(), parallel.rank()
    card = chip_smoke.card_line() if device.type == "cuda" else "cpu"

    length = opts.steps * world + 1
    frame, means, rec, launches, peak, state = run(
        loop_args(1, str(device), opts.tiny), opts.steps, opts.tiny, length)
    digest = float(sum(p.detach().double().sum().item() + p.detach().double().abs().sum().item()
                       for p in state.model.parameters()))
    gathered = parallel.all_gather_host_objects({
        "frame": int(pd.util.hash_pandas_object(frame, index=False).sum()),
        "digest": digest, "record": rec, "launches": launches, "peak": peak})
    backend = dist.get_backend()
    parallel.destroy_distributed()
    if rank != 0:
        return
    if len({g["frame"] for g in gathered}) != 1 or len({g["digest"] for g in gathered}) != 1:
        raise AssertionError(f"the ranks' eval frames or parameters differ: {gathered}")
    for g in gathered:
        per_step = {k: n / g["record"]["steps"] for k, n in g["launches"].items()}
        if device.type == "cuda" and per_step != {"channel_moments": 33.0,
                                                  "channel_moments_backward": 33.0}:
            raise AssertionError(f"moments launches a step {per_step}")

    sframe, smeans, srec, _, speak, _ = run(
        loop_args(world, str(device), opts.tiny), opts.compared, opts.tiny, length)
    worst = {}
    for k, tol in (("losses", 1e-3), ("grad_norms", 1e-2)):
        a = np.asarray(rec[k][:opts.compared])
        b = np.asarray(srec[k])
        worst[k] = float(np.max(np.abs(a - b) / np.abs(b)))
        if worst[k] > tol:
            raise AssertionError(f"{k}: {world} ranks {a.tolist()} one process {b.tolist()}")
    key = ["scene_id", "label", "cutoff"]
    metrics = [c for c in sframe.columns if "iou" in c or "precision" in c or "recall" in c]
    a = frame.dropna(subset=metrics).sort_values(key).reset_index(drop=True)
    b = sframe.dropna(subset=metrics).sort_values(key).reset_index(drop=True)
    if len(a) != len(b) or not (a[key].to_numpy() == b[key].to_numpy()).all() \
            or a["scene_id"].nunique() != EVAL_SCENES:
        raise AssertionError(f"eval rows: {len(a)} gathered, {len(b)} in one process")
    eval_gap = float(np.nanmax(np.abs(a[metrics].to_numpy() - b[metrics].to_numpy())))
    if eval_gap > 1e-3:
        raise AssertionError(f"eval metrics differ by {eval_gap}")
    print(json.dumps({
        "world": world, "backend": backend, "card": card,
        "ranks": [{"steps_per_s": g["record"]["steps"] / g["record"]["wall_s"],
                   "loader_wait_s": g["record"]["loader_wait_s"],
                   "wall_s": g["record"]["wall_s"], "peak_gb": g["peak"],
                   "launches": g["launches"]} for g in gathered],
        "one_process": {"batch_size": world, "steps_per_s": srec["steps"] / srec["wall_s"],
                        "loader_wait_s": srec["loader_wait_s"], "peak_gb": speak},
        "losses": rec["losses"], "grad_norms": rec["grad_norms"],
        "one_process_losses": srec["losses"], "one_process_grad_norms": srec["grad_norms"],
        "worst_relative_gap": worst, "eval_rows": len(a), "eval_metric_gap": eval_gap,
        "eval_means": means, "one_process_eval_means": smeans}))


if __name__ == "__main__":
    main()
