"""Evaluation CLI of the port: the cutoff-sweep eval over every non-train
split.

Counterpart of ``semantic_abstraction_tpu/cli/eval.py`` (reference
eval.py:16-93). Restores the experiment's ``args.pkl`` next to the
checkpoint (every flag but file_path / load / task / num_devices /
max_batches / num_workers, and ``clip_ckpt`` unless one is given here;
``num_workers`` is pinned after the restore as the reference does), forces
batch 1, no domain randomization and no balanced sampling, sweeps the 25
cutoffs of ``arange(-2.5, 0, 0.1)`` in one pass per batch, voxelizes at
``--voxel_shapes`` (default 32 and 64) and writes ``<ckpt>_eval_stats.pkl``
through a temporary file and ``os.replace``. Needs pandas.

  python -m semantic_abstraction_tpu_torch.cli.eval \
      --file_path DATASET_DIR --load CKPT --task ovssc|vool [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given. Under
``python -m torch.distributed.run --nproc_per_node N`` with ``--num_devices
N`` each rank evaluates its shard of the scenes (reference eval.py:57-59;
the wrap-pad duplicates that equalize the shards are NaN'd), the frames
are gathered, and rank 0 writes them.
"""
from __future__ import annotations

import logging
import os


def main(argv=None):
    from . import common

    parser = common.config_parser()
    parser.add_argument("--task", choices=["ovssc", "vool"], required=True)
    parser.add_argument(
        "--approach",
        choices=["semantic_abstraction", "semantic_aware", "clip_spatial"],
        default="semantic_abstraction",
    )
    parser.add_argument("--clip-ckpt", type=str, default=None)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument(
        "--voxel_shapes", type=int, nargs="+", default=None,
        help="cubic voxelization sizes for detailed stats (default 32 64; "
             "NYU tables need 60, reference summarize.py:216)",
    )
    args = parser.parse_args(argv)
    from ..parallel import destroy_distributed

    try:
        _run(parser, args)
    finally:
        destroy_distributed()


def _run(parser, args):
    from . import common
    from ..parallel import data_parallel_from_args, rank, world_size

    common.start_distributed(args)
    common.setup_logging()
    if not args.load:
        parser.error("--load is required (checkpoint to evaluate)")
    if args.task == "ovssc" and args.approach == "clip_spatial":
        parser.error("clip_spatial is a VOOL-only approach")
    from ..clip.model import resolve_device

    resolve_device(args.device)  # fail before the datasets are read

    cli_num_workers = args.num_workers
    args_pkl = os.path.join(os.path.dirname(args.load), "args.pkl")
    if os.path.exists(args_pkl):
        saved = common.load_args(args_pkl)
        for k, v in saved.items():
            # keep the eval-invocation flags (the device among them); restore
            # clip_ckpt from training unless one is passed here (a
            # semantic_aware VOOL eval with random CLIP text features would
            # run to completion and log meaningless metrics)
            if k in ("file_path", "load", "task", "num_devices",
                     "max_batches", "num_workers", "device"):
                continue
            if k == "clip_ckpt" and args.clip_ckpt is not None:
                continue
            setattr(args, k, v)
        args.num_workers = cli_num_workers  # reference eval.py:29
    elif args.approach == "semantic_aware":
        # the train CLIs set this before saving args.pkl; without one the
        # dataset would emit 1-channel saliency features to an rgb model
        args.network_inputs = ["rgb"]
    args.domain_randomization = False
    args.batch_size = 1
    args.balance_spatial_sampling = False
    if (args.task == "vool" and args.approach == "semantic_aware"
            and not getattr(args, "clip_ckpt", None)):
        logging.warning(
            "semantic_aware VOOL eval without --clip-ckpt: text features "
            "come from a RANDOMLY-initialized CLIP and metrics will be "
            "meaningless"
        )

    import pandas as pd
    import torch

    from ..data import DataLoader, ShardedSampler
    from ..runtime.experiment import eval_cutoffs_for, run_eval_split, setup_experiment
    from ..runtime.train import make_eval_step

    setup = setup_experiment(args, task=args.task, approach=args.approach,
                             return_vis=True)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    eval_step = make_eval_step(setup["forward_loss"], setup["cfg"],
                               compute_dtype=compute_dtype)
    text_encoder = None
    if args.task == "vool" and args.approach == "semantic_aware":
        from .train_vool import make_text_encoder

        text_encoder = make_text_encoder(args)

    bounds = setup["datasets"][next(iter(setup["datasets"]))].cfg.scene_bounds
    cutoffs = eval_cutoffs_for(args.task, detailed=True)
    voxel_shapes = tuple((s, s, s) for s in (args.voxel_shapes or (32, 64)))
    stats_path = os.path.splitext(args.load)[0] + "_eval_stats.pkl"
    # sharded evaluation: one scene a rank at a time
    dp = data_parallel_from_args(args)
    shards, shard_id = (world_size(), rank()) if dp else (1, 0)
    all_stats = []
    for split, ds in setup["datasets"].items():
        if split == "train":
            continue
        loader = DataLoader(
            ds, batch_size=1, num_workers=args.num_workers,
            sampler=ShardedSampler(len(ds), num_shards=shards, shard_id=shard_id,
                                   shuffle=False, seed=args.seed),
        )
        means, detailed = run_eval_split(
            setup["state"], eval_step, loader, args.task, bounds, cutoffs,
            voxel_shapes=voxel_shapes, text_encoder=text_encoder,
            max_batches=args.max_batches, device=setup["device"], gather=dp,
        )
        detailed["split"] = split
        detailed["epoch"] = setup["start_epoch"]
        all_stats.append(detailed)
        logging.info("%s: %s", split, means)
        if rank() == 0:  # reference eval.py:90 rank guard
            tmp = stats_path + ".tmp"
            pd.concat(all_stats, ignore_index=True).to_pickle(tmp)
            os.replace(tmp, stats_path)
            logging.info("dumped stats to %s", stats_path)


if __name__ == "__main__":
    main()
