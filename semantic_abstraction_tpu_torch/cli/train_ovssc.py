"""OVSSC training CLI of the port (reference: train_ovssc.py:172-197).

  python -m semantic_abstraction_tpu_torch.cli.train_ovssc \
      --file_path DATASET_DIR --log LOGDIR [--approach ...] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given. Data-parallel over N
cards (DDP, one process a card; ``--batch_size`` per card)::

  python -m torch.distributed.run --nproc_per_node N \
      -m semantic_abstraction_tpu_torch.cli.train_ovssc --num_devices N ...
"""
from __future__ import annotations


def main(argv=None):
    from . import common

    parser = common.config_parser()
    parser.add_argument("--log", type=str, required=True)
    parser.add_argument(
        "--approach",
        choices=["semantic_abstraction", "semantic_aware"],
        default="semantic_abstraction",
    )
    args = parser.parse_args(argv)
    if args.approach == "semantic_aware":
        args.network_inputs = ["rgb"]  # reference train_ovssc.py:185-186
    from ..clip.model import resolve_device
    from ..parallel import destroy_distributed, rank

    try:
        common.start_distributed(args)  # multi-process (reference utils.py:131-137)
        resolve_device(args.device)  # fail before anything is written
        common.setup_logging()
        if rank() == 0:
            common.save_args(args.log, args)

        from ..runtime.experiment import setup_experiment, train

        setup = setup_experiment(args, task="ovssc", approach=args.approach)
        train(args, setup)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
