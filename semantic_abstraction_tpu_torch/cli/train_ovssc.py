"""OVSSC training CLI of the port (reference: train_ovssc.py:172-197).

  python -m semantic_abstraction_tpu_torch.cli.train_ovssc \
      --file_path DATASET_DIR --log LOGDIR [--approach ...] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; one card.
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
    common.check_single_device(args)
    if args.approach == "semantic_aware":
        args.network_inputs = ["rgb"]  # reference train_ovssc.py:185-186
    from ..clip.model import resolve_device

    resolve_device(args.device)  # fail before anything is written
    common.setup_logging()
    common.save_args(args.log, args)

    from ..runtime.experiment import setup_experiment, train

    setup = setup_experiment(args, task="ovssc", approach=args.approach)
    train(args, setup)


if __name__ == "__main__":
    main()
