"""VOOL training CLI of the port (reference: train_vool.py:209-233).

  python -m semantic_abstraction_tpu_torch.cli.train_vool \
      --file_path DATASET_DIR --log LOGDIR [--approach ...] [--clip-ckpt PATH] \
      [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; over N cards with
``python -m torch.distributed.run --nproc_per_node N`` and ``--num_devices
N`` (DDP, one process a card).
"""
from __future__ import annotations


def make_text_encoder(args):
    """CLIP text features for SemanticAwareVOOL queries, cached by name
    (the reference calls ClipWrapper.get_clip_text_feature per batch,
    net.py:594-602). The CLIP is ``--clip-ckpt`` (an OpenAI ``.pt``), else
    ViT-B/32 with the JAX package's random weights of seed 0; it runs on
    ``args.device``. None for the other approaches."""
    if args.approach != "semantic_aware":
        return None
    import numpy as np

    from ..clip import VIT_B_32, ClipSaliency, init_clip_params, load_clip_checkpoint

    if args.clip_ckpt:
        model, cfg = load_clip_checkpoint(args.clip_ckpt, device=args.device)
    else:
        model, cfg = init_clip_params(0, VIT_B_32, device=args.device), VIT_B_32
    sal = ClipSaliency(model, cfg)
    cache = {}

    def encode(names):
        missing = sorted({n for n in names if n not in cache})
        if missing:
            feats = sal.text_features(missing).cpu().numpy()
            for n, f in zip(missing, feats):
                cache[n] = f
        return np.stack([cache[n] for n in names])

    return encode


def main(argv=None):
    from . import common

    parser = common.config_parser()
    parser.add_argument("--log", type=str, required=True)
    parser.add_argument(
        "--approach",
        choices=["semantic_abstraction", "semantic_aware", "clip_spatial"],
        default="semantic_abstraction",
    )
    parser.add_argument("--clip-ckpt", type=str, default=None)
    args = parser.parse_args(argv)
    if args.approach == "semantic_aware":
        args.network_inputs = ["rgb"]
    from ..clip.model import resolve_device
    from ..parallel import destroy_distributed, rank

    try:
        common.start_distributed(args)
        resolve_device(args.device)  # fail before anything is written
        common.setup_logging()
        if rank() == 0:
            common.save_args(args.log, args)

        from ..runtime.experiment import setup_experiment, train

        setup = setup_experiment(args, task="vool", approach=args.approach)
        train(args, setup, text_encoder=make_text_encoder(args))
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
