"""Relevancy-generation CLI of the port: the single-image ``image`` command.

Counterpart of ``semantic_abstraction_tpu/cli/generate_relevancy.py``
(``image`` only; the ``dataset`` HDF5 writer is not ported yet). Runs on
``cuda`` unless ``--device cpu`` is given.

Usage:
  python -m semantic_abstraction_tpu_torch.cli.generate_relevancy image IMG \
      [--labels ...] [--random-weights | --clip-ckpt PATH] [--device cpu]

``build_saliency`` and ``relevancy`` need neither ``imageio`` nor
``matplotlib``; only reading the image file and writing the PNG import them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

DEFAULT_LABELS = [
    "basketball jersey",
    "nintendo switch",
    "television",
    "ping pong table",
    "vase",
    "fireplace",
    "abstract painting of a vespa",
    "carpet",
    "wall",
]
DEFAULT_PROMPT = "a photograph of a {} in a home."


def build_saliency(args):
    """The extractor the flags ask for, on ``args.device``."""
    from ..clip import (VIT_B_32, ClipSaliency, init_clip_params,
                        load_clip_checkpoint, resolve_device)

    device = resolve_device(args.device)  # fail before building weights
    if args.clip_ckpt:
        model, cfg = load_clip_checkpoint(args.clip_ckpt, device=device)
    else:
        if not args.random_weights:
            raise SystemExit(
                "no --clip-ckpt given; pass --random-weights to run with "
                "randomly initialized CLIP (throughput/debug only)"
            )
        cfg = VIT_B_32
        model = init_clip_params(0, cfg, device=device)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    return ClipSaliency(model, cfg, compute_dtype=dtype,
                        tile_batch_size=args.tile_batch_size)


def relevancy(sal, img: np.ndarray, args) -> torch.Tensor:
    """(L, H, W) float16 relevancy of ``args.labels`` on an (H, W, 3) uint8
    image, with crops sized from the image height (reference image demo)."""
    from ..clip import saliency_configs

    prompt = DEFAULT_PROMPT if args.prompt is None else args.prompt
    config = saliency_configs[args.saliency_config](img.shape[0])
    maps, _ = sal.get_clip_saliency(
        img, args.labels, [prompt], config,
        generator=torch.Generator().manual_seed(args.seed),
    )
    return maps


def cmd_image(args):
    import imageio.v2 as imageio

    img = np.asarray(imageio.imread(args.file_path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3]
    if img.dtype != np.uint8:
        raise SystemExit(f"{args.file_path}: expected an 8-bit image, got {img.dtype}")
    sal = build_saliency(args)
    start = time.time()
    grads = relevancy(sal, img, args).float().cpu().numpy()
    print(f"get gradcam took {time.time() - start} seconds", grads.shape)
    grads = grads - grads.mean(axis=0)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(args.labels)
    rows = int(np.ceil(np.sqrt(n)))
    cols = int(np.ceil(n / rows))
    fig, axes = plt.subplots(rows, cols, squeeze=False)
    axes = axes.flatten()
    vmin, vmax = 0.002, 0.008
    cmap = plt.get_cmap("jet")
    for ax in axes:
        ax.axis("off")
    for ax, label_grad, label in zip(axes, grads, args.labels):
        ax.imshow(img)
        ax.set_title(label, fontsize=10)
        g = np.clip((label_grad - vmin) / (vmax - vmin), 0.0, 1.0)
        colored = cmap(g)
        colored[..., -1] = (1 - g) * 0.7
        ax.imshow(colored)
    plt.tight_layout(pad=0)
    plt.savefig(args.output)
    print(f"dumped relevancy to {args.output}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="generate_relevancy")
    sub = p.add_subparsers(dest="command", required=True)
    pi = sub.add_parser("image", help="single-image relevancy demo")
    pi.add_argument("file_path", type=str, nargs="?", default="matterport.png")
    pi.add_argument("--labels", type=str, nargs="+", default=DEFAULT_LABELS)
    pi.add_argument("--output", type=str, default="grads.png")
    pi.add_argument("--clip-ckpt", type=str, default=None)
    pi.add_argument("--random-weights", action="store_true")
    pi.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    pi.add_argument("--tile_batch_size", type=int, default=32)
    pi.add_argument("--saliency_config", choices=["ours", "chefer_et_al"],
                    default="ours")
    pi.add_argument("--prompt", type=str, default=None,
                    help="CLIP prompt template (default: the photo prompt)")
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--device", type=str, default="cuda",
                    help="torch device; the CPU only when asked for")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    cmd_image(args)


if __name__ == "__main__":
    main()
