"""Shared CLI config: the argparse surface of the reference config_parser.

Counterpart of ``semantic_abstraction_tpu/cli/common.py`` (reference
utils.py:35-113): the same flags and defaults for everything that changes a
result, plus ``--device`` (``cuda`` unless ``--device cpu`` is given; no
silent fallback to the CPU).

Not ported:
- ``enable_persistent_compile_cache``: a JAX compile cache; the port's CUDA
  kernels are cached by ``ops/_build.py`` under ``ops/.build/``.
- ``--wire_dtype``: a narrowed host-to-device transfer for a remote TPU
  link; the card's PCIe copies f32 as it is.

``--num_devices`` is the data-parallel group: one process a card, launched
with ``python -m torch.distributed.run --nproc_per_node N``
(``start_distributed``); 1 turns DDP off.

An ``args.pkl`` written by the JAX package's CLIs (which holds
``wire_dtype`` and ``num_devices``) still loads: ``load_args`` returns its
keys as they are, and the eval CLI keeps its own ``num_devices``.
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--file_path", type=str, required=True)
    p.add_argument("--voxel_shape", type=int, nargs=3, default=[128, 128, 128])
    p.add_argument("--load", type=str)
    p.add_argument("--batch_size", type=int, default=1,
                   help="per-device batch (the reference's batch-1-per-GPU regime)")
    p.add_argument("--num_warmup_steps", type=int, default=1024)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=5)
    p.add_argument("--num_devices", type=int, default=None,
                   help="cards in the data-parallel group (the world size when unset; "
                        "1 turns DDP off); launch with python -m "
                        "torch.distributed.run --nproc_per_node N")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked for")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--num_descs", type=int, default=4)
    p.add_argument("--saliency_vmin", type=float, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--grad_max_norm", type=float, default=2.0)
    p.add_argument("--xyz_pts_noise", type=float, default=0.0)
    p.add_argument("--num_input_pts", type=int, default=80000)
    p.add_argument("--num_output_pts", type=int, default=400000)
    p.add_argument("--pointing_dim", type=int, default=64)
    p.add_argument("--unet_f_maps", type=int, default=16)
    p.add_argument("--unet_num_channels", type=int, default=16)
    p.add_argument("--unet_num_groups", type=int, default=8)
    p.add_argument("--unet_num_levels", type=int, default=6)
    p.add_argument("--num_patches", type=int, default=4)
    p.add_argument("--patch_mask_cutoff", type=float, default=0.004)
    p.add_argument("--domain_randomization", action="store_true", default=True)
    p.add_argument("--no_domain_randomization", dest="domain_randomization",
                   action="store_false")
    p.add_argument("--use_pts_feat_extractor", action="store_true", default=True)
    p.add_argument("--pts_feat_extractor_hidden_dim", type=int, default=128)
    p.add_argument("--subtract_mean_relevancy", action="store_true", default=True)
    p.add_argument("--offset_patch_mask", action="store_true", default=False)
    p.add_argument("--balance_positive_negative", action="store_true", default=False)
    p.add_argument("--balance_spatial_relations", action="store_true", default=True)
    p.add_argument("--always_replace_subsample_pts", action="store_true",
                   default=False)
    p.add_argument("--balance_spatial_sampling", action="store_true", default=True)
    p.add_argument("--decoder_concat_xyz_pts", action="store_true", default=True)
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="device compute dtype (replaces --use_amp)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--dr_pos", type=float, default=0.1)
    p.add_argument("--dr_orn", type=float, default=0.3)
    p.add_argument("--dr_scale", type=float, default=0.1)
    p.add_argument(
        "--scene_bounds", type=float, nargs=6,
        default=[-1.0, -1.0, -0.1, 1.0, 1.0, 1.9],
    )
    p.add_argument(
        "--pointing_method",
        choices=["cosine_sim", "dot_product", "additive"],
        default="cosine_sim",
    )
    p.add_argument("--saliency_config", choices=["ours", "chefer_et_al"],
                   default="ours")
    p.add_argument(
        "--network_inputs", nargs="+",
        choices=["patch_masks", "saliency", "rgb", "tsdf"],
        default=["saliency"],
    )
    p.add_argument(
        "--lr_scheduler_type",
        choices=["constant", "linear", "cosine", "cosine_with_restarts",
                 "constant_with_warmup"],
        default="cosine_with_restarts",
    )
    p.add_argument("--reduce_method", choices=["max", "mean"], default="max")
    return p


def start_distributed(args) -> None:
    """What a CLI does first: join the process group of a multi-process
    launch (``parallel.maybe_initialize_distributed``; ``args.device``
    becomes this rank's card, ``cuda:LOCAL_RANK``) and check
    ``--num_devices`` against the world size (``mesh_size_from_args``
    raises on another value than 1 or the world size)."""
    from ..parallel import maybe_initialize_distributed, mesh_size_from_args

    args.device = str(maybe_initialize_distributed(args.device))
    mesh_size_from_args(args)


def save_args(log_dir: str, args) -> None:
    """args.pkl snapshot + diff-on-restart (reference utils.py:145-172)."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "args.pkl")
    d = vars(args).copy()
    if os.path.exists(path):
        old = load_args(path)
        diffs = {
            k: (old.get(k), d.get(k))
            for k in set(old) | set(d)
            if old.get(k) != d.get(k) and k not in ("load",)
        }
        if diffs:
            logging.warning("args changed since last run: %s", diffs)
    with open(path, "wb") as fp:
        pickle.dump(d, fp)


def load_args(path: str) -> dict:
    """Load an args.pkl as a dict. The reference pickles the raw
    argparse.Namespace (reference utils.py:160-172), so released-artifact
    args.pkl files arrive as Namespaces; both formats come back as a dict."""
    with open(path, "rb") as fp:
        obj = pickle.load(fp)
    return obj if isinstance(obj, dict) else vars(obj)


def setup_logging():
    """INFO on rank 0, warnings and errors only on the other ranks
    (reference utils.py:139-142)."""
    from ..parallel import rank

    level = logging.INFO if rank() == 0 else logging.WARNING
    try:
        from rich.logging import RichHandler

        logging.basicConfig(level=level, format="%(message)s", handlers=[RichHandler()])
    except ImportError:
        logging.basicConfig(level=level)
