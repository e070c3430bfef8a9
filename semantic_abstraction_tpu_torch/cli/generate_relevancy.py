"""Relevancy-generation CLI of the port: the ``image`` demo and the
``dataset`` HDF5 writer.

Counterpart of ``semantic_abstraction_tpu/cli/generate_relevancy.py``. Runs
on ``cuda`` unless ``--device cpu`` is given.

Usage:
  python -m semantic_abstraction_tpu_torch.cli.generate_relevancy image IMG \
      [--labels ...] [--random-weights | --clip-ckpt PATH] [--device cpu]
  python -m semantic_abstraction_tpu_torch.cli.generate_relevancy dataset DIR \
      [--num-shards N --shard-id I] [--store-shape H W] [--overwrite] \
      [--random-weights | --clip-ckpt PATH] [--device cpu]

``build_saliency`` and ``relevancy`` need neither ``imageio`` nor
``matplotlib``; only reading the image file and writing the PNG import them.

The ``dataset`` writer keeps the JAX package's semantics: the per-scene
label set (``_scene_labels``), the THOR / matterport / nyu prompt switch,
the producible-key resume check, the per-scene seed ``--seed + index``, the
store shape (a preallocated ``saliencies`` dataset first, then
``--store-shape``), the truncation on rewrite and the foreign-group
warning, the features normalised at write with the mean row taken from the
raw features, ``astype("S")`` labels, and skip-and-continue on a failing
scene. It is split so that the card can drive it without h5py:

- ``extract_scene``: ``get_clip_saliency``, then the nearest-exact
  downsample to the store shape as an index gather on the device;
- ``pipelined``: runs the extraction one scene deep. It copies scene i's
  tensors into pinned host memory on a side stream (``non_blocking``),
  records an event, dispatches scene i + 1, and hands scene i to ``write``
  only once that event has completed;
- ``cmd_dataset`` passes the HDF5 writer (``h5py``, ``filelock``).

``--label-bucket`` (padding the label count for the TPU compile cache) is
not ported: the card runs any label count without a recompile.
"""
from __future__ import annotations

import argparse
import functools
import logging
import time
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence

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
# the dataset writer's default for simulator corpora; real-photo sets
# (matterport/nyu in the path) switch to DEFAULT_PROMPT
# (reference generate_relevancy.py:154-158)
THOR_PROMPT = "a render of a {} in a game engine."


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


@functools.lru_cache(maxsize=16)
def nearest_exact_indices(in_hw, out_hw):
    """Row and column indices of a nearest-exact (..., H, W) -> (..., h, w)
    resize, torch ``F.interpolate(mode="nearest-exact")``'s, computed as the
    JAX package's ``_nearest_exact_device`` does."""
    (h, w), (oh, ow) = tuple(in_hw), tuple(out_hw)
    ri = np.minimum(((np.arange(oh) + 0.5) * (h / oh)).astype(np.int64), h - 1)
    ci = np.minimum(((np.arange(ow) + 0.5) * (w / ow)).astype(np.int64), w - 1)
    return ri, ci


def nearest_exact(maps: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-exact resize of (..., H, W) maps as one index gather on their
    device: the writer reads back maps at the store shape."""
    ri, ci = nearest_exact_indices(tuple(maps.shape[-2:]), tuple(out_hw))
    ri = torch.as_tensor(ri, device=maps.device)
    ci = torch.as_tensor(ci, device=maps.device)
    return maps[..., ri[:, None], ci[None, :]]


def extract_scene(sal, img: np.ndarray, labels: Sequence[str], prompt: str,
                  saliency_config: str, seed: int, store_shape=None):
    """One image's ((L, h, w) float16 maps at ``store_shape``, (L, E) text
    features) on the extractor's device. Crops are sized from the image's
    short side (reference generate_relevancy.py:75-80) and the jitter draws
    from ``torch.Generator().manual_seed(seed)``."""
    from ..clip import saliency_configs

    config = saliency_configs[saliency_config](min(img.shape[:2]))
    maps, feats = sal.get_clip_saliency(
        img, list(labels), [prompt], config,
        generator=torch.Generator().manual_seed(seed))
    if store_shape and tuple(maps.shape[1:]) != tuple(store_shape):
        maps = nearest_exact(maps, store_shape)
    return maps, feats


class _Copy:
    """The host copy of one item's tensors: pinned buffers filled on a side
    stream after the ``ready`` event of the extraction's stream, and the
    events around the fill. On the CPU the host arrays are the tensors."""

    def __init__(self, tensors: List[torch.Tensor], ready=None):
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self.ready = ready
        self.start = self.done = None
        if ready is None:
            self.host = tensors
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        stream = _copy_stream(tensors[0].device)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(stream)
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)  # not reused until the copy is done
            self.done = torch.cuda.Event(enable_timing=True)
            self.done.record(stream)

    def arrays(self) -> List[np.ndarray]:
        """The host arrays, once the copy has completed (``wait_ms``: how
        long the host waited for it); the buffers are released from this
        object."""
        self.wait_ms = 0.0
        if self.done is not None:
            t0 = time.perf_counter()
            self.done.synchronize()
            self.wait_ms = 1e3 * (time.perf_counter() - t0)
        host, self.host = self.host, None
        return [h.numpy() for h in host]


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device):
    return torch.cuda.Stream(device=device)


def pipelined(items: Iterable, extract: Callable, write: Callable,
              device=None, on_error: Optional[Callable] = None,
              stats: Optional[list] = None) -> int:
    """Run ``extract(item)`` (a list of tensors on ``device``) one item
    deep: on the card, item i's tensors are copied to pinned host memory on
    a side stream while item i + 1 is dispatched, and ``write(item,
    arrays)`` gets item i's numpy arrays only after its copy event has
    completed. On the CPU the arrays are the tensors' own.

    A failing extraction or write is handed to ``on_error(item, exc)``
    (raised when None) and the sweep goes on. With a ``stats`` list, one
    dict per written item: ``bytes`` copied, ``copy_ms`` (device time of
    the copy), ``overlapped`` (whether the copy's interval on the device
    met the next item's extraction; None for the last item and on the CPU)
    and ``wait_ms`` (how long the host waited for the copy before the
    write). Returns the number of failures."""
    on_card = torch.device(device if device is not None else "cpu").type == "cuda"
    failures = 0
    pending = None  # (item, _Copy, extraction begin event)
    done = []

    def fail(item, exc):
        nonlocal failures
        failures += 1
        if on_error is None:
            raise exc
        on_error(item, exc)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def finish(job):
        item, copy, _ = job
        try:
            write(item, copy.arrays())
            done.append(job)
        except Exception as exc:  # noqa: BLE001 - one scene must not end the sweep
            fail(item, exc)

    for item in items:
        try:
            begin = event() if on_card else None
            tensors = list(extract(item))
            job = (item, _Copy(tensors, event() if on_card else None), begin)
        except Exception as exc:  # noqa: BLE001
            fail(item, exc)
            continue
        if pending is not None:
            finish(pending)
        pending = job
    if pending is not None:
        finish(pending)
    if stats is not None:
        stats.extend(_copy_stats(done))
    return failures


def _copy_stats(done) -> List[dict]:
    out = []
    for k, (_, copy, _) in enumerate(done):
        row = {"bytes": copy.nbytes, "copy_ms": None, "overlapped": None,
               "wait_ms": copy.wait_ms}
        if copy.done is not None:
            row["copy_ms"] = copy.start.elapsed_time(copy.done)
            if k + 1 < len(done):
                nxt_copy, nxt_begin = done[k + 1][1], done[k + 1][2]
                # the copy ended after the next extraction began, and began
                # before that extraction's last kernel ended
                row["overlapped"] = bool(
                    nxt_begin.elapsed_time(copy.done) > 0
                    and copy.start.elapsed_time(nxt_copy.ready) > 0)
        out.append(row)
    return out


def _scene_labels(f, use_gt=True):
    """Assemble the per-scene label set: visible classes + description
    sentences + synonyms + 'mean' (reference generate_relevancy.py:225-346).
    The JAX package's function, on the port's synonym table."""
    from ..data.datasets import SYNONYMS
    from ..data.hdf5 import deref_h5py

    g = f["data"]
    object_labels = np.array(g["objid_to_class"]).astype(str)
    # the visible-only path needs BOTH seg and full_objid_pts (the
    # reference's scene_has_groundtruth gate, generate_relevancy.py:229-231);
    # a seg-only scene falls back to ALL objid classes
    has_gt = use_gt and "seg" in g and "full_objid_pts" in g
    if has_gt:
        visible = set(
            np.unique(deref_h5py(f["seg"], g["seg"])[0]).astype(int).tolist()
        ) - {-1}
        labels = {
            str(object_labels[objid]) for objid in visible
            if 0 <= objid < len(object_labels)
        }
    else:
        labels = set(object_labels.tolist())
    if "descriptions" in g:
        dg = g["descriptions"]
        t = np.array(dg["target_obj_name"]).astype(str)
        r = np.array(dg["reference_obj_name"]).astype(str)
        rel = np.array(dg["spatial_relation_name"]).astype(str)
        labels.update(t.tolist())
        labels.update(r.tolist())
        for a, b, c in zip(t, rel, r):
            labels.add(f"{a} {b} a {c}")
            # the synonym-mapped sentence is always added (reference
            # generate_relevancy.py:301-329; identical ones collapse)
            labels.add(f"{SYNONYMS.get(a, a)} {b} a {SYNONYMS.get(c, c)}")
    # reference order over the whole union (generate_relevancy.py:330-346):
    # bracket-strip, add synonyms, remove the placeholder labels, one sort
    labels = {l.split("[")[0].lstrip().rstrip() for l in labels}
    labels |= {SYNONYMS[l] for l in labels if l in SYNONYMS}
    labels -= {"unlabelled", "empty", "out of bounds"}
    return sorted(labels)


def dataset_prompt(args) -> str:
    """``--prompt``, else the game-engine prompt for simulator corpora and
    the photo prompt for matterport/nyu paths (reference :154-158)."""
    if args.prompt is not None:
        return args.prompt
    real_photos = "matterport" in args.file_path or "nyu" in args.file_path
    return DEFAULT_PROMPT if real_photos else THOR_PROMPT


def _read_scene(path, args, rgb_keys):
    """The scene's (labels, store shape, {rgb key: image}), or None when
    every producible key is done and ``--overwrite`` is off."""
    import h5py

    from ..data.hdf5 import deref_h5py

    with h5py.File(path, "r") as f:
        # datagen stores a zeros(1) placeholder when no domain-randomized
        # frame exists (reference generate_thor_data.py:788,979); the done
        # check covers only the keys the scene can produce
        present = [k for k in rgb_keys if k == "rgb" or (
            k in f["data"] and len(np.array(f["data"][k])[0].shape) > 1)]
        done = all(f"data/saliencies/{k}|{args.saliency_config}" in f for k in present)
        if done and not args.overwrite:
            return None
        labels = _scene_labels(f)
        # a preallocated `saliencies` (the datagen schema) fixes the store
        # shape before dispatch; the maps are cut to it on the device
        store_shape = (tuple(f["saliencies"].shape[1:]) if "saliencies" in f
                       else (tuple(args.store_shape) if args.store_shape else None))
        images = {}
        for k in present:
            if k == "rgb":
                # one frame only (the reference indexes a single region ref)
                images[k] = deref_h5py(f["rgb"], f["data/rgb"][:1])[0].astype(np.uint8)
            else:
                images[k] = np.array(f["data"][k][0]).astype(np.uint8)
    return labels, store_shape, images


def scene_rows(maps: np.ndarray, feats: np.ndarray):
    """The rows a scene stores: the (L + 1, h, w) float32 maps with their
    mean appended, and the (L + 1, E) features with the mean of the raw
    features appended, every row normalized (reference
    generate_relevancy.py:108-118)."""
    maps = np.asarray(maps, np.float32)
    feats = np.asarray(feats, np.float32)
    maps = np.concatenate([maps, maps.mean(axis=0, keepdims=True)], axis=0)
    feats = np.concatenate([feats, feats.mean(axis=0, keepdims=True)], axis=0)
    return maps, feats / np.linalg.norm(feats, axis=-1, keepdims=True)


def write_scene(path, all_labels: List[str], results, args) -> None:
    """One scene's relevancies into its HDF5 file under a FileLock:
    ``results`` = [(rgb key, (L, h, w) maps, (L, E) features)] as host
    arrays. The JAX package's ``write_out``."""
    import h5py
    from filelock import FileLock

    from ..data.hdf5 import resize_and_add_data
    from ..data.transforms import resize_nearest_exact_np

    first_key = results[0][0] if results else None
    for rgb_key, maps, feats in results:
        maps, feats = scene_rows(maps, feats)
        prefix = f"data/saliencies/{rgb_key}|{args.saliency_config}"
        with FileLock(str(path) + ".lock"):
            with h5py.File(path, "a") as f:
                # A rewrite appends rows but replaces only the refs, so old
                # rows would leak and the readers' absolute 'mean' row
                # lookup (dataset.py:824-834) would hit a stale map: when
                # every existing group belongs to the keys being rewritten,
                # start over from row 0; with foreign groups, append.
                if (rgb_key == first_key and "saliencies" in f
                        and f["saliencies"].shape[0]):
                    rewriting = {f"{k}|{args.saliency_config}" for k, _, _ in results}
                    existing = set(f.get("data/saliencies", {}))
                    existing -= {e for e in existing
                                 if e.split("|saliency_text_")[0] in rewriting}
                    if not existing:
                        f["saliencies"].resize((0,) + f["saliencies"].shape[1:])
                    else:
                        logging.warning(
                            "%s: appending saliency rows after foreign groups "
                            "(%s); the readers' absolute 'mean' row will resolve "
                            "to the FIRST group's map (reference quirk)",
                            Path(path).name, sorted(existing)[:3])
                # a preallocated `saliencies` wins over --store-shape:
                # appends must match the dataset
                store_shape = (tuple(f["saliencies"].shape[1:]) if "saliencies" in f
                               else (tuple(args.store_shape) if args.store_shape
                                     else None))
                if store_shape and maps.shape[1:] != store_shape:
                    maps = resize_nearest_exact_np(maps, store_shape).astype(np.float32)
                if prefix in f:
                    del f[prefix]
                for suffix in ("|saliency_text_labels", "|saliency_text_label_features"):
                    if prefix + suffix in f:
                        del f[prefix + suffix]
                if "saliencies" not in f:
                    f.create_dataset(
                        "saliencies", shape=(0,) + maps.shape[1:],
                        maxshape=(None,) + maps.shape[1:],
                        chunks=(1,) + maps.shape[1:],
                        compression="gzip", compression_opts=9, dtype="f",
                    )
                refs = resize_and_add_data(f["saliencies"], maps)
                f[prefix] = np.array(refs, dtype=h5py.regionref_dtype)
                # astype("S") sizes to the longest label (reference :360)
                f[prefix + "|saliency_text_labels"] = np.array(all_labels).astype("S")
                f[prefix + "|saliency_text_label_features"] = feats


def cmd_dataset(args) -> int:
    """Write every scene's relevancies; returns the number of scenes that
    failed and were skipped."""
    sal = build_saliency(args)
    prompt = dataset_prompt(args)
    logging.info("prompt: %r", prompt)
    scene_files = sorted(Path(args.file_path).glob("**/*.hdf5"))
    scene_files = scene_files[args.shard_id::args.num_shards]
    logging.info("processing %d scenes", len(scene_files))
    rgb_keys = ["rgb"] + (["domain_randomized_rgb"] if args.include_domain_randomized else [])
    failures = 0

    def on_error(item, exc):
        logging.error("scene %s failed; continuing", item[1].name,
                      exc_info=(type(exc), exc, exc.__traceback__))

    def scenes():
        nonlocal failures
        for si, path in enumerate(scene_files):
            # the reference's Ray pool respawns dead actors and goes on
            # (generate_relevancy.py:376-390): a corrupt file is skipped
            try:
                scene = _read_scene(path, args, rgb_keys)
            except Exception as exc:  # noqa: BLE001
                failures += 1
                on_error((si, path), exc)
                continue
            if scene is None or not scene[0]:
                continue
            logging.info("[%d/%d] %s: %d labels", si + 1, len(scene_files),
                         path.name, len(scene[0]) + 1)
            yield si, path, scene

    def extract(item):
        si, _, (labels, store_shape, images) = item
        out = []
        for img in images.values():
            out += extract_scene(sal, img, labels, prompt, args.saliency_config,
                                 args.seed + si, store_shape)
        return out

    def write(item, arrays):
        _, path, (labels, _, images) = item
        results = [(k, arrays[2 * i], arrays[2 * i + 1]) for i, k in enumerate(images)]
        write_scene(path, labels + ["mean"], results, args)

    failures += pipelined(scenes(), extract, write, sal.device, on_error)
    if failures:
        logging.warning("%d scene(s) failed and were skipped", failures)
    return failures


def _add_common(p):
    p.add_argument("--clip-ckpt", type=str, default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--tile_batch_size", type=int, default=32)
    p.add_argument("--saliency_config", choices=["ours", "chefer_et_al"],
                   default="ours")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked for")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="generate_relevancy")
    sub = p.add_subparsers(dest="command", required=True)
    pi = sub.add_parser("image", help="single-image relevancy demo")
    pi.add_argument("file_path", type=str, nargs="?", default="matterport.png")
    pi.add_argument("--labels", type=str, nargs="+", default=DEFAULT_LABELS)
    pi.add_argument("--output", type=str, default="grads.png")
    pi.add_argument("--prompt", type=str, default=None,
                    help="CLIP prompt template (default: the photo prompt)")
    _add_common(pi)
    pd = sub.add_parser("dataset", help="write relevancies into scene HDF5s")
    pd.add_argument("file_path", type=str)
    pd.add_argument("--num-shards", dest="num_shards", type=int, default=1)
    pd.add_argument("--shard-id", dest="shard_id", type=int, default=0)
    pd.add_argument("--overwrite", action="store_true")
    pd.add_argument("--include-domain-randomized", action="store_true")
    pd.add_argument("--store-shape", type=int, nargs=2, default=None)
    pd.add_argument("--prompt", type=str, default=None,
                    help="CLIP prompt template; by default the game-engine "
                         "prompt, and the photo prompt for matterport/nyu paths")
    _add_common(pd)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.command == "image":
        cmd_image(args)
    else:
        cmd_dataset(args)


if __name__ == "__main__":
    main()
