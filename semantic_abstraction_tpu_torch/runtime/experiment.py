"""Experiment orchestration: setup, train/eval loops, logging, resume, on
one card or data-parallel over several.

Counterpart of ``semantic_abstraction_tpu/runtime/experiment.py``
(reference utils.py: setup_experiment :122-215, loop :383-471, train
:474-614). The structure is the JAX package's: per-split datasets,
tensorboard writers when ``tensorboardX`` is installed, an epoch loop that
trains every epoch and evaluates the other splits every ``eval_freq``,
latest and periodic checkpoints, a cumulative ``detailed_stats.pkl``, and
the reference's swallow-and-continue split loop (a failing split is logged
with its traceback and the loop goes on).

What differs:
- One process a card (``cuda`` unless the caller asks for the CPU). Data
  parallelism is DDP over the default process group (``parallel/``), on
  when a group exists and ``--num_devices`` is not 1: ``--batch_size`` is
  per card, each rank loads its shard of the index space, the train step
  goes through DDP, eval gathers every rank's frames and per-sample scalars
  (``all_gather_host_objects``), and only rank 0 writes checkpoints,
  ``detailed_stats.pkl`` and tensorboard scalars. The ranks run their
  forwards apart, so JAX's multi-process assembly (``_local_rows``,
  ``_sync_padded_shapes``) has nothing to do here: each rank's frame pairs
  its own stats with its own meta columns. ``--wire_dtype`` is not ported.
- The net is ``models.init_net(args.seed, cfg, device)``, drawn from a
  ``torch.Generator``: its weights differ from JAX's ``PRNGKey(seed)`` ones
  by design (tests carry JAX's across with ``models.from_jax_params``).
- ``device_batch`` copies each array from pinned host memory with
  ``non_blocking=True``; the step's kernels follow the copies in stream
  order, so nothing waits on the host.
- The train loop keeps each step's loss, accuracy and grad norm on the
  device and reads them back every ``LOG_FLUSH`` steps (one sync per
  flush). It times on the host clock how long it waited in the loader's
  ``next`` for the batches it got (``loader_wait_s``; the last ``next``,
  which finds the loader exhausted, is not counted) and how long the host
  took to enqueue ``device_batch``'s copies (``device_batch_s``, not the
  copies: they run on the stream behind it), logged per epoch and
  appended to ``timings`` when the caller passes a list. The two are the
  spans ``sa.loop.wait`` and ``sa.loop.device_batch``; under the torch
  profiler the latter's stream time is the copy itself.
- pandas is imported only where a frame is built or read (the eval splits
  and ``detailed_stats.pkl``), so a train-only loop needs none.
- ``SEMABS_PROFILE_DIR=<dir>`` writes a ``torch.profiler`` chrome trace of
  the train steps the JAX package traces there (``SEMABS_PROFILE_STEPS``,
  default 3, sets how many).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..clip.model import resolve_device
from .. import parallel, trace
from ..data import (
    DataConfig,
    DataLoader,
    ObjectLocalizationDataset,
    SceneCompletionDataset,
    ShardedSampler,
)
from ..models import (
    ClipSpatialVOOLConfig,
    SemAbs3DConfig,
    SemanticAwareOVSSCConfig,
    SemanticAwareVOOLConfig,
    SemAbsVOOLConfig,
    init_net,
)
from .checkpoint import resume_checkpoint, save_checkpoint
from .metrics import detailed_stats_frame, eval_cutoffs_for, point_and_voxel_stats
from .train import (
    FORWARD_LOSS,
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

DEVICE_KEYS = {
    "ovssc": (
        "input_xyz_pts", "input_feature_pts", "output_xyz_pts",
        "output_label_pts", "out_of_bounds_pts", "out_of_frustum_pts_mask",
        "padding_mask", "semantic_class_features",
    ),
    "vool": (
        "input_xyz_pts", "input_target_saliency_pts",
        "input_reference_saliency_pts", "input_description_saliency_pts",
        "input_rgb_pts", "output_xyz_pts", "output_label_pts",
        "out_of_bounds_pts", "out_of_frustum_pts_mask", "padding_mask",
        "spatial_relation_id",
    ),
}
# train steps between read-backs of the logged scalars
LOG_FLUSH = 16


def _bounds_from_args(args):
    """argparse --scene_bounds arrives flat (6 floats) or nested."""
    b = args.scene_bounds
    return (((b[0], b[1], b[2]), (b[3], b[4], b[5])) if len(b) == 6
            else tuple(map(tuple, b)))


def completion_cfg_from_args(
    args, network_inputs=None, output_dim=1, decoder_concat_xyz_pts=None
) -> SemAbs3DConfig:
    return SemAbs3DConfig(
        voxel_shape=tuple(args.voxel_shape),
        scene_bounds=_bounds_from_args(args),
        unet_num_channels=args.unet_num_channels,
        unet_f_maps=args.unet_f_maps,
        unet_num_groups=args.unet_num_groups,
        unet_num_levels=args.unet_num_levels,
        network_inputs=tuple(network_inputs or args.network_inputs),
        use_pts_feat_extractor=args.use_pts_feat_extractor,
        pts_feat_extractor_hidden_dim=args.pts_feat_extractor_hidden_dim,
        reduce_method=args.reduce_method,
        output_dim=output_dim,
        decoder_concat_xyz_pts=(
            args.decoder_concat_xyz_pts
            if decoder_concat_xyz_pts is None
            else decoder_concat_xyz_pts
        ),
    )


def model_cfg_from_args(task: str, approach: str, args):
    """The net config of (task, approach). VOOL quirk, kept: the reference
    pops --decoder_concat_xyz_pts before building the inner SemAbs3D
    (net.py:469-486, :640-648), so every VOOL completion decoder has
    concat_xyz=False and only the outer spatial sampler reads the flag."""
    if task == "ovssc":
        if approach == "semantic_aware":
            return SemanticAwareOVSSCConfig(
                completion=completion_cfg_from_args(
                    args, network_inputs=["rgb"], output_dim=512
                ),
                pointing_method=args.pointing_method,
            )
        return completion_cfg_from_args(args)
    if approach == "semantic_aware":
        return SemanticAwareVOOLConfig(
            completion=completion_cfg_from_args(
                args, network_inputs=["rgb"], output_dim=args.pointing_dim,
                decoder_concat_xyz_pts=False,
            ),
            pointing_method=args.pointing_method,
            pointing_dim=args.pointing_dim,
        )
    if approach == "clip_spatial":
        return ClipSpatialVOOLConfig(
            completion=completion_cfg_from_args(
                args, decoder_concat_xyz_pts=False
            ),
            decoder_concat_xyz_pts=args.decoder_concat_xyz_pts,
        )
    return SemAbsVOOLConfig(
        completion=completion_cfg_from_args(args, decoder_concat_xyz_pts=False),
        pointing_method=args.pointing_method,
        pointing_dim=args.pointing_dim,
        decoder_concat_xyz_pts=args.decoder_concat_xyz_pts,
    )


def data_cfg_from_args(args) -> DataConfig:
    return DataConfig(
        scene_bounds=_bounds_from_args(args),
        network_inputs=tuple(args.network_inputs),
        domain_randomization=args.domain_randomization,
        num_input_pts=args.num_input_pts,
        num_output_pts=args.num_output_pts,
        num_patches=args.num_patches,
        num_descs=args.num_descs,
        tsdf_shape=tuple(args.voxel_shape),
        saliency_config=args.saliency_config,
        subtract_mean_relevancy=args.subtract_mean_relevancy,
        offset_patch_mask=args.offset_patch_mask,
        patch_mask_cutoff=args.patch_mask_cutoff,
        saliency_vmin=args.saliency_vmin,
        balance_spatial_relations=args.balance_spatial_relations,
        balance_spatial_sampling=args.balance_spatial_sampling,
        always_replace_subsample_pts=args.always_replace_subsample_pts,
        xyz_pts_noise=args.xyz_pts_noise,
        dr_pos=args.dr_pos,
        dr_orn=args.dr_orn,
        dr_scale=args.dr_scale,
        seed=args.seed,
    )


def _resolve(args, device) -> torch.device:
    """``device``, else ``args.device``, else cuda; raises without the card
    it names."""
    return resolve_device(device if device is not None else getattr(args, "device", None))


def load_datasets(args, task: str, return_vis: bool = False) -> Dict[str, object]:
    """The split file of ``args.file_path`` -> a dataset per non-empty
    split: domain randomization on the train split only, ``return_vis``
    items outside it, the domain-randomized rgb and the synonyms on their
    splits (reference utils.py:122-215)."""
    split_name = "ssc_split.pkl" if task == "ovssc" else "vool_split.pkl"
    with open(os.path.join(args.file_path, split_name), "rb") as f:
        splits = pickle.load(f)
    logging.info(
        "DATASET AT %s | %s", args.file_path,
        " | ".join(f"{k}: {len(v)}" for k, v in splits.items()),
    )
    dataset_class = (
        SceneCompletionDataset if task == "ovssc" else ObjectLocalizationDataset
    )
    dcfg = data_cfg_from_args(args)
    datasets = {}
    for k, paths in splits.items():
        if len(paths) == 0:
            continue
        split_dcfg = dataclasses.replace(
            dcfg,
            domain_randomization=(
                args.domain_randomization if k == "train" else False
            ),
        )
        datasets[k] = dataset_class(
            file_path=args.file_path,
            scene_paths=paths,
            cfg=split_dcfg,
            return_vis=(k != "train") or return_vis,
            domain_randomized_rgb=(k == "unseen_instances_dr"),
            use_synonyms=(k == "unseen_instances_synonyms"),
        )
    return datasets


def build_setup(args, task: str, approach: str, datasets: Dict[str, object],
                device=None) -> dict:
    """The net of (task, approach), its optimizer sized to the train
    split, and the train state on ``device`` (``args.device`` when not
    given; cuda unless it says otherwise), resumed from ``args.load`` when
    set -> the setup dict ``train`` takes (reference get_net
    utils.py:237-294)."""
    device = _resolve(args, device)
    cfg = model_cfg_from_args(task, approach, args)
    model = init_net(args.seed, cfg, device)
    logging.info("NUM PARAMS: %d", sum(p.numel() for p in model.parameters()))
    # --batch_size is per device (the reference's batch-1-per-GPU regime):
    # the global batch scales with the data-parallel group
    global_batch = max(args.batch_size, 1) * parallel.mesh_size_from_args(args)
    steps_per_epoch = max(1, len(datasets.get("train", [])) // global_batch)
    tx = make_optimizer(
        lr=args.lr,
        weight_decay=args.weight_decay,
        grad_max_norm=args.grad_max_norm,
        lr_scheduler_type=args.lr_scheduler_type,
        num_warmup_steps=args.num_warmup_steps,
        num_training_steps=args.epochs * steps_per_epoch,
    )
    state = init_train_state(model, tx)
    start_epoch = 0
    if args.load:
        logging.info("loading from %s", args.load)
        state, start_epoch = resume_checkpoint(args.load, state)
    return {
        "datasets": datasets,
        "cfg": cfg,
        "forward_loss": FORWARD_LOSS[f"{task}/{approach}"],
        "tx": tx,
        "state": state,
        "start_epoch": start_epoch,
        "task": task,
        "approach": approach,
        "device": device,
        "data_parallel": parallel.data_parallel_from_args(args),
    }


def setup_experiment(args, task: str, approach: str,
                     return_vis: bool = False, device=None) -> dict:
    """``build_setup`` over the datasets of ``args.file_path``'s split file.
    The device is resolved first, so a run without the card it asks for
    fails before it reads a scene."""
    device = _resolve(args, device)
    return build_setup(args, task, approach, load_datasets(args, task, return_vis),
                       device)


def _to_device(v: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_batch(batch: dict, task: str, device,
                 text_encoder: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy) -> the step's tensors on ``device``: the
    ``DEVICE_KEYS`` of the task, 0/1 labels as uint8 (the losses cast them
    to f32), and for semantic-aware VOOL the CLIP text features of the
    target and reference names, computed on the host side by
    ``text_encoder`` (reference net.py:594-602). On the card each array goes
    through pinned memory with a non-blocking copy."""
    device = torch.device(device)
    out = {}
    for k in DEVICE_KEYS[task]:
        if k in batch and isinstance(batch[k], np.ndarray):
            v = batch[k]
            if k == "output_label_pts" and v.dtype != np.uint8:
                v = v.astype(np.uint8)
            out[k] = v
    if text_encoder is not None and task == "vool" and "target_obj_name" in batch:
        t = [n for row in batch["target_obj_name"] for n in row]
        r = [n for row in batch["reference_obj_name"] for n in row]
        b = len(batch["target_obj_name"])
        out["target_obj_features"] = np.asarray(text_encoder(t)).reshape(b, -1, 512)
        out["reference_obj_features"] = np.asarray(text_encoder(r)).reshape(b, -1, 512)
    return {k: _to_device(v, device) for k, v in out.items()}


def _eval_meta(batch: dict, task: str) -> Dict[str, list]:
    """The detailed-stats frame's meta columns, one entry per (B, P) row."""
    if task == "ovssc":
        return {
            "scene_id": [sid for sid, row in zip(batch["scene_id"], batch["patch_labels"])
                         for _ in row],
            "label": [l for row in batch["patch_labels"] for l in row],
        }
    return {
        "scene_id": [sid for sid, row in zip(batch["scene_id"],
                                             batch["spatial_relation_name"])
                     for _ in row],
        "target_obj_name": [n for row in batch["target_obj_name"] for n in row],
        "reference_obj_name": [n for row in batch["reference_obj_name"] for n in row],
        "spatial_relation_name": [s for row in batch["spatial_relation_name"]
                                  for s in row],
    }


def eval_batches(state: TrainState, eval_step, loader: DataLoader, task: str,
                 scene_bounds, cutoffs, voxel_shapes=((32, 32, 32),),
                 text_encoder=None, max_batches: Optional[int] = None,
                 device=None) -> Iterator[dict]:
    """The eval loop without pandas: for each loader batch, yields
    ``{"batch", "aux", "stats", "loss", "accuracy", "pad"}`` with ``stats``
    the detailed stats at every cutoff as numpy (C, B, P) arrays,
    ``loss``/``accuracy`` the per-sample values of the real samples
    (wrap-pad duplicates dropped) and ``pad`` the (B, P) rows the frame
    NaNs (padded patches or descriptions, and duplicated samples)."""
    device = next(state.model.parameters()).device if device is None else device
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        db = device_batch(batch, task, device, text_encoder)
        aux = eval_step(state.model, db)
        stats = point_and_voxel_stats(
            aux["logits"], db["output_label_pts"], db["output_xyz_pts"],
            aux["ignore"], cutoffs, scene_bounds, voxel_shapes,
        )
        # in key order, as JAX returns a dict from a jitted function, so the
        # frame's columns come in the JAX package's order
        stats = {k: stats[k].cpu().numpy() for k in sorted(stats)}
        sample_pad = np.asarray(batch.get("_sample_pad", np.zeros(0, bool)))
        lps = aux["loss_per_sample"].cpu().numpy()
        aps = aux["accuracy_per_sample"].cpu().numpy()
        valid = ~sample_pad if sample_pad.size else np.ones(len(lps), bool)
        pad = np.asarray(batch["padding_mask"])
        if sample_pad.size:
            pad = pad | sample_pad[:, None]
        yield {"batch": batch, "aux": aux, "stats": stats,
               "loss": lps[valid].tolist(), "accuracy": aps[valid].tolist(),
               "pad": pad}


def run_eval_split(state: TrainState, eval_step, loader: DataLoader, task: str,
                   scene_bounds, cutoffs, voxel_shapes=((32, 32, 32),),
                   text_encoder=None, max_batches: Optional[int] = None,
                   device=None, gather: bool = False):
    """Eval loop over a split -> (per-sample scalar means, detailed-stats
    DataFrame). With ``gather``, every rank's frame and per-sample scalars
    are gathered first (reference all_gather_object and all_reduce,
    utils.py:427-435), so every rank returns the global ones."""
    import pandas as pd

    frames = []
    scalars = {"loss": [], "accuracy": []}
    for out in eval_batches(state, eval_step, loader, task, scene_bounds, cutoffs,
                            voxel_shapes, text_encoder, max_batches, device):
        scalars["loss"].extend(out["loss"])
        scalars["accuracy"].extend(out["accuracy"])
        frames.append(detailed_stats_frame(out["stats"], cutoffs,
                                           _eval_meta(out["batch"], task), out["pad"]))
    detailed = pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()
    if gather:
        parts = [p for p in parallel.all_gather_host_objects(detailed) if len(p)]
        detailed = pd.concat(parts, ignore_index=True) if parts else pd.DataFrame()
        gathered = parallel.all_gather_host_objects(scalars)
        scalars = {k: [x for part in gathered for x in part[k]] for k in scalars}
    means = {k: float(np.mean(v)) if v else float("nan") for k, v in scalars.items()}
    return means, detailed


class _Profile:
    """``SEMABS_PROFILE_DIR`` tracing, over the steps the JAX package
    traces: from the second local train step (the first builds the
    kernels) through ``SEMABS_PROFILE_STEPS`` more, once a run, exported
    as a chrome trace (at the end of the run when it has fewer steps)."""

    def __init__(self):
        self.dir = os.environ.get("SEMABS_PROFILE_DIR")
        self.steps = int(os.environ.get("SEMABS_PROFILE_STEPS", "3"))
        self.prof = None
        self.stop_at = -1

    def before_step(self, bi: int) -> None:
        if self.dir and self.prof is None and bi == 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.stop_at = bi + self.steps

    def after_step(self, bi: int) -> None:
        if self.prof is not None and bi == self.stop_at:
            self.stop(export=True)

    def stop(self, export: bool = False) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        if export:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"trace_{os.getpid()}.json")
            self.prof.export_chrome_trace(path)
            logging.info("profiler trace written to %s", path)
        self.prof, self.dir = None, None


def train(args, setup: dict, text_encoder: Optional[Callable] = None,
          log_dir: Optional[str] = None, max_steps_per_epoch: Optional[int] = None,
          timings: Optional[List[dict]] = None) -> TrainState:
    """Epoch loop (reference utils.py:474-614): train every epoch, the other
    splits every ``eval_freq``; tensorboard scalars; latest and periodic
    checkpoints; cumulative ``detailed_stats.pkl``. ``timings``, when given,
    gets one dict per train epoch: steps, wall seconds, seconds waiting on
    the loader, seconds in ``device_batch`` (host clock), mean loss, and
    each step's loss and grad norm. Data-parallel when
    ``setup["data_parallel"]``: only rank 0 writes."""
    task = setup["task"]
    cfg = setup["cfg"]
    state = setup["state"]
    device = setup["device"]
    dp = setup.get("data_parallel", False)
    shards, shard_id = (parallel.world_size(), parallel.rank()) if dp else (1, 0)
    writes = parallel.rank() == 0  # reference is_main_process() guards
    log_dir = log_dir or args.log
    os.makedirs(log_dir, exist_ok=True)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    train_step = make_train_step(
        setup["forward_loss"], cfg, setup["tx"],
        balance_positive_negative=args.balance_positive_negative,
        compute_dtype=compute_dtype, data_parallel=dp,
    )
    eval_step = make_eval_step(setup["forward_loss"], cfg, compute_dtype=compute_dtype)

    writers = {}
    try:
        from tensorboardX import SummaryWriter

        if writes:
            writers = {k: SummaryWriter(os.path.join(log_dir, k))
                       for k in setup["datasets"]}
    except ImportError:
        pass
    profile = _Profile()

    detailed_path = os.path.join(log_dir, "detailed_stats.pkl")
    all_detailed = []
    if os.path.exists(detailed_path):
        with open(detailed_path, "rb") as f:  # a DataFrame: needs pandas
            all_detailed.append(pickle.load(f))

    bounds = setup["datasets"][next(iter(setup["datasets"]))].cfg.scene_bounds
    global_step = int(state.step)
    batch_size = max(args.batch_size, 1)
    try:
        for epoch in range(setup["start_epoch"], args.epochs):
            for split, ds in setup["datasets"].items():
                is_train = split == "train"
                if not is_train and epoch % args.eval_freq != 0:
                    continue
                try:
                    sampler = ShardedSampler(len(ds), num_shards=shards, shard_id=shard_id,
                                             shuffle=is_train, seed=args.seed,
                                             drop_last=is_train)
                    # ragged return_vis eval samples need static-shape
                    # padding whenever more than one is stacked
                    pad_eval = (not is_train) and batch_size > 1
                    loader = DataLoader(
                        ds, batch_size=batch_size, num_workers=args.num_workers,
                        sampler=sampler, drop_last=is_train,
                        pad_to_full_batches=pad_eval, pad_static_shapes=pad_eval,
                    )
                    loader.set_epoch(epoch)
                    if is_train:
                        state, global_step, record = _train_epoch(
                            state, train_step, loader, task, device, text_encoder,
                            writers.get(split), global_step, max_steps_per_epoch,
                            profile)
                        record["epoch"] = epoch
                        if timings is not None:
                            timings.append(record)
                        logging.info(
                            "epoch %d train: loss %.4f (%d steps, %.1fs; %.3f s waiting "
                            "on the loader, %.3f s in device_batch)", epoch,
                            record["loss"], record["steps"], record["wall_s"],
                            record["loader_wait_s"], record["device_batch_s"])
                    else:
                        means, detailed = run_eval_split(
                            state, eval_step, loader, task, bounds,
                            eval_cutoffs_for(task, False), text_encoder=text_encoder,
                            max_batches=max_steps_per_epoch, device=device, gather=dp,
                        )
                        if len(detailed):
                            detailed["split"] = split
                            detailed["epoch"] = epoch
                            all_detailed.append(detailed)
                        if split in writers:
                            for k, v in means.items():
                                writers[split].add_scalar(k, v, global_step)
                            for col in detailed.columns:
                                if "iou" in str(col):
                                    writers[split].add_scalar(
                                        col, float(detailed[col].mean()), global_step)
                        logging.info("epoch %d %s: %s", epoch, split, means)
                except Exception:
                    profile.stop()
                    logging.exception("split %s failed; continuing", split)
                    continue
            if not writes:
                continue
            # every rank writes through one fixed <path>.tmp: one writer
            save_checkpoint(os.path.join(log_dir, "latest.ckpt"), state, epoch + 1)
            if (epoch + 1) % args.save_freq == 0:
                save_checkpoint(os.path.join(log_dir, f"ckpt_{epoch}.ckpt"), state,
                                epoch + 1)
            if all_detailed:
                import pandas as pd

                tmp = detailed_path + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(pd.concat(all_detailed, ignore_index=True), f)
                os.replace(tmp, detailed_path)
    finally:
        profile.stop(export=True)  # a run shorter than the traced steps
        for w in writers.values():
            w.close()
    return state


def _train_epoch(state, train_step, loader, task, device, text_encoder, writer,
                 global_step, max_steps, profile):
    """One pass of the train loader -> (state, global step, timing record).
    The step's scalars stay on the device until a flush reads them back,
    every ``LOG_FLUSH`` steps and at the end of the epoch."""
    t_start = time.perf_counter()
    losses, grad_norms, pending = [], [], []
    host_s = {"loader_wait_s": 0.0, "device_batch_s": 0.0}

    def flush():
        for gs, st in pending:
            vals = {k: float(v) for k, v in st.items()}
            losses.append(vals["loss"])
            grad_norms.append(vals["grad_norm"])
            if writer is not None:
                for k, v in vals.items():
                    writer.add_scalar(k, v, gs)
        pending.clear()

    it = iter(loader)
    bi = 0
    while not (max_steps and bi >= max_steps):
        t0 = time.perf_counter()
        with trace.span("sa.loop.wait"):
            batch = next(it, None)
        wait_s = time.perf_counter() - t0
        if batch is None:
            break
        host_s["loader_wait_s"] += wait_s
        profile.before_step(bi)
        with trace.timed("sa.loop.device_batch", host_s, "device_batch_s"):
            db = device_batch(batch, task, device, text_encoder)
        state, stats = train_step(state, db)
        profile.after_step(bi)
        global_step += 1
        pending.append((global_step, stats))
        if len(pending) >= LOG_FLUSH:
            flush()
        bi += 1
    flush()
    it.close()  # an early stop releases the loader's workers
    record = {"steps": len(losses), "wall_s": time.perf_counter() - t_start, **host_s,
              "loss": float(np.mean(losses)) if losses else float("nan"),
              "losses": losses, "grad_norms": grad_norms}
    return state, global_step, record
