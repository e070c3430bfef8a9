"""Visualization CLI of the port: dense scene inference -> meshes and point
clouds, and their turntable renders.

Counterpart of ``semantic_abstraction_tpu/cli/visualize.py`` (reference
visualize.py: prep_data :61-154, process_batch_ovssc :157-248,
process_batch_vool :354-419, export_obj :251-280, get_sample_points
:283-298). Runs on ``cuda`` unless ``--device cpu`` is given.

  python -m semantic_abstraction_tpu_torch.cli.visualize ovssc-inference SCENE.pkl \
      --load CKPT [--random-weights | --clip-ckpt PATH] [--device cpu]
  python -m semantic_abstraction_tpu_torch.cli.visualize vool-inference SCENE.pkl \
      --load CKPT ...
  python -m semantic_abstraction_tpu_torch.cli.visualize {ovssc,vool}-visualize DUMP_DIR

As in the JAX package, the feature volume is computed once per class (or
description) and only the implicit decoder sweeps the dense grid, in chunks
of 2^18 points, with the grid uploaded once. JAX's packed volume and
``grid_sample_packed`` are TPU layout and are not ported: each chunk goes
through the port's dense ``implicit_decoder`` and the optional pointer
``post``. ``DenseArgmax`` keeps the running (max, uint8 argmax) over the
classes on the device. The OVSSC carving mask (the frustum, the empty mask
and TSDF > 0) is built on the device with ``TSDFVolume``; the prediction
and the mask are read back once, and marching and the ``.obj`` export run
on the host.

Quirks kept from the JAX package: ``--subtract-mean`` is ``store_true`` with
default True; the relevancy maps are multiplied by 50 (in float16, on the
host, as JAX's numpy does); ``prep_data`` resizes with ``cv2`` only when
the pickle has ``img_shape``; VOOL exponentiates the kept logits before the
min-max heat; ``scene_rgb.ply`` holds at most 100k points; without
matplotlib the ``.ply`` colors are grey levels of the heat.

Differences: bfloat16 VOOL logits (the ``clip_spatial`` decoder's) are read
back as float32 for the band and the heat, where JAX's numpy works in
bfloat16. The frustum test runs on the device in float64, in the order of
``data/transforms.check_pts_in_frustum_np``'s native kernel, so its mask is
bit for bit the host's. ``cmd_ovssc`` and ``cmd_vool`` return what they
computed, and take a ``timings`` dict that, when given, receives the
seconds of each stage (the device is synchronized at each stage's end).
Each stage is the span ``sa.visualize.<stage>`` (``trace.span``).
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .. import trace

CHUNK = 2**18


def get_sample_points(sampling_shape, scene_bounds) -> np.ndarray:
    """Dense grid of world points (reference visualize.py:283-298)."""
    lc = np.asarray(scene_bounds[0], np.float32)
    uc = np.asarray(scene_bounds[1], np.float32)
    shape = np.asarray(sampling_shape, np.float32)
    axes = [np.arange(s) for s in sampling_shape]
    idxs = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).astype(np.float32)
    pts = idxs * ((uc - lc) / (shape - 1)) + lc
    return pts.reshape(-1, 3)


def export_obj(vol: np.ndarray, filename: str, level: float = 0.5):
    """Volume -> wavefront obj via marching tetrahedra (reference
    visualize.py:251-280: border closed, verts centered/normalized)."""
    from ..ops.fusion import vertex_normals
    from ..ops.marching import marching_tetrahedra

    vol = vol.copy()
    for axis in range(3):
        sl = [slice(None)] * 3
        for idx in (0, -1):
            sl[axis] = idx
            vol[tuple(sl)] = -np.inf
    if (vol < level).all():
        return False
    # marching_tetrahedra extracts "inside < level"; the reference meshes
    # occupancy (> level), so negate around the level set
    verts, faces = marching_tetrahedra(-vol, level=-level)
    if len(verts) == 0:
        return False
    norms = vertex_normals(verts, faces)
    shape = np.asarray(vol.shape, np.float32)
    verts = (verts - shape / 2) / shape
    with open(filename, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for n in norms:
            f.write(f"vn {n[0]:f} {n[1]:f} {n[2]:f}\n")
        for face in faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
    return True


def prep_data(args, scene_bounds, approach="semantic_abstraction", sal=None):
    """Scene pickle -> relevancies + in-bounds point features on the host
    (reference visualize.py:61-154), with the extractor ``sal`` (built from
    the flags when None). ``clip_spatial`` adds the relevancies of the full
    description sentences; ``semantic_aware`` skips the relevancy and
    extracts raw CLIP text features (VOOL's queries) and the
    prompt-ensembled zeroshot features (OVSSC's classes) instead."""
    from ..data.transforms import depth_to_pointcloud_np, filter_pts_bounds_np
    from .generate_relevancy import DEFAULT_PROMPT, THOR_PROMPT, build_saliency, relevancy

    with open(args.scene_file, "rb") as f:
        data = pickle.load(f)
    rgb = data["rgb"]
    depth = data["depth"].astype(np.float32)
    if "img_shape" in data:  # reference visualize.py:80-82
        import cv2

        rgb = cv2.resize(rgb, data["img_shape"])
        depth = cv2.resize(depth, data["img_shape"])
    cam_intr = data["cam_intr"]
    cam_extr = data["cam_extr"]
    descriptions = data.get("descriptions", [])
    ovssc_obj_classes = data.get("ovssc_obj_classes", [])
    target_classes = [d[0] for d in descriptions]
    relation_names = [d[1] for d in descriptions]
    reference_classes = [d[2] for d in descriptions]
    relevancy_keys = sorted(
        set(ovssc_obj_classes) | set(target_classes) | set(reference_classes))
    if approach == "clip_spatial":
        relevancy_keys = sorted(
            set(relevancy_keys) | {f"{t} {r} a {f_}" for t, r, f_ in descriptions})

    sal = build_saliency(args) if sal is None else sal
    xyz = depth_to_pointcloud_np(depth, cam_intr, cam_extr)
    in_bounds = filter_pts_bounds_np(xyz, np.asarray(scene_bounds))
    xyz = xyz[in_bounds]
    if approach == "semantic_aware":
        # the per-label gradcam would be discarded: skip it
        flat = {}
    else:
        run = argparse.Namespace(labels=relevancy_keys, prompt=DEFAULT_PROMPT,
                                 saliency_config=args.saliency_config, seed=args.seed)
        maps = relevancy(sal, rgb, run).cpu().numpy() * 50.0  # float16, as JAX's numpy
        if args.subtract_mean:
            maps = maps - maps.mean(axis=0, keepdims=True)
        flat = {k: maps[i].reshape(-1)[in_bounds] for i, k in enumerate(relevancy_keys)}
    out = {
        "rgb": rgb,
        "depth": depth,
        "cam_intr": cam_intr,
        "cam_extr": cam_extr,
        "input_xyz_pts": xyz,
        "input_rgb_pts": rgb.reshape(-1, 3)[in_bounds],
        "relevancy": flat,
        "ovssc_obj_classes": ovssc_obj_classes,
        "descriptions": descriptions,
        "target_classes": target_classes,
        "relation_names": relation_names,
        "reference_classes": reference_classes,
        "scene_id": Path(args.scene_file).stem,
    }
    if approach == "semantic_aware":
        names = sorted(set(ovssc_obj_classes) | set(target_classes) | set(reference_classes))
        # VOOL's text encoder is raw encode_text (reference
        # ClipWrapper.get_clip_text_feature)
        feats = (sal.text_features(names).cpu().numpy() if names
                 else np.zeros((0, 512), np.float32))
        out["text_features"] = {n: feats[i] for i, n in enumerate(names)}
        # OVSSC semantic_aware nets were trained on the dataset's stored,
        # normalized prompt-ensembled zeroshot features, under the writer's
        # per-corpus prompt: the pointer sees the same kind here
        low = str(args.scene_file).lower()
        prompt = DEFAULT_PROMPT if ("matterport" in low or "nyu" in low) else THOR_PROMPT
        zw = (sal.zeroshot_weights(names, [prompt]).t().cpu().numpy() if names
              else np.zeros((0, 512), np.float32))
        out["class_features"] = {n: zw[i] for i, n in enumerate(names)}
    return out


def _restore_net(args, task):
    """The trained net's config and approach from the ``args.pkl`` beside
    ``--load`` (reference visualize.py:310-315), its weights from the
    checkpoint, on ``args.device``. Without ``args.pkl`` the JAX package's
    defaults hold; without ``--load`` the weights are random (seed 0)."""
    from ..clip.model import resolve_device
    from ..models import init_net
    from ..runtime.checkpoint import load_net_checkpoint
    from ..runtime.experiment import model_cfg_from_args
    from . import common

    device = resolve_device(args.device)
    approach = args.approach
    ns = None
    if args.load:
        args_pkl = os.path.join(os.path.dirname(args.load), "args.pkl")
        if os.path.exists(args_pkl):
            saved = common.load_args(args_pkl)
            ns = argparse.Namespace(**saved)
            approach = saved.get("approach", approach)
            logging.info("restored net config from %s (approach=%s)", args_pkl, approach)
    if ns is None:
        ns = argparse.Namespace(
            voxel_shape=args.voxel_shape,
            scene_bounds=[-1.0, -1.0, -0.1, 1.0, 1.0, 1.9],
            unet_num_channels=16, unet_f_maps=16, unet_num_groups=8,
            unet_num_levels=6,
            network_inputs=(["rgb"] if approach == "semantic_aware" else ["saliency"]),
            use_pts_feat_extractor=True, pts_feat_extractor_hidden_dim=128,
            reduce_method="max", decoder_concat_xyz_pts=True,
            pointing_method="cosine_sim", pointing_dim=64,
        )
    cfg = model_cfg_from_args(task, approach, ns)
    if args.load:
        model, _ = load_net_checkpoint(args.load, task, approach, cfg, device)
    else:
        logging.warning("no --load checkpoint: using random weights")
        model = init_net(0, cfg, device)
    return cfg, model.requires_grad_(False), approach


def make_dense_decoder(grid, concat_xyz: bool, post: Optional[Callable] = None,
                       chunk: int = CHUNK):
    """``decode(decoder, vol, points, post_arg=None)``: the implicit decoder
    over (N, 3) world ``points`` (on vol's device, uploaded once by the
    caller) in chunks of ``chunk``, from the (1, C, gx, gy, gz) feature
    volume -> (N,) per-point outputs. ``post(feats, post_arg)`` maps each
    chunk's (chunk, output_dim) decoded features to its outputs (a class or
    query pointer); without it channel 0 is taken."""
    from ..models.decoder import implicit_decoder

    def decode(decoder, vol, points, post_arg=None):
        outs = []
        for c in range(0, points.shape[0], chunk):
            feats = implicit_decoder(decoder, vol, grid, points[None, c:c + chunk],
                                     concat_xyz)[0]
            outs.append(post(feats, post_arg) if post is not None else feats[:, 0])
        return torch.cat(outs)

    return decode


class DenseArgmax:
    """The running (max, uint8 argmax) over per-class dense sweeps, on the
    device: the first class initialises it, a later class wins a point only
    where its output is strictly larger."""

    def __init__(self):
        self._best = None

    def update(self, out: torch.Tensor, class_idx: int) -> None:
        out = out.reshape(-1)
        if self._best is None:
            self._best = (out, torch.zeros(out.shape, dtype=torch.uint8, device=out.device))
            return
        bv, bi = self._best
        better = out > bv
        self._best = (torch.where(better, out, bv),
                      torch.where(better, torch.tensor(class_idx, dtype=torch.uint8,
                                                       device=bi.device), bi))

    def finalize(self, n: int, cutoff: float):
        """-> (prediction uint8 (n,), empty bool (n,)) on the device; empty
        where the best output is below ``cutoff`` (compared in the outputs'
        dtype, as JAX's weakly typed scalar)."""
        bv, bi = self._best
        empty = bv < torch.tensor(cutoff, dtype=bv.dtype, device=bv.device)
        return bi[:n], empty[:n]


def frustum_mask(points: torch.Tensor, depth_shape, cam_pose, cam_intr) -> torch.Tensor:
    """``data.transforms.check_pts_in_frustum_np`` on the points' device:
    the pose inverted on the host in float64, then the native kernel's
    double arithmetic in its order (products summed left to right, no fused
    multiply-add across torch ops), so the mask is the host's bit for bit."""
    h, w = depth_shape
    inv = torch.as_tensor(np.linalg.inv(np.asarray(cam_pose, np.float64))[:3],
                          device=points.device)
    intr = np.asarray(cam_intr, np.float64)
    p = points.double()

    def row(i):
        return p[:, 0] * inv[i, 0] + p[:, 1] * inv[i, 1] + p[:, 2] * inv[i, 2] + inv[i, 3]

    x, y, z = row(0), row(1), row(2)
    sz = torch.where(z == 0, 1e-12, z)
    px = float(intr[0, 0]) / sz * x + float(intr[0, 2])
    py = float(intr[1, 1]) / sz * y + float(intr[1, 2])
    return (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)


class _Stages:
    """``with stages("name"):`` is the span ``sa.visualize.name``
    (``trace.span``). When a ``timings`` dict is given it also adds the
    block's seconds to ``timings[name]``, synchronizing the device at the
    block's end (``trace.timed``)."""

    def __init__(self, device: torch.device, timings: Optional[dict]):
        self.device, self.timings = device, timings

    def __call__(self, name: str):
        if self.timings is None:
            return trace.span("sa.visualize." + name)
        return trace.timed("sa.visualize." + name, self.timings, name, sync=self.device)


def _compute_dtype(args):
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32


def _input_points(batch, rs, num_input_pts, device):
    """The seeded draw of ``num_input_pts`` in-bounds points, as JAX's:
    (indices, (1, n, 3) points on the device)."""
    idx = rs.choice(len(batch["input_xyz_pts"]), size=num_input_pts)
    return idx, torch.as_tensor(batch["input_xyz_pts"][idx], device=device)[None]


def cmd_ovssc(args, timings: Optional[dict] = None) -> dict:
    """Per-class completion meshes of one scene. Returns the uint8
    ``prediction`` and the bool carving mask ``keep`` on the sampling
    grid, the dump directory and the meshes written."""
    from ..models import pointing_attention_paired, semabs3d_feature_vol
    from ..ops.fusion import TSDFVolume
    from .generate_relevancy import build_saliency

    cfg, model, approach = _restore_net(args, "ovssc")
    device = next(model.parameters()).device
    stages = _Stages(device, timings)
    # scene bounds from the restored net config (the reference copies every
    # args.pkl field): a net trained on other bounds samples its own region
    ccfg0 = getattr(cfg, "completion", cfg)
    scene_bounds = tuple(map(tuple, ccfg0.scene_bounds))
    shape = tuple(args.sampling_shape)
    vs_axes = [(scene_bounds[1][a] - scene_bounds[0][a]) / shape[a] for a in range(3)]
    if max(vs_axes) - min(vs_axes) > 1e-9:
        raise SystemExit(
            f"--sampling_shape {shape} gives non-uniform voxel sizes {vs_axes} over "
            f"bounds {scene_bounds}; the TSDF carving mask needs one voxel size — pick "
            "a shape proportional to the bounds")
    with stages("clip"):
        sal = build_saliency(args)
    with stages("relevancy"):
        batch = prep_data(args, scene_bounds, approach, sal)
    if not batch["ovssc_obj_classes"]:
        raise SystemExit(
            f"{args.scene_file} carries no ovssc_obj_classes — nothing to complete "
            "(use vool-inference for description scenes)")
    grid_points = get_sample_points(shape, scene_bounds)
    n_pts = len(grid_points)
    rs = np.random.RandomState(args.seed)
    dump = Path(args.dump_path) / batch["scene_id"]
    dump.mkdir(parents=True, exist_ok=True)
    cd = _compute_dtype(args)

    acc = DenseArgmax()
    with torch.no_grad():
        points = torch.as_tensor(grid_points, device=device)  # uploaded once
        if approach == "semantic_aware":
            # one RGB feature volume shared by all classes; the CLIP-wide
            # decode is pointed at each class feature inside the sweep
            ccfg = cfg.completion
            idx, xyz = _input_points(batch, rs, args.num_input_pts, device)
            rgb_feats = torch.as_tensor(
                batch["input_rgb_pts"][idx].astype(np.float32) / 255.0, device=device)[None, None]
            with stages("unet"):
                vol = semabs3d_feature_vol(model, ccfg, xyz, rgb_feats, compute_dtype=cd)

            def point_at_class(feats, cf):
                return pointing_attention_paired(
                    model.semantic_class_pointer, cf, feats, cfg.pointing_method,
                    cfg.clip_hidden_dim, cfg.pointing_temperature)

            decode = make_dense_decoder(ccfg.grid, ccfg.decoder_concat_xyz_pts,
                                        post=point_at_class)
            for ci, obj_class in enumerate(batch["ovssc_obj_classes"]):
                cf = torch.as_tensor(batch["class_features"][obj_class], device=device)
                with stages("sweep"):
                    acc.update(decode(model.visual_sampler, vol, points, cf), ci)
                logging.info("completed %s", obj_class)
        else:
            decode = make_dense_decoder(cfg.grid, cfg.decoder_concat_xyz_pts)
            for ci, obj_class in enumerate(batch["ovssc_obj_classes"]):
                idx, xyz = _input_points(batch, rs, args.num_input_pts, device)
                feats = torch.as_tensor(batch["relevancy"][obj_class][idx].astype(np.float32),
                                        device=device)[None, None, :, None]
                with stages("unet"):
                    vol = semabs3d_feature_vol(model, cfg, xyz, feats, compute_dtype=cd)
                with stages("sweep"):
                    acc.update(decode(model.visual_sampler, vol, points), ci)
                logging.info("completed %s", obj_class)
            del vol
        pred, empty = acc.finalize(n_pts, args.cutoff)
        with stages("tsdf"):
            tsdf = TSDFVolume(np.asarray(scene_bounds).T, voxel_size=vs_axes[0], device=device)
            tsdf.integrate(batch["rgb"], batch["depth"], batch["cam_intr"], batch["cam_extr"])
            in_frustum = frustum_mask(points, batch["depth"].shape, batch["cam_extr"],
                                      batch["cam_intr"])
            keep = ~empty & in_frustum & ~(tsdf.volume()[0].reshape(-1) > 0.0)
            del tsdf
        with stages("readback"):
            prediction = pred.cpu().numpy().reshape(shape)
            keep = keep.cpu().numpy().reshape(shape)
    written = []
    with stages("export"):
        for ci, label in enumerate(batch["ovssc_obj_classes"]):
            vol = ((prediction == ci) & keep).astype(np.float32)
            path = str(dump / f"{label.replace(' ', '_')}.obj")
            if export_obj(vol, path):
                written.append(path)
                logging.info("wrote %s", path)
    logging.info("done -> %s", dump)
    return {"prediction": prediction, "keep": keep, "dump": dump, "written": written}


def cmd_vool(args, timings: Optional[dict] = None) -> dict:
    """Per-description localization point clouds of one scene and the
    scene's ``scene_rgb.ply``. Returns each description's float32
    ``logits`` on the sampling grid, the dump directory and the files
    written."""
    from ..models import (RELATION_TO_ID, pointing_attention, pointing_attention_paired,
                          semabs3d_feature_vol)
    from ..models.params import linear
    from ..ops.fusion import pcwrite
    from .generate_relevancy import build_saliency

    cfg, model, approach = _restore_net(args, "vool")
    device = next(model.parameters()).device
    stages = _Stages(device, timings)
    ccfg = cfg.completion
    cnet = model.completion_net
    scene_bounds = tuple(map(tuple, ccfg.scene_bounds))
    with stages("clip"):
        sal = build_saliency(args)
    with stages("relevancy"):
        batch = prep_data(args, scene_bounds, approach, sal)
    shape = tuple(args.sampling_shape)
    grid_points = get_sample_points(shape, scene_bounds).astype(np.float32)
    rs = np.random.RandomState(args.seed)
    dump = Path(args.dump_path) / batch["scene_id"]
    dump.mkdir(parents=True, exist_ok=True)
    cd = _compute_dtype(args)
    concat = getattr(cfg, "decoder_concat_xyz_pts", ccfg.decoder_concat_xyz_pts)

    def point_at_query(feats, q):
        return pointing_attention_paired(model.pointer, q, feats, cfg.pointing_method,
                                         cfg.pointing_dim, cfg.pointing_temperature)

    def point_at_relation(feats, rel):
        return pointing_attention(model.pointer, feats[None], rel[None, None],
                                  cfg.pointing_method, cfg.pointing_dim,
                                  cfg.pointing_temperature)[0, :, 0]

    def relevancy_pts(key, idx):
        return torch.as_tensor(batch["relevancy"][key][idx].astype(np.float32),
                               device=device)[None, None, :, None]

    results, written = {}, []
    with torch.no_grad():
        points = torch.as_tensor(grid_points, device=device)  # uploaded once
        if approach == "semantic_aware":
            decode = make_dense_decoder(ccfg.grid, ccfg.decoder_concat_xyz_pts,
                                        post=point_at_query)
        elif approach == "clip_spatial":
            decode = make_dense_decoder(ccfg.grid, concat)
        else:
            decode = make_dense_decoder(ccfg.grid, concat, post=point_at_relation)
        for (target, relation, reference) in batch["descriptions"]:
            idx, xyz = _input_points(batch, rs, args.num_input_pts, device)
            if approach == "semantic_aware":
                # RGB completion decoded to pointing features; query =
                # mlp(cat(CLIP(target), CLIP(reference), relation embedding))
                rgb = torch.as_tensor(batch["input_rgb_pts"][idx].astype(np.float32) / 255.0,
                                      device=device)[None, None]
                with stages("unet"):
                    vol = semabs3d_feature_vol(cnet, ccfg, xyz, rgb, compute_dtype=cd)
                text = batch["text_features"]
                query = linear(model.mlp, torch.cat([
                    torch.as_tensor(text[target], device=device),
                    torch.as_tensor(text[reference], device=device),
                    model.relation_embeddings[RELATION_TO_ID[relation]]]))
                with stages("sweep"):
                    out = decode(cnet.visual_sampler, vol, points, query)
            elif approach == "clip_spatial":
                # one completion pass on the full-description relevancy
                with stages("unet"):
                    vol = semabs3d_feature_vol(
                        cnet, ccfg, xyz, relevancy_pts(f"{target} {relation} a {reference}", idx),
                        compute_dtype=cd)
                with stages("sweep"):
                    out = decode(model.spatial_sampler, vol, points)
            else:
                with stages("unet"):
                    tvol = semabs3d_feature_vol(cnet, ccfg, xyz, relevancy_pts(target, idx),
                                                compute_dtype=cd)
                    rvol = semabs3d_feature_vol(cnet, ccfg, xyz, relevancy_pts(reference, idx),
                                                compute_dtype=cd)
                    vol = torch.cat([tvol, rvol], dim=1)
                    del tvol, rvol
                rel_emb = model.relation_embeddings[RELATION_TO_ID[relation]]
                with stages("sweep"):
                    out = decode(model.spatial_sampler, vol, points, rel_emb)
            del vol
            with stages("readback"):
                logits = out.float().cpu().numpy()
            with stages("export"):
                top = logits.max()
                mask = logits > (top - args.vool_band)
                pts = grid_points[mask]
                # the reference exponentiates the kept logprobs before the
                # min-max normalization (visualize.py:468-472)
                probs = np.exp(logits[mask])
                heat = (probs - probs.min()) / max(1e-9, probs.max() - probs.min())
                try:
                    import matplotlib.cm as cm

                    colors = (cm.jet(heat)[:, :3] * 255).astype(np.uint8)
                except ImportError:
                    colors = np.tile((heat[:, None] * 255).astype(np.uint8), (1, 3))
                desc = f"{target}_{relation}_{reference}".replace(" ", "_")
                path = str(dump / f"{desc}.ply")
                pcwrite(path, np.hstack([pts, colors.astype(np.float32)]))
                written.append(path)
            results[(target, relation, reference)] = logits
            logging.info("wrote %s (%d pts)", path, len(pts))
    # the scene point cloud for the turntable render (reference
    # visualize.py:472-487 dumps scene_rgb.ply beside the localizations)
    n_in = len(batch["input_xyz_pts"])
    n_scene = min(100000, n_in)
    sidx = (np.arange(n_in) if n_scene == n_in
            else rs.choice(n_in, size=n_scene, replace=False))
    with stages("export"):
        pcwrite(str(dump / "scene_rgb.ply"), np.hstack([
            batch["input_xyz_pts"][sidx], batch["input_rgb_pts"][sidx].astype(np.float32)]))
    written.append(str(dump / "scene_rgb.ply"))
    logging.info("done -> %s", dump)
    return {"logits": results, "dump": dump, "written": written}


# ---------------------------------------------------------------------------
# Turntable rendering (reference visualize.py:521-605): a matplotlib 3D
# scatter turntable written with imageio, mp4 when an ffmpeg backend exists,
# .gif otherwise. Host only.
# ---------------------------------------------------------------------------

# sashamaps.net/docs/resources/20-colors (public palette, as vendored by the
# reference visualize.py:489-518)
TWENTY_COLORS = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
]) / 255.0


def load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)


def load_ply_points(path: str):
    """Read the ascii PLY written by ops.fusion.pcwrite -> (pts, colors)."""
    with open(path) as f:
        n = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        rows = [f.readline().split() for _ in range(n)]
    arr = np.asarray(rows, np.float32)
    pts = arr[:, :3]
    colors = arr[:, 3:6] / 255.0 if arr.shape[1] >= 6 else None
    return pts, colors


def _upright(pts: np.ndarray) -> np.ndarray:
    """euler2mat(-pi/2, 0, 0) like the reference: z-up for the turntable."""
    return np.stack([pts[:, 0], pts[:, 2], -pts[:, 1]], axis=1)


def render_turntable(geometries, n_frames=72, size=640, point_size=2.0, legend=None):
    """geometries: [(pts, colors 0..1 | None)] -> list of RGB frames."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(size / 100, size / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    allpts = []
    for pts, colors in geometries:
        if len(pts) > 60000:
            sel = np.random.RandomState(0).choice(len(pts), 60000, replace=False)
            pts = pts[sel]
            colors = colors[sel] if colors is not None else None
        pts = _upright(pts)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size,
                   c=colors if colors is not None else "gray",
                   depthshade=False, linewidths=0)
        allpts.append(pts)
    allpts = np.concatenate(allpts) if allpts else np.zeros((1, 3))
    center = (allpts.min(0) + allpts.max(0)) / 2
    radius = max(1e-6, (allpts.max(0) - allpts.min(0)).max() / 2)
    for dim, c in zip("xyz", center):
        getattr(ax, f"set_{dim}lim")(c - radius, c + radius)
    ax.set_axis_off()
    if legend:
        handles = [plt.Line2D([], [], marker="s", color=c, ls="none", label=l)
                   for l, c in legend.items()]
        ax.legend(handles=handles, loc="lower left", framealpha=0, fontsize=7)
    frames = []
    for i in range(n_frames):
        ax.view_init(elev=25, azim=360.0 * i / n_frames)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    return frames


def write_video(frames, out_base: str, fps: int = 24) -> str:
    """mp4 via imageio/ffmpeg when available, else an animated gif."""
    import imageio

    try:
        with imageio.get_writer(out_base + ".mp4", fps=fps) as w:
            for f in frames:
                w.append_data(f)
        return out_base + ".mp4"
    except Exception:
        imageio.mimsave(out_base + ".gif", frames, duration=1000 // fps, loop=0)
        return out_base + ".gif"


def cmd_ovssc_visualize(args):
    """Per-class completion meshes -> one turntable video (reference
    ovssc_visualize, visualize.py:557-583)."""
    geoms, legend = [], {}
    paths = sorted(Path(args.output_path).rglob("*.obj"))
    for idx, path in enumerate(paths):
        verts = load_obj_vertices(str(path))
        if not len(verts):
            continue
        color = TWENTY_COLORS[idx % 20]
        geoms.append((verts, np.tile(color, (len(verts), 1))))
        legend[path.stem] = tuple(color)
    if not geoms:
        logging.warning("no .obj meshes under %s", args.output_path)
        return
    frames = render_turntable(geoms, n_frames=args.n_frames, legend=legend, point_size=4.0)
    out = write_video(frames, str(Path(args.output_path) / "completion"))
    logging.info("wrote %s", out)


def cmd_vool_visualize(args):
    """Scene cloud + per-description localization -> one video each
    (reference vool_visualize, visualize.py:585-605)."""
    plys = {p.stem: p for p in sorted(Path(args.output_path).rglob("*.ply"))}
    scene = plys.pop("scene_rgb", None)
    scene_geom = None
    if scene is not None:
        scene_geom = load_ply_points(str(scene))
    for desc, path in plys.items():
        pts, colors = load_ply_points(str(path))
        geoms = ([scene_geom] if scene_geom else []) + [(pts, colors)]
        frames = render_turntable(geoms, n_frames=args.n_frames)
        out = write_video(frames, str(path.parent / desc))
        logging.info("wrote %s", out)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="visualize")
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(q):
        q.add_argument("scene_file", type=str)
        q.add_argument("--load", type=str, default=None)
        q.add_argument("--dump-path", type=str, default="visualizations")
        q.add_argument("--voxel_shape", type=int, nargs=3, default=[128, 128, 128])
        q.add_argument("--sampling_shape", type=int, nargs=3, default=[240, 240, 240])
        q.add_argument("--num_input_pts", type=int, default=80000)
        q.add_argument("--cutoff", type=float, default=-3.0)
        q.add_argument("--vool-band", type=float, default=0.15)
        q.add_argument("--subtract-mean", action="store_true", default=True)
        q.add_argument("--clip-ckpt", type=str, default=None)
        q.add_argument("--random-weights", action="store_true")
        q.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                       default="bfloat16")
        q.add_argument("--tile_batch_size", type=int, default=32)
        q.add_argument("--saliency_config", choices=["ours", "chefer_et_al"],
                       default="ours")
        q.add_argument("--seed", type=int, default=0)
        q.add_argument(
            "--approach",
            choices=["semantic_abstraction", "semantic_aware", "clip_spatial"],
            default="semantic_abstraction",
            help="overridden by the checkpoint's args.pkl when present")
        q.add_argument("--device", type=str, default="cuda",
                       help="torch device; the CPU only when asked for")

    add_common(sub.add_parser("ovssc-inference"))
    add_common(sub.add_parser("vool-inference"))
    for name in ("ovssc-visualize", "vool-visualize"):
        q = sub.add_parser(name)
        q.add_argument("output_path", type=str,
                       help="inference dump dir (the <dump-path>/<scene_id>)")
        q.add_argument("--n_frames", type=int, default=72)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return {"ovssc-inference": cmd_ovssc, "vool-inference": cmd_vool,
            "ovssc-visualize": cmd_ovssc_visualize,
            "vool-visualize": cmd_vool_visualize}[args.command](args)


if __name__ == "__main__":
    main()
