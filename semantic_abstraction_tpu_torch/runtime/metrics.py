"""Evaluation metrics: point and voxel IoU, precision and recall over a
sweep of logit cutoffs.

Counterpart of ``semantic_abstraction_tpu/runtime/metrics.py`` (reference
utils.py:329-380 ``iou`` / ``prediction_analysis``, utils.py:617-667
``voxelize_points``, train_ovssc.py:11-78 / train_vool.py:15-115
``get_detailed_stats``):

- ``prediction_analysis`` is vectorized masked reductions over the last
  axis; it broadcasts over any leading axes, so the cutoff sweep is one
  call on (C, B, P, N). NaN conventions kept: an empty union gives NaN
  IoU, a zero denominator NaN precision or recall.
- ``point_and_voxel_stats`` voxelizes once per voxel shape: the max-scatter
  of the logits, of the labels mapped to +-1 and of the ignore mask is
  built once, and every cutoff is a broadcast compare on the voxel grid
  (a voxel's max logit exceeds c iff one of its points does; voxels with
  no label point are ignored).
- ``detailed_stats_frame`` assembles the reference's per-cutoff DataFrame
  on the host; it imports pandas when called (the tensor part needs none).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.voxel import VoxelGrid

_NAN = float("nan")


def eval_cutoffs_for(task: str, detailed: bool) -> Tuple[float, ...]:
    """The eval loop's cutoffs (JAX ``runtime/experiment.py``
    ``eval_cutoffs_for``): the 25 of ``np.arange(-2.5, 0, 0.1)`` for the
    detailed stats, else 0.0 for OVSSC and -2.0 for VOOL."""
    if detailed:
        return tuple(float(c) for c in np.arange(-2.5, 0, 0.1))
    return (0.0,) if task == "ovssc" else (-2.0,)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else NaN."""
    return torch.where(den > 0, num / den.clamp_min(1.0), _NAN)


def iou(prediction: torch.Tensor, label: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IoU over the last axis; NaN when the union is empty
    (reference utils.py:330-336)."""
    pred, lab = prediction.bool(), label.bool()
    if mask is not None:
        pred, lab = pred & mask, lab & mask
    inter = (pred & lab).sum(-1).float()
    union = (pred | lab).sum(-1).float()
    return _ratio(inter, union)


def prediction_analysis(prediction: torch.Tensor, label: torch.Tensor,
                        ignore: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., N) -> per-row {iou, precision, recall, false_negative,
    false_positive} (reference utils.py:338-380)."""
    keep = ~ignore.bool()
    pred = prediction.bool() & keep
    lab = label.bool() & keep
    tp = (pred & lab).sum(-1).float()
    count = keep.sum(-1).float().clamp_min(1.0)
    return {
        "iou": _ratio(tp, (pred | lab).sum(-1).float()),
        "precision": _ratio(tp, pred.sum(-1).float()),
        "recall": _ratio(tp, lab.sum(-1).float()),
        "false_negative": (lab & ~pred).sum(-1) / count,
        "false_positive": (~lab & pred & keep).sum(-1) / count,
    }


class _Voxelizer:
    """Max-scatter of (B, P, N) point values into (B, P, V) voxel values
    (empty voxels 0), the points given once."""

    def __init__(self, xyz_pts: torch.Tensor, shape: Tuple[int, int, int],
                 voxel_shape, scene_bounds):
        b, p, n = shape
        self.shape = shape
        self.grid = VoxelGrid.from_bounds(np.asarray(scene_bounds), voxel_shape)
        self.xyz = xyz_pts.expand(b, p, n, 3).reshape(b * p, n, 3)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        b, p, n = self.shape
        feats = values.float().reshape(b * p, n, 1)
        return self.grid.scatter_points(self.xyz, feats, "max").reshape(b, p, -1)


def _voxel_label_ignore(vox: _Voxelizer, label: torch.Tensor, ignore_pts: torch.Tensor):
    vox_label = vox((label.float() - 0.5) * 2.0)
    missing = vox_label == 0.0  # no label point in the voxel
    return vox_label > 0, (vox(ignore_pts) > 0) | missing


def voxelize_points(prediction: torch.Tensor, label: torch.Tensor,
                    xyz_pts: torch.Tensor, voxel_shape: Tuple[int, int, int],
                    scene_bounds, ignore_pts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Point predictions -> voxelized (B, P, V) bool grids (reference
    utils.py:617-667): max-scatter of the prediction, of the +-1 labels
    and of the ignore mask; voxels with no label point are ignored."""
    vox = _Voxelizer(xyz_pts, tuple(prediction.shape), voxel_shape, scene_bounds)
    lab, ign = _voxel_label_ignore(vox, label, ignore_pts)
    return {"prediction": vox(prediction) > 0, "label": lab, "ignore": ign}


def point_and_voxel_stats(logits: torch.Tensor, label: torch.Tensor,
                          xyz_pts: torch.Tensor, ignore_pts: torch.Tensor,
                          cutoffs: Sequence[float], scene_bounds,
                          voxel_shapes: Tuple[Tuple[int, int, int], ...] = ((32, 32, 32),),
                          ) -> Dict[str, torch.Tensor]:
    """Every detailed stat at every cutoff in one pass: logits, label,
    ignore (B, P, N) and xyz_pts (B, P, N, 3) or (B, 1, N, 3) ->
    {"point_iou": (C, B, P), ..., "voxel32x32x32_iou": (C, B, P), ...}."""
    cut = torch.tensor(list(cutoffs), dtype=torch.float32,
                       device=logits.device)[:, None, None, None]
    out = {f"point_{k}": v for k, v in
           prediction_analysis(logits[None] > cut, label, ignore_pts).items()}
    for vs in voxel_shapes:
        vox = _Voxelizer(xyz_pts, tuple(logits.shape), vs, scene_bounds)
        lab, ign = _voxel_label_ignore(vox, label, ignore_pts)
        stats = prediction_analysis(vox(logits)[None] > cut, lab, ign)
        tag = "voxel" + "x".join(str(s) for s in vs)
        out.update({f"{tag}_{k}": v for k, v in stats.items()})
    return out


def detailed_stats_frame(stats: Dict[str, np.ndarray], cutoffs: Sequence[float],
                         meta: Dict[str, Sequence], pad_mask: np.ndarray):
    """The reference's detailed-stats DataFrame (train_ovssc.py:11-78 /
    train_vool.py:15-115 schema): one row per (cutoff, B*P row), ``meta``
    columns per B*P row, padded rows (``pad_mask`` (B, P)) NaN."""
    import pandas as pd

    frames = []
    flat_pad = np.asarray(pad_mask).reshape(-1)
    for ci, cutoff in enumerate(cutoffs):
        cols = dict(meta)
        for k, v in stats.items():
            vals = np.asarray(v[ci]).reshape(-1).astype(np.float64)
            vals[flat_pad] = np.nan
            cols[k] = vals
        df = pd.DataFrame(cols)
        df["cutoff"] = cutoff
        frames.append(df)
    return pd.concat(frames, ignore_index=True)
