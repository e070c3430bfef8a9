"""Task losses: masked weighted BCE for OVSSC and VOOL.

Counterpart of ``semantic_abstraction_tpu/runtime/losses.py`` (reference
train_ovssc.py:81-169, train_vool.py:118-206, utils.py:727-747). The OVSSC
BCE averages over the points that are not ignored; the VOOL BCE is
unmasked (a reference quirk: only its accuracy is masked).
"""
from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise numerically stable binary cross entropy with logits."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def get_bce_weight(output_label_pts: torch.Tensor,
                   balance_positive_negative: bool) -> torch.Tensor:
    """(B, P, N) labels -> per-point weights: with balancing, each row
    weighs positives by 1/frac_positive and negatives by 1/frac_negative."""
    labels = output_label_pts.float()
    if not balance_positive_negative:
        return torch.ones_like(labels)
    frac_pos = labels.mean(-1, keepdim=True)
    w_pos = 1.0 / (frac_pos + 1e-10)
    w_neg = 1.0 / (1.0 - frac_pos + 1e-10)
    return torch.where(labels > 0, w_pos, w_neg)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` is True (0 if empty)."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def masked_mean_per_sample(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, ...) masked mean over all non-batch axes -> (B,)."""
    mask = mask.to(values.dtype)
    axes = tuple(range(1, values.dim()))
    return (values * mask).sum(axes) / mask.sum(axes).clamp_min(1.0)


def _bce_and_correct(logits, output_label_pts, balance_positive_negative):
    labels = output_label_pts.float()
    bce = (bce_with_logits(logits.float(), labels)
           * get_bce_weight(labels, balance_positive_negative))
    correct = ((logits > 0.0) == (labels > 0.5)).float()
    return bce, correct


def ovssc_loss(logits: torch.Tensor, output_label_pts: torch.Tensor,
               ignore_mask: torch.Tensor, balance_positive_negative: bool = False,
               per_sample: bool = False) -> dict:
    """OVSSC loss and accuracy over the points not ignored."""
    bce, correct = _bce_and_correct(logits, output_label_pts,
                                    balance_positive_negative)
    keep = ~ignore_mask
    stats = {"loss": masked_mean(bce, keep), "accuracy": masked_mean(correct, keep)}
    if per_sample:
        stats["loss_per_sample"] = masked_mean_per_sample(bce, keep)
        stats["accuracy_per_sample"] = masked_mean_per_sample(correct, keep)
    return stats


def vool_loss(logits: torch.Tensor, output_label_pts: torch.Tensor,
              ignore_mask: torch.Tensor, balance_positive_negative: bool = False,
              per_sample: bool = False) -> dict:
    """VOOL loss over ALL points (reference quirk), accuracy over the
    points not ignored."""
    bce, correct = _bce_and_correct(logits, output_label_pts,
                                    balance_positive_negative)
    keep = ~ignore_mask
    stats = {"loss": bce.mean(), "accuracy": masked_mean(correct, keep)}
    if per_sample:
        stats["loss_per_sample"] = bce.mean(tuple(range(1, bce.dim())))
        stats["accuracy_per_sample"] = masked_mean_per_sample(correct, keep)
    return stats


def ovssc_ignore_mask(padding_mask: torch.Tensor, out_of_bounds_pts: torch.Tensor,
                      out_of_frustum_pts_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(B, P) padding and (B, P, N) masks -> the (B, P, N) ignore mask."""
    ignore = padding_mask[..., None] | out_of_bounds_pts.to(torch.bool)
    if out_of_frustum_pts_mask is not None:
        ignore = ignore | out_of_frustum_pts_mask.to(torch.bool)
    return ignore


def vool_ignore_mask(padding_mask: torch.Tensor,
                     out_of_bounds_pts: torch.Tensor) -> torch.Tensor:
    """(B, D) padding and (B, D, M) out-of-bounds -> the (B, D, M) ignore
    mask of the VOOL accuracy (no frustum mask)."""
    return padding_mask[..., None] | out_of_bounds_pts.to(torch.bool)
