"""Train and eval steps, on one card or data-parallel over several.

Counterpart of ``semantic_abstraction_tpu/runtime/train.py``: one step is
forward, backward, gradient clipping to global norm 2.0
(reference utils.py:413-421) and a LAMB update on the HF-style schedule
(utils.py:260-274). The model's parameters stay f32; the forward runs in
``compute_dtype`` (bf16 on the card) and the loss in f32. The call shapes
are the JAX package's::

    tx = make_optimizer(num_training_steps=1000)
    state = init_train_state(model, tx)
    step = make_train_step(ovssc_forward_loss, cfg, tx)
    state, stats = step(state, batch)   # stats: loss, accuracy, grad_norm

``FORWARD_LOSS`` holds the forward-loss of each of the five nets under
"task/approach". Unlike JAX, the state is updated in place (the module and
the optimizer are mutable); the step returns it for the same call shape.
The stats are 0-dim tensors on the model's device, read back only by the
caller. A parameter the forward does not read gets no ``.grad``; LAMB
takes it as a zero gradient, as JAX's ``value_and_grad`` gives it.

``make_train_step(..., data_parallel=True)`` runs the step through
``parallel.data_parallel`` (DDP over the default process group), each rank
on its own rows of the global batch. The loss is then the one of the
global batch: a masked mean (OVSSC's loss, every accuracy) takes its
denominator over every rank's kept points, so the gradient DDP averages,
the grad norm read after ``backward`` and the logged scalars are those of
one process on the whole batch, whatever each rank keeps.

A step is the span ``sa.train.step`` (``trace.span``: nothing unless the
torch profiler is on) over ``sa.train.forward`` (``zero_grad``, forward,
loss), ``sa.train.backward`` (with DDP's all-reduce), ``sa.train.clip``
(the global norm) and ``sa.train.optimizer`` (the clip and LAMB: on the
card ``ops.lamb_update``'s kernels, one launch for the norm and two for
the update, whatever the number of parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from .. import trace
from ..models.lamb import Lamb
from ..models.nets import (
    ClipSpatialVOOLConfig,
    SemAbs3DConfig,
    SemAbsVOOLConfig,
    SemanticAwareOVSSCConfig,
    SemanticAwareVOOLConfig,
    clip_spatial_vool_forward,
    semabs3d_forward,
    semabs_vool_forward,
    semantic_aware_ovssc_forward,
    semantic_aware_vool_forward,
)
from .losses import ovssc_ignore_mask, ovssc_loss, vool_ignore_mask, vool_loss
from .schedule import Schedule, make_schedule


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip(grad_max_norm) -> LAMB(lr * schedule(count)): the optax chain
    of the JAX package, as a recipe for a model's ``Lamb``."""

    lr: float
    weight_decay: float
    grad_max_norm: float
    schedule: Schedule

    def init(self, model: nn.Module) -> Lamb:
        return Lamb(model.parameters(), lr=self.lr, schedule=self.schedule,
                    weight_decay=self.weight_decay)


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-5,
                   grad_max_norm: float = 2.0,
                   lr_scheduler_type: str = "cosine_with_restarts",
                   num_warmup_steps: int = 1024,
                   num_training_steps: int = 1) -> Optimizer:
    return Optimizer(lr, weight_decay, grad_max_norm,
                     make_schedule(lr_scheduler_type, num_warmup_steps,
                                   num_training_steps))


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Lamb
    step: int = 0


def init_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=tx.init(model))


def ovssc_forward_loss(model, cfg: SemAbs3DConfig, batch: dict,
                       balance_positive_negative: bool = False,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       per_sample: bool = False):
    """SemAbs3D OVSSC loss (reference train_ovssc.py:81-169) ->
    (loss, {loss, accuracy, logits, ignore[, *_per_sample]})."""
    logits = semabs3d_forward(
        model, cfg,
        input_xyz_pts=batch["input_xyz_pts"],
        input_feature_pts=batch["input_feature_pts"],
        output_xyz_pts=batch["output_xyz_pts"],
        tsdf_vol=batch.get("tsdf_vol"),
        valid_mask=batch.get("input_valid_mask"),
        compute_dtype=compute_dtype,
    )
    return _ovssc_stats(logits, batch, balance_positive_negative, per_sample)


def _ovssc_stats(logits, batch, balance_positive_negative, per_sample):
    ignore = ovssc_ignore_mask(batch["padding_mask"], batch["out_of_bounds_pts"],
                               batch.get("out_of_frustum_pts_mask"))
    stats = ovssc_loss(logits, batch["output_label_pts"], ignore,
                       balance_positive_negative, per_sample=per_sample)
    return stats["loss"], {**stats, "logits": logits, "ignore": ignore}


def _vool_stats(logits, batch, balance_positive_negative, per_sample):
    ignore = vool_ignore_mask(batch["padding_mask"], batch["out_of_bounds_pts"])
    stats = vool_loss(logits, batch["output_label_pts"], ignore,
                      balance_positive_negative, per_sample=per_sample)
    return stats["loss"], {**stats, "logits": logits, "ignore": ignore}


def semaware_ovssc_forward_loss(model, cfg: SemanticAwareOVSSCConfig, batch: dict,
                                balance_positive_negative: bool = False,
                                compute_dtype: torch.dtype = torch.bfloat16,
                                per_sample: bool = False):
    """SemanticAwareOVSSC: the OVSSC loss over its class-pointer logits."""
    logits = semantic_aware_ovssc_forward(
        model, cfg,
        input_xyz_pts=batch["input_xyz_pts"],
        input_feature_pts=batch["input_feature_pts"],
        output_xyz_pts=batch["output_xyz_pts"],
        semantic_class_features=batch["semantic_class_features"],
        tsdf_vol=batch.get("tsdf_vol"),
        valid_mask=batch.get("input_valid_mask"),
        compute_dtype=compute_dtype,
    )
    return _ovssc_stats(logits, batch, balance_positive_negative, per_sample)


def vool_forward_loss(model, cfg: SemAbsVOOLConfig, batch: dict,
                      balance_positive_negative: bool = False,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      per_sample: bool = False):
    """SemAbsVOOL loss (reference train_vool.py:118-206): the unmasked BCE,
    accuracy over the points not ignored."""
    logits = semabs_vool_forward(
        model, cfg,
        input_xyz_pts=batch["input_xyz_pts"],
        input_target_saliency_pts=batch["input_target_saliency_pts"],
        input_reference_saliency_pts=batch["input_reference_saliency_pts"],
        output_xyz_pts=batch["output_xyz_pts"],
        spatial_relation_id=batch["spatial_relation_id"],
        tsdf_vol=batch.get("tsdf_vol"),
        valid_mask=batch.get("input_valid_mask"),
        compute_dtype=compute_dtype,
    )
    return _vool_stats(logits, batch, balance_positive_negative, per_sample)


def semaware_vool_forward_loss(model, cfg: SemanticAwareVOOLConfig, batch: dict,
                               balance_positive_negative: bool = False,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               per_sample: bool = False):
    logits = semantic_aware_vool_forward(
        model, cfg,
        input_xyz_pts=batch["input_xyz_pts"],
        input_rgb_pts=batch["input_rgb_pts"],
        output_xyz_pts=batch["output_xyz_pts"],
        spatial_relation_id=batch["spatial_relation_id"],
        target_obj_features=batch["target_obj_features"],
        reference_obj_features=batch["reference_obj_features"],
        tsdf_vol=batch.get("tsdf_vol"),
        valid_mask=batch.get("input_valid_mask"),
        compute_dtype=compute_dtype,
    )
    return _vool_stats(logits, batch, balance_positive_negative, per_sample)


def clipspatial_vool_forward_loss(model, cfg: ClipSpatialVOOLConfig, batch: dict,
                                  balance_positive_negative: bool = False,
                                  compute_dtype: torch.dtype = torch.bfloat16,
                                  per_sample: bool = False):
    logits = clip_spatial_vool_forward(
        model, cfg,
        input_xyz_pts=batch["input_xyz_pts"],
        input_description_saliency_pts=batch["input_description_saliency_pts"],
        output_xyz_pts=batch["output_xyz_pts"],
        tsdf_vol=batch.get("tsdf_vol"),
        valid_mask=batch.get("input_valid_mask"),
        compute_dtype=compute_dtype,
    )
    return _vool_stats(logits, batch, balance_positive_negative, per_sample)


FORWARD_LOSS = {
    "ovssc/semantic_abstraction": ovssc_forward_loss,
    "ovssc/semantic_aware": semaware_ovssc_forward_loss,
    "vool/semantic_abstraction": vool_forward_loss,
    "vool/semantic_aware": semaware_vool_forward_loss,
    "vool/clip_spatial": clipspatial_vool_forward_loss,
}


# nets with parameters their forward never reads (the completion
# decoder of SemAbsVOOL and ClipSpatialVOOL): DDP must look for them
_UNREAD_PARAMETERS = (SemAbsVOOLConfig, ClipSpatialVOOLConfig)
# the OVSSC nets, whose loss is a mean over the points not ignored; the
# VOOL nets' loss is a mean over every point (a reference quirk)
_MASKED_MEAN_LOSS = (SemAbs3DConfig, SemanticAwareOVSSCConfig)


def _global_means(loss: torch.Tensor, aux: dict, masked_loss: bool):
    """This rank's (loss, accuracy) rescaled so that their mean over the
    ranks is the global batch's: a rank's masked sum over the global count,
    times the world size. Returns them and the logged global values."""
    world = dist.get_world_size()
    kept = (~aux["ignore"]).sum()
    n_loss = kept if masked_loss else torch.full_like(kept, aux["ignore"].numel())
    local = torch.stack([n_loss, kept]).double()
    total = local.clone()
    dist.all_reduce(total)
    scale = (local.clamp_min(1.0) / total.clamp_min(1.0) * world).float()
    loss, accuracy = loss * scale[0], aux["accuracy"] * scale[1]
    logged = torch.stack([loss.detach(), accuracy.detach()])
    dist.all_reduce(logged)
    return loss, logged / world


def make_train_step(forward_loss: Callable, cfg, tx: Optimizer,
                    balance_positive_negative: bool = False,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    data_parallel: bool = False):
    """(state, batch) -> (state, {"loss", "accuracy", "grad_norm"}); the
    grad norm is the one before clipping (reference utils.py:320-326). With
    ``data_parallel`` the step runs under DDP over the default process
    group (built at the first call, for the state's model) and ``batch`` is
    this rank's rows."""
    wrapped = {}

    def forward(state: TrainState, batch: dict):
        """-> (loss to differentiate, logged loss, accuracy)."""
        state.optimizer.zero_grad(set_to_none=True)
        if data_parallel:
            if wrapped.get("model") is not state.model:
                from ..parallel import data_parallel as ddp

                wrapped.update(model=state.model, ddp=ddp(
                    state.model, forward_loss, cfg, balance_positive_negative,
                    compute_dtype, isinstance(cfg, _UNREAD_PARAMETERS)))
            loss, aux = wrapped["ddp"](batch)
            loss, (logged_loss, accuracy) = _global_means(
                loss, aux, isinstance(cfg, _MASKED_MEAN_LOSS))
            return loss, logged_loss, accuracy
        loss, aux = forward_loss(state.model, cfg, batch,
                                 balance_positive_negative, compute_dtype)
        return loss, loss.detach(), aux["accuracy"]

    def step_fn(state: TrainState, batch: dict):
        with trace.span("sa.train.step"):
            with trace.span("sa.train.forward"):
                loss, logged_loss, accuracy = forward(state, batch)
            with trace.span("sa.train.backward"):
                loss.backward()
            # after backward: DDP has averaged the gradients over the ranks
            with trace.span("sa.train.clip"):
                grad_norm = state.optimizer.clip_grad_norm_(tx.grad_max_norm)
            with trace.span("sa.train.optimizer"):
                state.optimizer.step()
                state.step += 1
        return state, {"loss": logged_loss, "accuracy": accuracy,
                       "grad_norm": grad_norm}

    return step_fn


def make_eval_step(forward_loss: Callable, cfg,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """(model, batch) -> {loss, accuracy, loss_per_sample,
    accuracy_per_sample, logits, ignore}, without gradients."""

    @torch.no_grad()
    def step_fn(model, batch: dict):
        _, aux = forward_loss(model, cfg, batch, False, compute_dtype,
                              per_sample=True)
        return aux

    return step_fn
