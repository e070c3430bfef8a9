"""Training runtime of the port: losses, LR schedules, train/eval steps."""
from .losses import (
    bce_with_logits,
    get_bce_weight,
    masked_mean,
    masked_mean_per_sample,
    ovssc_ignore_mask,
    ovssc_loss,
    vool_loss,
)
from .schedule import make_schedule
from .train import (
    Optimizer,
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    ovssc_forward_loss,
)

__all__ = [
    "bce_with_logits",
    "get_bce_weight",
    "masked_mean",
    "masked_mean_per_sample",
    "ovssc_ignore_mask",
    "ovssc_loss",
    "vool_loss",
    "make_schedule",
    "Optimizer",
    "TrainState",
    "init_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "ovssc_forward_loss",
]
