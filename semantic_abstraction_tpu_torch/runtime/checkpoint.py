"""Checkpoints in the reference's own layout, written with ``torch.save``.

Counterpart of ``semantic_abstraction_tpu/runtime/checkpoint.py``. The JAX
package serializes its TrainState with flax msgpack, which the port does
not read; the port writes what the reference writes (utils.py:547-556,
:603-613), ``{"net": state dict, "optimizer": LAMB state, "epochs": n}``,
with the net's state dict in the reference's key layout (relation
embeddings by name), plus the port's ``step`` counter and the caller's
``extra``. A write goes to ``<path>.tmp`` and is renamed over ``path``
(``os.replace``), so an interrupted save leaves the previous file whole.

- ``save_checkpoint`` / ``load_checkpoint``: the whole train state (model,
  LAMB moments and step counts, step) and the epoch; the next step after a
  load is the one the saved run would have taken.
- ``load_net_checkpoint``: a reference ``.pth`` of any of the five nets
  (``net`` entry, DDP prefix or not) -> the port's net and its epoch,
  through ``models.convert.NET_CONVERTERS``.
- ``resume_checkpoint``: ``--load`` of the train and eval CLIs, into a
  built train state, by the JAX package's rule (its ``load_net_checkpoint``):
  a ``.pth``/``.pt`` restores the net and the epoch, anything else is a
  ``save_checkpoint`` file and restores all of it.

Both loaders read with ``torch.load(weights_only=True)``, which rebuilds
tensors and plain containers only and runs no other code of the file.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.convert import (
    NET_CONVERTERS,
    load_reference_state_dict,
    to_reference_state_dict,
)
from .train import TrainState


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    extra: Optional[dict] = None) -> None:
    """Write ``state`` and ``epoch`` to ``path`` atomically. ``extra`` holds
    plain values (numbers, strings, lists, dicts, tensors)."""
    payload = {
        "net": to_reference_state_dict(state.model),
        "optimizer": state.optimizer.state_dict(),
        "epochs": int(epoch),
        "step": int(state.step),
        "extra": dict(extra or {}),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState):
    """Restore a ``save_checkpoint`` file into ``state`` (a model and
    optimizer of the same net and recipe) -> (state, epoch, extra)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(state.model, ckpt["net"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt.get("step", 0))
    return state, int(ckpt["epochs"]), ckpt.get("extra", {})


def _read_reference(path: str):
    """A reference ``.pth`` -> (net state dict, epoch): a training
    checkpoint's ``net`` and ``epochs``, or a bare state dict and 0. The
    optimizer state is not read."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "net" in ckpt:
        return ckpt["net"], int(ckpt.get("epochs", 0))
    return ckpt, 0


def load_net_checkpoint(path: str, task: str, approach: str, cfg=None, device=None):
    """A reference training checkpoint (``.pth``) -> (net, epoch): the net
    of (task, approach) at ``cfg`` (the reference's defaults unless given)
    on ``device`` (cuda unless asked)."""
    sd, epoch = _read_reference(path)
    return NET_CONVERTERS[(task, approach)](sd, cfg, device), epoch


def resume_checkpoint(path: str, state: TrainState):
    """Restore ``path`` into ``state`` -> (state, start epoch). A reference
    ``.pth``/``.pt`` restores the net and the epoch (the optimizer starts
    fresh: the reference's torch Lamb state does not map onto the port's);
    any other file is a ``save_checkpoint`` one and restores the net, the
    LAMB moments and step counts, the step and the epoch, bit for bit."""
    if path.endswith((".pth", ".pt")):
        sd, epoch = _read_reference(path)
        load_reference_state_dict(state.model, sd)
        return state, epoch
    state, epoch, _ = load_checkpoint(path, state)
    return state, epoch
