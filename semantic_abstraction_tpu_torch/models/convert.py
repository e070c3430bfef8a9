"""Weight loading for the port's SemAbs3D.

- ``from_jax_params``: the weight bridge from the JAX package's SemAbs3D
  param pytree, given as numpy arrays. Linear ``w`` is (in, out) there and
  transposes; conv and transposed-conv weights are already in torch layout.
- ``from_state_dict``: a reference SemAbs3D state dict (its ``.pth``
  ``net`` entry, with or without the DistributedDataParallel ``module.``
  prefix), loaded key for key: the port's modules carry the reference's
  names (``pts_feat_extractor.{0,2,4}``,
  ``vol_feature_extractor.encoders.{i}.basic_module.conv{j}.{conv,groupnorm}``,
  ``...decoders.{i}.upsampling.upsample``, ``...final_conv``,
  ``visual_sampler.mlp.{0,2}``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..clip.model import resolve_device
from .nets import SemAbs3D, SemAbs3DConfig, empty_semabs3d


def strip_ddp_prefix(sd: Mapping) -> dict:
    """Remove the DistributedDataParallel "module." prefix
    (reference utils.py:280-289)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def to_tensors(sd: Mapping) -> dict:
    """A state dict of numpy arrays or tensors -> f32 CPU tensors."""
    return {k: (v.detach().cpu().float() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, dtype=np.float32)))
            for k, v in sd.items()}


def from_state_dict(sd: Mapping, cfg: SemAbs3DConfig, device=None) -> SemAbs3D:
    """A reference-layout SemAbs3D state dict -> ``SemAbs3D`` on ``device``
    (cuda unless asked). Strict: a missing or unknown key raises."""
    model = empty_semabs3d(cfg)
    model.load_state_dict(to_tensors(strip_ddp_prefix(sd)))
    return model.to(resolve_device(device))


def _linear_sd(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.weight": np.asarray(p["w"]).T, f"{prefix}.bias": p["b"]}


def _block_sd(prefix: str, p: Mapping) -> dict:
    sd = {}
    for j in (1, 2, 3):
        conv = p[f"conv{j}"]
        sd[f"{prefix}.conv{j}.conv.weight"] = conv["w"]
        sd[f"{prefix}.conv{j}.groupnorm.weight"] = conv["gn_scale"]
        sd[f"{prefix}.conv{j}.groupnorm.bias"] = conv["gn_bias"]
    return sd


def jax_unet_to_state_dict(unet: Mapping, prefix: str = "") -> dict:
    """The JAX ResidualUNet3D pytree (numpy leaves) -> the reference's
    ``ResidualUNet3D`` state dict (numpy values), keys under ``prefix``."""
    sd = {}
    for i, enc in enumerate(unet["encoders"]):
        sd.update(_block_sd(f"{prefix}encoders.{i}.basic_module", enc))
    for i, dec in enumerate(unet["decoders"]):
        sd[f"{prefix}decoders.{i}.upsampling.upsample.weight"] = dec["up_w"]
        sd[f"{prefix}decoders.{i}.upsampling.upsample.bias"] = dec["up_b"]
        sd.update(_block_sd(f"{prefix}decoders.{i}.basic_module", dec))
    sd[f"{prefix}final_conv.weight"] = unet["final_w"]
    sd[f"{prefix}final_conv.bias"] = unet["final_b"]
    return sd


def jax_params_to_state_dict(params: Mapping) -> dict:
    """The JAX SemAbs3D pytree (numpy leaves) -> the reference state dict
    (numpy values, without the ``steps`` buffer)."""
    sd = {}
    if "pts_feat_extractor" in params:
        for i, fc in zip((0, 2, 4), ("fc1", "fc2", "fc3")):
            sd.update(_linear_sd(f"pts_feat_extractor.{i}",
                                 params["pts_feat_extractor"][fc]))
    sd.update(jax_unet_to_state_dict(params["unet"], "vol_feature_extractor."))
    sd.update(_linear_sd("visual_sampler.mlp.0", params["decoder"]["fc1"]))
    sd.update(_linear_sd("visual_sampler.mlp.2", params["decoder"]["fc2"]))
    return sd


def from_jax_params(params: Mapping, cfg: SemAbs3DConfig, device=None) -> SemAbs3D:
    """The JAX package's SemAbs3D param pytree (numpy leaves) -> ``SemAbs3D``
    on ``device`` (cuda unless asked)."""
    sd = jax_params_to_state_dict(params)
    sd["steps"] = np.zeros(1, np.float32)
    return from_state_dict(sd, cfg, device)
