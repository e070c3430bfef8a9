"""Weight loading for the port's five nets.

- ``from_jax_params``: the weight bridge from the JAX package's param
  pytree of any of the five nets, given as numpy arrays. Linear ``w`` is
  (in, out) there and transposes; conv and transposed-conv weights are
  already in torch layout; the additive pointer's ``v`` (d, 1) becomes
  ``pointer_v.weight`` (1, d).
- ``from_state_dict``: a reference state dict (its ``.pth`` ``net`` entry,
  with or without the DistributedDataParallel ``module.`` prefix), loaded
  key for key and strictly: the port's modules carry the reference's names
  (``pts_feat_extractor.{0,2,4}``,
  ``vol_feature_extractor.encoders.{i}.basic_module.conv{j}.{conv,groupnorm}``,
  ``...decoders.{i}.upsampling.upsample``, ``...final_conv``,
  ``visual_sampler.mlp.{0,2}``; the VOOL nets' ``completion_net.``,
  ``spatial_sampler``, ``pointer``, ``mlp``; SemanticAwareOVSSC's
  ``semantic_class_pointer``). One layout differs: the reference keeps one
  parameter per relation name (``relation_embeddings.in front of``), the
  port one (7, d) table, stacked here in ``RELATIONS`` order.
- ``NET_CONVERTERS``: (task, approach) -> the loader of that net's
  reference state dict, keyed like the JAX package's table.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..clip.model import resolve_device
from .nets import (
    RELATIONS,
    ClipSpatialVOOLConfig,
    SemAbs3DConfig,
    SemAbsVOOLConfig,
    SemanticAwareOVSSCConfig,
    SemanticAwareVOOLConfig,
    init_net,
)

_RELATION_KEYS = tuple(f"relation_embeddings.{r}" for r in RELATIONS)


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


def to_reference_state_dict(model: nn.Module) -> dict:
    """The model's state dict in the reference's layout: the relation
    table split into one entry per relation name."""
    sd = model.state_dict()
    if "relation_embeddings" in sd:
        table = sd.pop("relation_embeddings")
        sd.update({k: table[i] for i, k in enumerate(_RELATION_KEYS)})
    return sd


def load_reference_state_dict(model: nn.Module, sd: Mapping) -> None:
    """Load a reference-layout state dict (DDP prefix stripped, relation
    entries stacked by name) into ``model``, strictly: a missing or unknown
    key raises."""
    sd = to_tensors(strip_ddp_prefix(sd))
    if any(k in sd for k in _RELATION_KEYS):
        missing = [k for k in _RELATION_KEYS if k not in sd]
        if missing:
            raise RuntimeError(f"relation embeddings missing: {missing}")
        sd["relation_embeddings"] = torch.stack([sd.pop(k) for k in _RELATION_KEYS])
    model.load_state_dict(sd)


def from_state_dict(sd: Mapping, cfg, device=None) -> nn.Module:
    """A reference-layout state dict -> the net of ``cfg``'s type on
    ``device`` (cuda unless asked)."""
    dev = resolve_device(device)
    model = init_net(0, cfg, "cpu")  # every parameter is overwritten
    load_reference_state_dict(model, sd)
    return model.to(dev)


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


def _semabs3d_sd(params: Mapping, prefix: str) -> dict:
    sd = {}
    if "pts_feat_extractor" in params:
        for i, fc in zip((0, 2, 4), ("fc1", "fc2", "fc3")):
            sd.update(_linear_sd(f"{prefix}pts_feat_extractor.{i}",
                                 params["pts_feat_extractor"][fc]))
    sd.update(jax_unet_to_state_dict(params["unet"], f"{prefix}vol_feature_extractor."))
    sd.update(_linear_sd(f"{prefix}visual_sampler.mlp.0", params["decoder"]["fc1"]))
    sd.update(_linear_sd(f"{prefix}visual_sampler.mlp.2", params["decoder"]["fc2"]))
    return sd


def _ovssc_sd(params: Mapping) -> dict:
    return _semabs3d_sd(params, "")


def _pointer_sd(name: str, pointer: Mapping) -> dict:
    """The additive pointer's ``v`` (d, 1) -> ``pointer_v.weight`` (1, d);
    the other methods have no parameter."""
    return {f"{name}.pointer_v.weight": np.asarray(pointer["v"]).T} if "v" in pointer else {}


def _relation_sd(params: Mapping) -> dict:
    table = np.asarray(params["relation_embeddings"])
    return {k: table[i] for i, k in enumerate(_RELATION_KEYS)}


def _sampler_sd(params: Mapping) -> dict:
    return {**_linear_sd("spatial_sampler.mlp.0", params["spatial_sampler"]["fc1"]),
            **_linear_sd("spatial_sampler.mlp.2", params["spatial_sampler"]["fc2"])}


def _semantic_aware_ovssc_sd(params: Mapping) -> dict:
    # SemAbs3D's keys at the root: the reference subclasses it
    return {**_semabs3d_sd(params["completion"], ""),
            **_pointer_sd("semantic_class_pointer", params["pointer"])}


def _semabs_vool_sd(params: Mapping) -> dict:
    return {**_semabs3d_sd(params["completion"], "completion_net."), **_sampler_sd(params),
            **_pointer_sd("pointer", params["pointer"]), **_relation_sd(params)}


def _semantic_aware_vool_sd(params: Mapping) -> dict:
    return {**_semabs3d_sd(params["completion"], "completion_net."),
            **_pointer_sd("pointer", params["pointer"]), **_relation_sd(params),
            **_linear_sd("mlp", params["query_mlp"])}


def _clip_spatial_vool_sd(params: Mapping) -> dict:
    return {**_semabs3d_sd(params["completion"], "completion_net."), **_sampler_sd(params)}


_JAX_TO_SD = {
    SemAbs3DConfig: _ovssc_sd,
    SemanticAwareOVSSCConfig: _semantic_aware_ovssc_sd,
    SemAbsVOOLConfig: _semabs_vool_sd,
    SemanticAwareVOOLConfig: _semantic_aware_vool_sd,
    ClipSpatialVOOLConfig: _clip_spatial_vool_sd,
}


def jax_params_to_state_dict(params: Mapping, cfg) -> dict:
    """The JAX pytree (numpy leaves) of the net of ``cfg``'s type -> the
    reference state dict (numpy values, parameters only: without the
    ``steps`` buffers)."""
    if type(cfg) not in _JAX_TO_SD:
        raise TypeError(f"no net for a {type(cfg).__name__}")
    return _JAX_TO_SD[type(cfg)](params)


def from_jax_params(params: Mapping, cfg, device=None) -> nn.Module:
    """The JAX package's param pytree (numpy leaves) of the net of
    ``cfg``'s type -> that net on ``device`` (cuda unless asked)."""
    dev = resolve_device(device)
    model = init_net(0, cfg, "cpu")  # every parameter is overwritten
    sd = jax_params_to_state_dict(params, cfg)
    sd.update({name: np.zeros(1, np.float32) for name, _ in model.named_buffers()})
    load_reference_state_dict(model, sd)
    return model.to(dev)


NET_CONFIGS = {
    ("ovssc", "semantic_abstraction"): SemAbs3DConfig,
    ("ovssc", "semantic_aware"): SemanticAwareOVSSCConfig,
    ("vool", "semantic_abstraction"): SemAbsVOOLConfig,
    ("vool", "semantic_aware"): SemanticAwareVOOLConfig,
    ("vool", "clip_spatial"): ClipSpatialVOOLConfig,
}


def _converter(config_cls):
    def convert(sd: Mapping, cfg=None, device=None) -> nn.Module:
        """A reference state dict -> the net, at ``cfg`` (the reference's
        defaults unless given) on ``device`` (cuda unless asked)."""
        return from_state_dict(sd, config_cls() if cfg is None else cfg, device)
    return convert


NET_CONVERTERS = {key: _converter(cls) for key, cls in NET_CONFIGS.items()}
