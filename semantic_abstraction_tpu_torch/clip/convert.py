"""Weight loading for the port's CLIP.

- ``from_openai_state_dict``: an OpenAI CLIP state dict (ViT, or
  ModifiedResNet: RN50 and its kin), whose keys the port's modules share,
  into a ``CLIP`` module (fp16 tensors upcast to f32; the compute dtype is
  chosen at apply time; BatchNorm's ``num_batches_tracked`` is dropped).
- ``from_jax_params``: the weight bridge from the JAX package's param
  pytree, given as numpy arrays (blocks stacked on axis 0, ``x @ w``
  layouts), into a ``CLIP`` module.
- ``to_jax_params``: its inverse, the key layout of the JAX package's
  ``clip/convert.py`` (used by the parity tests).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .model import CLIP, ClipConfig, resolve_device
from .resnet import (
    resnet_config_from_state_dict,
    resnet_jax_from_state_dict,
    resnet_state_dict_from_jax,
)

_LINEARS = (("w_qkv", "attn.in_proj_weight"), ("w_out", "attn.out_proj.weight"),
            ("w_fc", "mlp.c_fc.weight"), ("w_proj", "mlp.c_proj.weight"))
_VECTORS = (("b_qkv", "attn.in_proj_bias"), ("b_out", "attn.out_proj.bias"),
            ("b_fc", "mlp.c_fc.bias"), ("b_proj", "mlp.c_proj.bias"))
_NORMS = (("ln_1", "ln_1"), ("ln_2", "ln_2"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _text_fields(sd: Mapping) -> dict:
    text_width = _np(sd["ln_final.weight"]).shape[0]
    return dict(
        embed_dim=_np(sd["text_projection"]).shape[1],
        context_length=_np(sd["positional_embedding"]).shape[0],
        vocab_size=_np(sd["token_embedding.weight"]).shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=len({k.split(".")[2] for k in sd
                         if k.startswith("transformer.resblocks.")}),
    )


def config_from_state_dict(sd: Mapping) -> ClipConfig:
    """The hyperparameters of an OpenAI CLIP state dict: a ViT, or a
    ModifiedResNet when it has ``visual.layer1.0.conv1.weight`` (reference
    build_model :549-557)."""
    if "visual.layer1.0.conv1.weight" in sd:
        vcfg = resnet_config_from_state_dict(sd)
        return ClipConfig(
            image_resolution=vcfg["input_resolution"],
            vision_layers=sum(vcfg["layers"]),
            vision_width=vcfg["width"],
            vision_patch_size=32,  # the tower's total downsampling
            vision_arch="resnet",
            resnet_layers=vcfg["layers"],
            **_text_fields(sd),
        )
    if "visual.conv1.weight" not in sd:
        raise ValueError("not a CLIP state dict (no visual.conv1.weight)")
    vision_width = _np(sd["visual.conv1.weight"]).shape[0]
    patch = _np(sd["visual.conv1.weight"]).shape[-1]
    grid = round((_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5)
    return ClipConfig(
        image_resolution=patch * grid,
        vision_layers=len({k.split(".")[3] for k in sd
                           if k.startswith("visual.transformer.resblocks.")}),
        vision_width=vision_width,
        vision_patch_size=patch,
        **_text_fields(sd),
    )


def from_openai_state_dict(sd: Mapping, cfg: ClipConfig | None = None,
                           device=None):
    """OpenAI CLIP state dict -> (CLIP module on ``device``, ClipConfig)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = config_from_state_dict(sd)
    with torch.device("meta"):
        model = CLIP(cfg)
    model.to_empty(device=dev)
    skip = ("input_resolution", "context_length", "vocab_size")
    model.load_state_dict(
        {k: torch.tensor(_np(v)) for k, v in sd.items()
         if k not in skip and not k.endswith("num_batches_tracked")})
    return model, cfg


def _blocks_to_sd(blocks: Mapping, prefix: str, layers: int) -> dict:
    sd = {}
    for i in range(layers):
        p = f"{prefix}.{i}."
        for jk, tk in _NORMS:
            sd[p + tk + ".weight"] = _np(blocks[jk]["scale"][i])
            sd[p + tk + ".bias"] = _np(blocks[jk]["bias"][i])
        for jk, tk in _LINEARS:
            sd[p + tk] = _np(blocks[jk][i]).T
        for jk, tk in _VECTORS:
            sd[p + tk] = _np(blocks[jk][i])
    return sd


def from_jax_params(params: Mapping, cfg: ClipConfig, device=None) -> CLIP:
    """JAX param pytree (numpy leaves) -> CLIP module on ``device``."""
    v, t = params["visual"], params["text"]
    sd = {
        "token_embedding.weight": _np(t["token_embedding"]),
        "positional_embedding": _np(t["pos_embed"]),
        "ln_final.weight": _np(t["ln_final"]["scale"]),
        "ln_final.bias": _np(t["ln_final"]["bias"]),
        "text_projection": _np(t["projection"]),
        "logit_scale": _np(params["logit_scale"]),
    }
    sd.update(_blocks_to_sd(t["blocks"], "transformer.resblocks", cfg.text_layers))
    if cfg.vision_arch == "resnet":
        sd.update(resnet_state_dict_from_jax(v))
        return from_openai_state_dict(sd, cfg, device=device)[0]
    w, p = cfg.vision_width, cfg.vision_patch_size
    sd.update({
        "visual.conv1.weight": _np(v["patch_embed"]).T.reshape(w, 3, p, p),
        "visual.class_embedding": _np(v["class_embedding"]),
        "visual.positional_embedding": _np(v["pos_embed"]),
        "visual.ln_pre.weight": _np(v["ln_pre"]["scale"]),
        "visual.ln_pre.bias": _np(v["ln_pre"]["bias"]),
        "visual.ln_post.weight": _np(v["ln_post"]["scale"]),
        "visual.ln_post.bias": _np(v["ln_post"]["bias"]),
        "visual.proj": _np(v["proj"]),
    })
    sd.update(_blocks_to_sd(v["blocks"], "visual.transformer.resblocks",
                            cfg.vision_layers))
    return from_openai_state_dict(sd, cfg, device=device)[0]


def _sd_to_blocks(sd: Mapping, prefix: str, layers: int) -> dict:
    def stack(key, transpose=False):
        out = np.stack([_np(sd[f"{prefix}.{i}.{key}"]) for i in range(layers)])
        return np.swapaxes(out, -1, -2) if transpose else out

    blocks = {jk: {"scale": stack(tk + ".weight"), "bias": stack(tk + ".bias")}
              for jk, tk in _NORMS}
    blocks.update({jk: stack(tk, transpose=True) for jk, tk in _LINEARS})
    blocks.update({jk: stack(tk) for jk, tk in _VECTORS})
    return blocks


def to_jax_params(model: CLIP, cfg: ClipConfig) -> dict:
    """CLIP module -> the JAX package's param pytree, as numpy arrays."""
    sd = model.state_dict()
    ln = lambda k: {"scale": _np(sd[k + ".weight"]),  # noqa: E731
                    "bias": _np(sd[k + ".bias"])}
    if cfg.vision_arch == "resnet":
        visual = resnet_jax_from_state_dict(sd)
    else:
        conv_w = _np(sd["visual.conv1.weight"])
        visual = {
            "patch_embed": conv_w.reshape(conv_w.shape[0], -1).T,
            "class_embedding": _np(sd["visual.class_embedding"]),
            "pos_embed": _np(sd["visual.positional_embedding"]),
            "ln_pre": ln("visual.ln_pre"),
            "ln_post": ln("visual.ln_post"),
            "blocks": _sd_to_blocks(sd, "visual.transformer.resblocks",
                                    cfg.vision_layers),
            "proj": _np(sd["visual.proj"]),
        }
    return {
        "visual": visual,
        "text": {
            "token_embedding": _np(sd["token_embedding.weight"]),
            "pos_embed": _np(sd["positional_embedding"]),
            "blocks": _sd_to_blocks(sd, "transformer.resblocks", cfg.text_layers),
            "ln_final": ln("ln_final"),
            "projection": _np(sd["text_projection"]),
        },
        "logit_scale": _np(sd["logit_scale"]),
    }


def load_clip_checkpoint(path: str, device=None):
    """Load an OpenAI CLIP ``.pt`` checkpoint (a TorchScript archive or a
    state dict) -> (CLIP module, ClipConfig)."""
    try:
        obj = torch.jit.load(path, map_location="cpu")
        sd = obj.state_dict()
    except RuntimeError:  # not a TorchScript archive: a pickled state dict
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_openai_state_dict(sd, device=device)
