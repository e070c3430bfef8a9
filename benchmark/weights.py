"""Random weights in each configuration's published layout, made from the
seed on the run's device in one draw a model.

The benchmark hands the same state dict to the program (through the
program's own loaders) and to the plain reference, so neither side's
weights come from the other. A draw is one ``torch.randn`` of every
random element together, from a ``torch.Generator`` on the device; the
tensors are views of it, scaled.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (key, shape, kind, scale): kind "normal" (scale x N(0, 1)), "one" (1 +
# scale x N(0, 1)), "const" (the value ``scale``)
Spec = Tuple[str, Tuple[int, ...], str, float]


def _draw(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    n = sum(math.prod(shape) for _, shape, kind, _ in specs if kind != "const")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape, kind, scale in specs:
        if kind == "const":
            out[key] = torch.full(shape, scale, device=device, dtype=torch.float32)
            continue
        size = math.prod(shape)
        t = flat[at:at + size].view(shape)
        at += size
        out[key] = t * scale if kind == "normal" else 1.0 + t * scale
    return out


def _blocks(prefix: str, width: int, layers: int) -> List[Spec]:
    """Residual attention blocks under OpenAI's keys, with CLIP's init
    scales (attention W^-1/2, projections W^-1/2 (2L)^-1/2, fc (2W)^-1/2);
    biases and LayerNorms drawn near their defaults so that each enters
    the result."""
    proj = width ** -0.5 * (2 * layers) ** -0.5
    specs = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}."
        specs += [
            (p + "attn.in_proj_weight", (3 * width, width), "normal", width ** -0.5),
            (p + "attn.in_proj_bias", (3 * width,), "normal", 0.02),
            (p + "attn.out_proj.weight", (width, width), "normal", proj),
            (p + "attn.out_proj.bias", (width,), "normal", 0.02),
            (p + "ln_1.weight", (width,), "one", 0.02),
            (p + "ln_1.bias", (width,), "normal", 0.02),
            (p + "mlp.c_fc.weight", (4 * width, width), "normal", (2 * width) ** -0.5),
            (p + "mlp.c_fc.bias", (4 * width,), "normal", 0.02),
            (p + "mlp.c_proj.weight", (width, 4 * width), "normal", proj),
            (p + "mlp.c_proj.bias", (width,), "normal", 0.02),
            (p + "ln_2.weight", (width,), "one", 0.02),
            (p + "ln_2.bias", (width,), "normal", 0.02),
        ]
    return specs


def clip_specs(c: dict) -> List[Spec]:
    """An OpenAI CLIP ViT state dict's keys and shapes (github.com/openai/CLIP
    model.py), for the sizes of configuration ``c``."""
    vw, tw, p = c["vision_width"], c["text_width"], c["vision_patch_size"]
    tokens = (c["image_resolution"] // p) ** 2 + 1
    return [
        ("visual.conv1.weight", (vw, 3, p, p), "normal", (3 * p * p) ** -0.5),
        ("visual.class_embedding", (vw,), "normal", vw ** -0.5),
        ("visual.positional_embedding", (tokens, vw), "normal", vw ** -0.5),
        ("visual.ln_pre.weight", (vw,), "one", 0.02),
        ("visual.ln_pre.bias", (vw,), "normal", 0.02),
        *_blocks("visual.transformer", vw, c["vision_layers"]),
        ("visual.ln_post.weight", (vw,), "one", 0.02),
        ("visual.ln_post.bias", (vw,), "normal", 0.02),
        ("visual.proj", (vw, c["embed_dim"]), "normal", vw ** -0.5),
        ("token_embedding.weight", (c["vocab_size"], tw), "normal", 0.02),
        ("positional_embedding", (c["context_length"], tw), "normal", 0.01),
        *_blocks("transformer", tw, c["text_layers"]),
        ("ln_final.weight", (tw,), "one", 0.02),
        ("ln_final.bias", (tw,), "normal", 0.02),
        ("text_projection", (tw, c["embed_dim"]), "normal", tw ** -0.5),
        ("logit_scale", (), "const", math.log(1 / 0.07)),
    ]


def clip_state_dict(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return _draw(clip_specs(c), seed, device)


def unet_fmaps(c: dict) -> List[int]:
    return [c["unet_f_maps"] * 2 ** k for k in range(c["unet_num_levels"])]


def _uniform_as_normal(bound: float) -> float:
    """The std of U(-b, b): torch's default Linear/Conv init, drawn here as
    a normal of the same spread."""
    return bound / math.sqrt(3.0)


def semabs3d_specs(c: dict) -> List[Spec]:
    """The reference SemAbs3D state dict (real-stanford/semantic-abstraction
    net.py SemAbs3D, pytorch-3dunet ResidualUNet3D) for configuration
    ``c``: the point-feature MLP, the UNet's ExtResNetBlocks ("gcr": a
    GroupNorm over each conv's input channels), the transposed-conv
    upsamplings, the final 1x1x1 conv and the implicit decoder's MLP."""
    specs: List[Spec] = [("steps", (1,), "const", 0.0)]
    ch, hid = c["unet_num_channels"], c["pts_feat_extractor_hidden_dim"]
    feat = 1  # network_inputs ("saliency",): one feature a point
    for i, (a, b) in enumerate(((feat + 3, hid), (hid, hid), (hid, ch))):
        s = _uniform_as_normal(a ** -0.5)
        specs += [(f"pts_feat_extractor.{2 * i}.weight", (b, a), "normal", s),
                  (f"pts_feat_extractor.{2 * i}.bias", (b,), "normal", s)]
    fmaps = unet_fmaps(c)

    def block(prefix, c_in, c_out):
        out = []
        for j, ci in enumerate((c_in, c_out, c_out), start=1):
            q = f"{prefix}.basic_module.conv{j}."
            out += [(q + "groupnorm.weight", (ci,), "one", 0.05),
                    (q + "groupnorm.bias", (ci,), "normal", 0.05),
                    (q + "conv.weight", (c_out, ci, 3, 3, 3), "normal",
                     _uniform_as_normal((ci * 27) ** -0.5))]
        return out

    u = "vol_feature_extractor"
    for i, (a, b) in enumerate(zip([ch] + fmaps[:-1], fmaps)):
        specs += block(f"{u}.encoders.{i}", a, b)
    rev = fmaps[::-1]
    for i, (a, b) in enumerate(zip(rev, rev[1:])):
        s = _uniform_as_normal((a * 27) ** -0.5)
        specs += [(f"{u}.decoders.{i}.upsampling.upsample.weight", (a, b, 3, 3, 3),
                   "normal", s),
                  (f"{u}.decoders.{i}.upsampling.upsample.bias", (b,), "normal", s)]
        specs += block(f"{u}.decoders.{i}", b, b)
    s = _uniform_as_normal(fmaps[0] ** -0.5)
    specs += [(f"{u}.final_conv.weight", (ch, fmaps[0], 1, 1, 1), "normal", s),
              (f"{u}.final_conv.bias", (ch,), "normal", s)]
    d_in = ch + 3 * bool(c["decoder_concat_xyz_pts"])
    for name, (a, b) in (("0", (d_in, ch)), ("2", (ch, c["output_dim"]))):
        s = _uniform_as_normal(a ** -0.5)
        specs += [(f"visual_sampler.mlp.{name}.weight", (b, a), "normal", s),
                  (f"visual_sampler.mlp.{name}.bias", (b,), "normal", s)]
    return specs


def semabs3d_state_dict(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return _draw(semabs3d_specs(c), seed, device)
