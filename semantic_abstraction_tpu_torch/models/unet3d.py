"""Residual 3D UNet (the reference's pytorch-3dunet ``ResidualUNet3D``).

Counterpart of ``semantic_abstraction_tpu/models/unet3d.py`` in its dense
form (``residual_unet3d(..., blocked_levels=0)``): one NCDHW layout, no
space-to-depth basis and no remat. The reference semantics it keeps:

- ExtResNetBlock with layer order "gcr": GroupNorm over the conv's INPUT
  channels -> Conv3d(bias=False) -> ReLU for conv1/conv2; conv3 has no
  ReLU; the residual (conv1's output) is added, then ReLU.
- Encoders: MaxPool3d(2) before the block on every level but the first.
- Decoders: ConvTranspose3d(k=3, stride=2, padding=1, output_padding=1),
  sum joining with the skip, then an ExtResNetBlock.
- The final 1x1x1 Conv3d with bias, as a channel matmul.

GroupNorm keeps the JAX formulation: the per-channel moments (Σx, Σx²)
come in f32 from the ``channel_moments`` kernel, the group statistics are
pooled from them with var = E[x²] − mean² clamped at 0, and the
normalization is one per-channel affine applied in the data's dtype, with
the scale and shift rounded to it. The convs are cuDNN's, in the compute
dtype the caller casts to. The modules hold the parameters under the
reference's state-dict names.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.channel_moments import channel_moments
from .params import Params


def feature_maps_per_level(f_maps: int, num_levels: int) -> List[int]:
    """[f, 2f, 4f, ...] (reference unet3d.py:12-13)."""
    return [f_maps * 2**k for k in range(num_levels)]


class SingleConv(nn.Module):
    """"gcr"/"gc" conv: ``groupnorm`` on the c_in input channels, ``conv``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.groupnorm = Params(weight=(c_in,), bias=(c_in,))
        self.conv = Params(weight=(c_out, c_in, 3, 3, 3))


class ExtResNetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = SingleConv(c_in, c_out)
        self.conv2 = SingleConv(c_out, c_out)
        self.conv3 = SingleConv(c_out, c_out)


class Encoder(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.basic_module = ExtResNetBlock(c_in, c_out)


class Upsampling(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        # ConvTranspose3d layout: (in, out, 3, 3, 3)
        self.upsample = Params(weight=(c_in, c_out, 3, 3, 3), bias=(c_out,))


class Decoder(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.upsampling = Upsampling(c_in, c_out)
        self.basic_module = ExtResNetBlock(c_out, c_out)


class ResidualUNet3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, fmaps: Sequence[int]):
        super().__init__()
        ins = [in_channels, *fmaps[:-1]]
        self.encoders = nn.ModuleList(Encoder(i, o) for i, o in zip(ins, fmaps))
        rev = list(reversed(fmaps))
        self.decoders = nn.ModuleList(Decoder(i, o) for i, o in zip(rev, rev[1:]))
        self.final_conv = Params(weight=(out_channels, fmaps[0], 1, 1, 1),
                                 bias=(out_channels,))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (B, C, D, H, W) with f32 statistics; ``num_groups``
    falls to 1 when C < num_groups. x must be contiguous NCDHW: the
    moments kernel reads each channel as one run (it raises otherwise)."""
    b, c = x.shape[:2]
    g = num_groups if c >= num_groups else 1
    x_flat = x.view(b, c, -1)
    n = x_flat.shape[2]
    s1, s2 = channel_moments(x_flat)
    s1, s2 = s1 / n, s2 / n  # (B, C) f32
    gm = s1.view(b, g, c // g).mean(-1)  # (B, G)
    var = s2.view(b, g, c // g).mean(-1) - gm * gm
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    sc = inv.repeat_interleave(c // g, 1) * scale.float()[None]  # (B, C)
    bi = bias.float()[None] - gm.repeat_interleave(c // g, 1) * sc
    shape = (b, c) + (1,) * (x.dim() - 2)
    return x * sc.to(x.dtype).reshape(shape) + bi.to(x.dtype).reshape(shape)


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose3d(k=3, stride 2, padding 1, output_padding 1), its
    weight in torch's (I, O, k, k, k) layout; the bias is added in x's
    dtype after the convolution, as in the JAX package."""
    out = F.conv_transpose3d(x, p.weight.to(x.dtype), stride=2, padding=1,
                             output_padding=1)
    return out + p.bias.to(out.dtype).reshape(1, -1, 1, 1, 1)


def _single_conv(p: SingleConv, x: torch.Tensor, num_groups: int,
                 relu: bool) -> torch.Tensor:
    x = group_norm(x, p.groupnorm.weight, p.groupnorm.bias, num_groups)
    x = F.conv3d(x, p.conv.weight.to(x.dtype), padding=1)
    return torch.relu(x) if relu else x


def ext_resnet_block(p: ExtResNetBlock, x: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """Reference ExtResNetBlock forward (unet3d.py:244-259)."""
    out = _single_conv(p.conv1, x, num_groups, relu=True)
    residual = out
    out = _single_conv(p.conv2, out, num_groups, relu=True)
    out = _single_conv(p.conv3, out, num_groups, relu=False)
    return torch.relu(out + residual)


def residual_unet3d(unet: ResidualUNet3D, x: torch.Tensor, num_groups: int = 8,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, C_in, D, H, W) -> (B, C_out, D, H, W), in ``compute_dtype`` if
    given (else x's dtype)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    skips = []
    for i, enc in enumerate(unet.encoders):
        if i > 0:
            x = F.max_pool3d(x, 2)
        x = ext_resnet_block(enc.basic_module, x, num_groups)
        skips.insert(0, x)
    # the deepest level's output is x itself, not a skip
    for dec, skip in zip(unet.decoders, skips[1:]):
        x = _upsample(dec.upsampling.upsample, x) + skip  # sum joining
        x = ext_resnet_block(dec.basic_module, x, num_groups)
    fw = unet.final_conv.weight.to(x.dtype)[:, :, 0, 0, 0]
    out = torch.einsum("bcdhw,oc->bodhw", x, fw)
    return out + unet.final_conv.bias.to(x.dtype).reshape(1, -1, 1, 1, 1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _init_block_(block: ExtResNetBlock, generator: torch.Generator) -> None:
    for conv in (block.conv1, block.conv2, block.conv3):
        # torch Conv3d default: kaiming_uniform(a=sqrt(5)) == U(-b, b),
        # b = 1/sqrt(fan_in)
        _uniform_(conv.conv.weight, (conv.conv.weight.shape[1] * 27) ** -0.5,
                  generator)
        with torch.no_grad():
            conv.groupnorm.weight.fill_(1.0)
            conv.groupnorm.bias.fill_(0.0)


def init_residual_unet3d(generator: torch.Generator, in_channels: int,
                         out_channels: int,
                         f_maps: Union[int, Sequence[int]] = 64,
                         num_levels: int = 5) -> ResidualUNet3D:
    """A ``ResidualUNet3D`` on the CPU, drawn from ``generator`` with the
    JAX package's distributions (reference defaults at utils.py:56-59:
    f_maps=16, num_levels=6, num_groups=8, in/out=16)."""
    fmaps = (feature_maps_per_level(f_maps, num_levels)
             if isinstance(f_maps, int) else list(f_maps))
    unet = ResidualUNet3D(in_channels, out_channels, fmaps)
    for enc in unet.encoders:
        _init_block_(enc.basic_module, generator)
    for dec in unet.decoders:
        up = dec.upsampling.upsample
        bound = (up.weight.shape[0] * 27) ** -0.5
        _uniform_(up.weight, bound, generator)
        _uniform_(up.bias, bound, generator)
        _init_block_(dec.basic_module, generator)
    bound = fmaps[0] ** -0.5
    _uniform_(unet.final_conv.weight, bound, generator)
    _uniform_(unet.final_conv.bias, bound, generator)
    return unet
