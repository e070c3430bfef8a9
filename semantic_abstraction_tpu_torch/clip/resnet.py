"""The ModifiedResNet CLIP image tower (RN50 and its kin) in PyTorch.

Counterpart of ``semantic_abstraction_tpu/clip/resnet.py`` (reference
CLIP/clip/model_explainability.py: Bottleneck :17-67, AttentionPool2d
:71-117, ModifiedResNet :120-185). It serves visual features only (the
Chefer relevancy is transformer-only). As in ``clip/model.py``, the
modules hold the parameters in the reference state-dict layout (``conv1``,
``bn1``, ..., ``layerN.i.downsample.{0,1}``, ``attnpool.{q,k,v,c}_proj``,
``attnpool.positional_embedding``) and plain functions run the forward, in
the JAX package's order of roundings:

- BatchNorm is inference-only: its buffers are folded into a scale and a
  bias in f32, cast to the activation dtype, then ``x * scale + bias``
  (``nn.BatchNorm2d`` on a bf16 input would round elsewhere). A
  checkpoint's ``num_batches_tracked`` is not kept.
- The anti-aliasing average pool adds the window's elements one by one in
  the activation dtype, as ``reduce_window`` does, then divides
  (``avg_pool2d`` would accumulate in f32).
- The attention pool queries from the mean token only (torch's
  ``multi_head_attention_forward`` attends from every token and keeps row
  0; the values are the same): logits in f32, probabilities in the compute
  dtype. Linears are a matmul then a bias add, each rounded.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """A BatchNorm2d's parameters and running statistics (no forward)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))


def _conv(c_in: int, c_out: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck: every conv at stride 1, an average pool
    after conv2 when the stride is above 1; the shortcut is an average pool
    and a 1x1 conv (``downsample.0``) with its BatchNorm (``downsample.1``)
    where the shape changes."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BatchNorm(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = BatchNorm(planes * self.expansion)
        self.downsample = None
        if stride > 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", _conv(inplanes, planes * self.expansion, 1))
            self.downsample.add_module("1", BatchNorm(planes * self.expansion))


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim**2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)


class ModifiedResNet(nn.Module):
    """A 3-conv stem and an average pool, 4 bottleneck stages, and the
    attention pool (reference :120-185)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        self.heads = heads
        self.conv1, self.bn1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1,
                                         bias=False), BatchNorm(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), BatchNorm(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), BatchNorm(width)
        inplanes = width
        for i, n in enumerate(layers):
            planes = width * 2**i
            blocks = [Bottleneck(inplanes, planes, 1 if i == 0 else 2)]
            inplanes = planes * Bottleneck.expansion
            blocks += [Bottleneck(inplanes, planes) for _ in range(1, n)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads,
                                        output_dim)

    @property
    def stages(self) -> Tuple[nn.Sequential, ...]:
        return (self.layer1, self.layer2, self.layer3, self.layer4)


# ---------------------------------------------------------------------------
# Forward functions (one per JAX function)
# ---------------------------------------------------------------------------


def _bn(x: torch.Tensor, bn: BatchNorm, eps: float = 1e-5) -> torch.Tensor:
    inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    scale = inv.to(x.dtype)[:, None, None]
    bias = (bn.bias.float() - bn.running_mean.float() * inv).to(x.dtype)[:, None, None]
    return x * scale + bias


def _conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), stride=conv.stride, padding=conv.padding)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool at stride k: the window's elements added in
    row-major order in x's dtype, then divided by k * k."""
    if k <= 1:
        return x
    b, c, h, w = x.shape
    win = x[:, :, : h // k * k, : w // k * k].reshape(b, c, h // k, k, w // k, k)
    s = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(k):
        for j in range(k):
            s = s + win[:, :, :, i, :, j]
    return s / (k * k)


def _bottleneck(block: Bottleneck, x: torch.Tensor) -> torch.Tensor:
    out = torch.relu(_bn(_conv2d(x, block.conv1), block.bn1))
    out = torch.relu(_bn(_conv2d(out, block.conv2), block.bn2))
    out = _avg_pool(out, block.stride)
    out = _bn(_conv2d(out, block.conv3), block.bn3)
    identity = x
    if block.downsample is not None:
        conv, bn = block.downsample[0], block.downsample[1]
        identity = _bn(_conv2d(_avg_pool(x, block.stride), conv), bn)
    return torch.relu(out + identity)


def _proj(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return torch.matmul(x, lin.weight.to(x.dtype).t()) + lin.bias.to(x.dtype)


def _attention_pool(pool: AttentionPool2d, x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, output_dim): QKV attention from the mean token
    over [mean, tokens] + positional embedding."""
    b, c = x.shape[:2]
    tokens = x.reshape(b, c, -1).transpose(1, 2)
    t = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    t = t + pool.positional_embedding.to(t.dtype)[None]
    heads = pool.num_heads
    hd = c // heads

    def to_heads(a):
        return a.reshape(b, -1, heads, hd).transpose(1, 2)

    q = to_heads(_proj(t[:, :1], pool.q_proj)) * (hd**-0.5)
    k, v = to_heads(_proj(t, pool.k_proj)), to_heads(_proj(t, pool.v_proj))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(t.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, c)
    return _proj(out, pool.c_proj)


def modified_resnet_forward(visual: ModifiedResNet, pixels: torch.Tensor,
                            compute_dtype=torch.float32) -> torch.Tensor:
    """(B, 3, H, W) -> (B, output_dim) (reference ModifiedResNet.forward
    :167-185)."""
    x = pixels.to(compute_dtype)
    x = torch.relu(_bn(_conv2d(x, visual.conv1), visual.bn1))
    x = torch.relu(_bn(_conv2d(x, visual.conv2), visual.bn2))
    x = torch.relu(_bn(_conv2d(x, visual.conv3), visual.bn3))
    x = _avg_pool(x, 2)
    for stage in visual.stages:
        for block in stage:
            x = _bottleneck(block, x)
    return _attention_pool(visual.attnpool, x)


# ---------------------------------------------------------------------------
# The reference state dict and the JAX package's pytree
# ---------------------------------------------------------------------------


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape)


def resnet_config_from_state_dict(sd: Mapping, prefix: str = "visual.") -> dict:
    """The ModifiedResNet config from the state dict's keys and shapes
    (reference build_model :549-557)."""
    counts = []
    for stage in range(1, 5):
        counts.append(len({int(k[len(prefix):].split(".")[1]) for k in sd
                           if k.startswith(f"{prefix}layer{stage}.")}))
    width = _shape(sd[f"{prefix}layer1.0.conv1.weight"])[0]
    spacial = int(round((_shape(sd[f"{prefix}attnpool.positional_embedding"])[0] - 1)
                        ** 0.5))
    return {
        "layers": tuple(counts),
        "width": width,
        "output_dim": _shape(sd[f"{prefix}attnpool.c_proj.weight"])[0],
        "heads": width * 32 // 64,
        "input_resolution": spacial * 32,
    }


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


_BN_KEYS = ("weight", "bias", "running_mean", "running_var")
_STEM = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))
_POOL = ("q", "k", "v", "c")


def resnet_state_dict_from_jax(visual: Mapping, prefix: str = "visual.") -> dict:
    """The JAX package's ResNet pytree (HWIO convs, (in, out) linears, raw
    BatchNorm buffers; ``clip/resnet.py`` ``convert_resnet_visual``) ->
    the reference state dict (numpy)."""
    sd = {}

    def conv(key, w):
        sd[f"{prefix}{key}.weight"] = _np(w).transpose(3, 2, 0, 1)  # HWIO -> OIHW

    def bn(key, p):
        sd.update({f"{prefix}{key}.{k}": _np(p[k]) for k in _BN_KEYS})

    for c, b in _STEM:
        conv(c, visual["stem"][c])
        bn(b, visual["stem"][b])
    for si, stage in enumerate(visual["layers"]):
        for bi, block in enumerate(stage):
            base = f"layer{si + 1}.{bi}"
            for c, b in _STEM:
                conv(f"{base}.{c}", block[c])
                bn(f"{base}.{b}", block[b])
            if "downsample_conv" in block:
                conv(f"{base}.downsample.0", block["downsample_conv"])
                bn(f"{base}.downsample.1", block["downsample_bn"])
    ap = visual["attnpool"]
    sd[f"{prefix}attnpool.positional_embedding"] = _np(ap["pos_embed"])
    for n in _POOL:
        sd[f"{prefix}attnpool.{n}_proj.weight"] = _np(ap[f"{n}_w"]).T
        sd[f"{prefix}attnpool.{n}_proj.bias"] = _np(ap[f"{n}_b"])
    return sd


def resnet_jax_from_state_dict(sd: Mapping, prefix: str = "visual.") -> dict:
    """The reference state dict -> the JAX package's ResNet pytree (numpy),
    the inverse of ``resnet_state_dict_from_jax``."""
    counts = resnet_config_from_state_dict(sd, prefix)["layers"]

    def conv(key):
        return _np(sd[f"{prefix}{key}.weight"]).transpose(2, 3, 1, 0)  # OIHW -> HWIO

    def bn(key):
        return {k: _np(sd[f"{prefix}{key}.{k}"]) for k in _BN_KEYS}

    stem = {}
    for c, b in _STEM:
        stem[c], stem[b] = conv(c), bn(b)
    layers = []
    for stage in range(1, 5):
        blocks = []
        for bi in range(counts[stage - 1]):
            base = f"layer{stage}.{bi}"
            block = {}
            for c, b in _STEM:
                block[c], block[b] = conv(f"{base}.{c}"), bn(f"{base}.{b}")
            if f"{prefix}{base}.downsample.0.weight" in sd:
                block["downsample_conv"] = conv(f"{base}.downsample.0")
                block["downsample_bn"] = bn(f"{base}.downsample.1")
            blocks.append(block)
        layers.append(blocks)
    ap = f"{prefix}attnpool."
    attnpool = {"pos_embed": _np(sd[ap + "positional_embedding"])}
    for n in _POOL:
        attnpool[f"{n}_w"] = _np(sd[f"{ap}{n}_proj.weight"]).T
        attnpool[f"{n}_b"] = _np(sd[f"{ap}{n}_proj.bias"])
    return {"stem": stem, "layers": layers, "attnpool": attnpool}
