"""CLIP (a ViT or ModifiedResNet image tower + text transformer) in PyTorch.

Counterpart of ``semantic_abstraction_tpu/clip/model.py``. The parameters
live in ``nn.Module``s laid out like the OpenAI CLIP state dict (so
``convert.from_openai_state_dict`` is a key-for-key load); the forward is a
set of plain functions over those modules that mirror the JAX functions one
for one:

- LayerNorm always computes in f32 and casts back; everything else runs in
  the caller's ``compute_dtype`` (bf16 on the card by default).
- ``_attention`` returns the softmax probs and adds an optional ``attn_eps``
  to them before the value product, which exposes d(out)/d(probs) to
  autograd (the Chefer relevancy's quantity).
- ``_attention_fast`` is the no-probs path through the fused kernel
  (``ops.fused_mha``): every block of the relevancy head scan and
  ``encode_image``.
- Where autograd records through a block's LayerNorm or quick-GELU (the
  general relevancy tail), they run as autograd Functions of the same
  forward ops whose input gradient is one pass (``ops.tail_backward``).
- Patch embedding is patchify + matmul, not a convolution (no cuDNN, no
  TF32).
- ``encode_image`` dispatches on ``ClipConfig.vision_arch``: "vit", or
  "resnet" for the ModifiedResNet tower of ``clip/resnet.py`` (visual
  features only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_mha import fused_mha
from ..ops.tail_backward import layer_norm_backward, quick_gelu_backward


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # "vit" or "resnet" (the ModifiedResNet tower, clip/resnet.py);
    # resnet_layers holds the bottlenecks of each stage (RN50: 3, 4, 6, 3)
    vision_arch: str = "vit"
    resnet_layers: Tuple[int, ...] = ()

    @property
    def vision_heads(self) -> int:
        if self.vision_arch == "resnet":
            # the attention pool's width is vision_width * 32 (reference :160-163)
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def vision_tokens(self) -> int:
        return (self.image_resolution // self.vision_patch_size) ** 2 + 1


VIT_B_32 = ClipConfig()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and is
    missing; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Modules: parameter containers in the OpenAI CLIP state-dict layout
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.attn = Attention(width)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = nn.LayerNorm(width)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width) for _ in range(layers))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Conv2d(3, w, p, p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.vision_tokens, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))


class CLIP(nn.Module):
    """CLIP parameters; ``visual`` is a ``VisionTransformer`` or, for
    ``vision_arch="resnet"``, a ``ModifiedResNet``. Build with
    ``init_clip_params`` (ViT) or the loaders in ``convert``; the forward
    functions below read the parameters."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        if cfg.vision_arch == "resnet":
            from .resnet import ModifiedResNet

            self.visual = ModifiedResNet(cfg.resnet_layers, cfg.embed_dim, cfg.vision_heads,
                                         cfg.image_resolution, cfg.vision_width)
        else:
            self.visual = VisionTransformer(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers)
        self.ln_final = nn.LayerNorm(cfg.text_width)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.text_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))


# ---------------------------------------------------------------------------
# Forward functions (one per JAX function)
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (``layer_norm``, the (..., 1) f32 mean and 1/std it used)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    out = (x32 - mean) * rstd
    out = out * scale.float() + bias.float()
    return out.to(x.dtype), mean, rstd


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 regardless of activation dtype."""
    return _layer_norm(x, scale, bias, eps)[0]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _LayerNorm(torch.autograd.Function):
    """``layer_norm`` (the same ops) whose input gradient is one pass,
    ``ops.tail_backward.layer_norm_backward``, in place of autograd's f32
    chain. Saves x in its own dtype, the mean and 1/std."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        out, mean, rstd = _layer_norm(x, scale, bias, eps)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        dx = dscale = dbias = None
        lead = tuple(range(g.dim() - 1))
        if ctx.needs_input_grad[0]:
            dx = layer_norm_backward(g, x, mean, rstd, scale)
        if ctx.needs_input_grad[1]:
            dscale = (g.float() * ((x.float() - mean) * rstd)).sum(lead).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = g.float().sum(lead).to(ctx.bias_dtype)
        return dx, dscale, dbias, None


class _QuickGelu(torch.autograd.Function):
    """``quick_gelu`` (the same ops) whose input gradient is one pass,
    ``ops.tail_backward.quick_gelu_backward``. Saves x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return quick_gelu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return quick_gelu_backward(g, x)


def _ln(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, mod.weight, mod.bias)


def _recorded(x: torch.Tensor) -> bool:
    """Whether autograd records what is computed from ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _block_ln(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``_ln`` of a block, through ``_LayerNorm`` where autograd records."""
    if _recorded(x):
        return _LayerNorm.apply(x, mod.weight, mod.bias, 1e-5)
    return _ln(mod, x)


def _block_gelu(x: torch.Tensor) -> torch.Tensor:
    """``quick_gelu`` of a block, through ``_QuickGelu`` where autograd
    records."""
    return _QuickGelu.apply(x) if _recorded(x) else quick_gelu(x)


def _linear(x: torch.Tensor, mod: nn.Linear) -> torch.Tensor:
    return F.linear(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))


def _qkv(block: ResidualAttentionBlock, x: torch.Tensor) -> torch.Tensor:
    a = block.attn
    return F.linear(x, a.in_proj_weight.to(x.dtype), a.in_proj_bias.to(x.dtype))


def _attention(block: ResidualAttentionBlock, x: torch.Tensor, num_heads: int,
               mask: Optional[torch.Tensor], attn_eps: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head self-attention returning (out, probs (B, H, T, T)).

    ``attn_eps`` (B, H, T, T) is added to the softmax probs before the value
    product; zeros leave the forward unchanged while exposing
    d(out)/d(probs) to autograd.
    """
    b, t, w = x.shape
    hd = w // num_heads
    q, k, v = _qkv(block, x).chunk(3, dim=-1)

    def to_heads(a):
        return a.reshape(b, t, num_heads, hd).transpose(1, 2)

    q, k, v = to_heads(q) * (hd**-0.5), to_heads(k), to_heads(v)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    if attn_eps is not None:
        probs = probs + attn_eps.to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, w)
    return _linear(out, block.attn.out_proj), probs


def _attention_fast(block: ResidualAttentionBlock, x: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """MHA without prob outputs through the fused kernel. q, k, v are
    strided views of the qkv projection (no split copy)."""
    q, k, v = _qkv(block, x).split(x.shape[-1], dim=-1)
    return _linear(fused_mha(q, k, v, num_heads), block.attn.out_proj)


def _block_forward(block, x, num_heads, mask=None, attn_eps=None,
                   need_probs=True):
    """Pre-LN residual attention block. With ``need_probs=False`` (and no
    mask/eps) attention runs through the fused kernel and probs is None."""
    xn = _block_ln(block.ln_1, x)
    if not need_probs and mask is None and attn_eps is None:
        attn_out, probs = _attention_fast(block, xn, num_heads), None
    else:
        attn_out, probs = _attention(block, xn, num_heads, mask, attn_eps)
    x = x + attn_out
    h = _block_gelu(_linear(_block_ln(block.ln_2, x), block.mlp.c_fc))
    return x + _linear(h, block.mlp.c_proj), probs


def transformer_forward(
    blocks: Sequence[ResidualAttentionBlock],
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    attn_eps: Optional[Sequence[torch.Tensor]] = None,
    need_probs: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the blocks in order. Returns (out, probs (L, B, H, T, T)); probs
    is None with ``need_probs=False`` (fused no-probs attention)."""
    fast = not need_probs and mask is None and attn_eps is None
    probs_all = []
    for i, block in enumerate(blocks):
        eps = None if attn_eps is None else attn_eps[i]
        x, probs = _block_forward(block, x, num_heads, mask, eps,
                                  need_probs=not fast)
        probs_all.append(probs)
    return x, (None if fast else torch.stack(probs_all))


def interpolate_positional_emb(pos_emb: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear interpolation of positional embeddings to ``target_len``
    tokens, anchored to the 50-token grid (reference quirk)."""
    src_len = pos_emb.shape[0]
    i3 = np.arange(target_len) / (target_len / 50.0)
    i1 = np.floor(i3).astype(int)
    i2 = np.ceil(i3).astype(int)
    frac = torch.as_tensor(i3 - i1, dtype=pos_emb.dtype,
                           device=pos_emb.device)[:, None]
    in_range = torch.as_tensor(i2 < src_len, device=pos_emb.device)[:, None]
    i1c = torch.as_tensor(np.clip(i1, 0, src_len - 1), device=pos_emb.device)
    i2c = torch.as_tensor(np.clip(i2, 0, src_len - 1), device=pos_emb.device)
    lerped = pos_emb[i1c] * (1 - frac) + pos_emb[i2c] * frac
    return torch.where(in_range, lerped, pos_emb[-1])


def patchify(pixels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, H/p * W/p, 3*p*p) patches, flattened in the
    (C, kh, kw) order of the conv weight."""
    b, c, h, w = pixels.shape
    gh, gw = h // patch_size, w // patch_size
    x = pixels.reshape(b, c, gh, patch_size, gw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * patch_size * patch_size)


def _embed(visual: VisionTransformer, pixels: torch.Tensor, cfg: ClipConfig,
           compute_dtype) -> torch.Tensor:
    """Patch embed + class token + positional embedding + ln_pre."""
    x = patchify(pixels.to(compute_dtype), cfg.vision_patch_size)
    w_patch = visual.conv1.weight.reshape(visual.conv1.weight.shape[0], -1)
    x = torch.matmul(x, w_patch.to(compute_dtype).t())
    b, _, w = x.shape
    cls = visual.class_embedding.to(compute_dtype).expand(b, 1, w)
    x = torch.cat([cls, x], dim=1)
    pos = visual.positional_embedding
    # reference quirk: interpolation whenever the token count is not 50
    # (ViT-B/32 at 224^2), anchored to the 50-token grid, even when the
    # embedding already has the right length
    if x.shape[1] != 50:
        pos = interpolate_positional_emb(pos, x.shape[1])
    x = x + pos.to(compute_dtype)
    return _ln(visual.ln_pre, x)


def vit_forward(
    visual: VisionTransformer,
    pixels: torch.Tensor,
    cfg: ClipConfig,
    compute_dtype=torch.float32,
    attn_eps: Optional[Sequence[torch.Tensor]] = None,
    attn_mask: Optional[torch.Tensor] = None,
    need_probs: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ViT image encoder: pixels (B, 3, H, W) -> (features (B, E), probs
    (L, B, H, T, T) or None). ``attn_mask`` is an additive (T, T) mask
    applied in every block."""
    x = _embed(visual, pixels, cfg, compute_dtype)
    x, probs = transformer_forward(
        visual.transformer.resblocks, x, cfg.vision_heads, mask=attn_mask,
        attn_eps=attn_eps, need_probs=need_probs,
    )
    x = _ln(visual.ln_post, x[:, 0, :])
    return torch.matmul(x, visual.proj.to(compute_dtype)), probs


def causal_mask(t: int, device=None) -> torch.Tensor:
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


def encode_text(model: CLIP, tokens: torch.Tensor, cfg: ClipConfig,
                compute_dtype=torch.float32) -> torch.Tensor:
    """(B, 77) int tokens -> (B, E) features, EOT pooling by argmax id."""
    tokens = tokens.long()
    x = model.token_embedding.weight[tokens].to(compute_dtype)
    x = x + model.positional_embedding.to(compute_dtype)
    x, _ = transformer_forward(
        model.transformer.resblocks, x, cfg.text_heads,
        mask=causal_mask(tokens.shape[1], device=x.device),
    )
    x = _ln(model.ln_final, x)
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return torch.matmul(pooled, model.text_projection.to(compute_dtype))


def encode_image(model: CLIP, pixels: torch.Tensor, cfg: ClipConfig,
                 compute_dtype=torch.float32, tile_attn_mask=None) -> torch.Tensor:
    """(B, 3, H, W) pixels -> (B, E) image features, through the ViT (with
    an optional additive (T, T) ``tile_attn_mask`` in every block) or the
    ModifiedResNet."""
    if cfg.vision_arch == "resnet":
        if tile_attn_mask is not None:
            raise ValueError(
                "tile_attn_mask is transformer-only (reference "
                "CLIP/clip/model.py:250-273 patches the Transformer tower)")
        from .resnet import modified_resnet_forward

        return modified_resnet_forward(model.visual, pixels, compute_dtype)
    feats, _ = vit_forward(
        model.visual, pixels, cfg, compute_dtype, attn_mask=tile_attn_mask,
        need_probs=False,
    )
    return feats


def _init_numpy_params(seed: int, cfg: ClipConfig) -> dict:
    """The JAX package's random init as a numpy pytree, drawn from
    ``np.random.RandomState(seed)`` in the JAX order, so that seed s gives
    the weights of JAX ``init_clip_params(jax.random.PRNGKey(s))``."""
    rs = np.random.RandomState(seed % (2**31))
    vw, tw = cfg.vision_width, cfg.text_width
    vscale = vw**-0.5

    def normal(shape, scale):
        return rs.randn(*shape).astype(np.float32) * scale

    def ln(n):
        return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}

    def blocks(layers, width, scale_attn, scale_proj, scale_fc):
        zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
        return {
            "ln_1": {"scale": np.ones((layers, width), np.float32),
                     "bias": zeros(layers, width)},
            "ln_2": {"scale": np.ones((layers, width), np.float32),
                     "bias": zeros(layers, width)},
            "w_qkv": normal((layers, width, 3 * width), scale_attn),
            "b_qkv": zeros(layers, 3 * width),
            "w_out": normal((layers, width, width), scale_proj),
            "b_out": zeros(layers, width),
            "w_fc": normal((layers, width, 4 * width), scale_fc),
            "b_fc": zeros(layers, 4 * width),
            "w_proj": normal((layers, 4 * width, width), scale_proj),
            "b_proj": zeros(layers, width),
        }

    visual = {
        "patch_embed": normal((3 * cfg.vision_patch_size**2, vw), vscale),
        "class_embedding": normal((vw,), vscale),
        "pos_embed": normal((cfg.vision_tokens, vw), vscale),
        "ln_pre": ln(vw),
        "ln_post": ln(vw),
        "blocks": blocks(cfg.vision_layers, vw, vw**-0.5,
                         (vw**-0.5) * ((2 * cfg.vision_layers) ** -0.5),
                         (2 * vw) ** -0.5),
        "proj": normal((vw, cfg.embed_dim), vscale),
    }
    text = {
        "token_embedding": normal((cfg.vocab_size, tw), 0.02),
        "pos_embed": normal((cfg.context_length, tw), 0.01),
        "blocks": blocks(cfg.text_layers, tw, tw**-0.5,
                         (tw**-0.5) * ((2 * cfg.text_layers) ** -0.5),
                         (2 * tw) ** -0.5),
        "ln_final": ln(tw),
        "projection": normal((tw, cfg.embed_dim), tw**-0.5),
    }
    return {"visual": visual, "text": text,
            "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}


def init_clip_params(seed: int = 0, cfg: ClipConfig = VIT_B_32,
                     device=None) -> CLIP:
    """Random-init CLIP with the JAX package's weights for the same seed
    (reference init scales). Runs on ``cuda`` unless ``device`` says
    otherwise. ViT only, as in the JAX package: a ResNet tower comes from a
    checkpoint (``convert.load_clip_checkpoint``)."""
    from .convert import from_jax_params

    if cfg.vision_arch != "vit":
        raise ValueError("init_clip_params draws a ViT tower only; load a ResNet "
                         "CLIP from its checkpoint")

    return from_jax_params(_init_numpy_params(seed, cfg), cfg, device=device)
