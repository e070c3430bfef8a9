"""Chefer-style attention-gradient relevancy for ViT CLIP.

Counterpart of ``semantic_abstraction_tpu/clip/relevancy.py``. The ViT is
split at ``num_layers`` (reference default 10): the head, blocks
[0, num_layers], runs once without autograd through the fused attention
kernel; the tail blocks expose their attention probs through an additive
zero ``eps``, so that d(logit)/d(eps) == d(logit)/d(probs).

- ``_gradcam_single_tail``: the closed form for one tail block (ViT-B/32 at
  num_layers=10, the CLI's path). Only the CLS row of the last block's
  attention matters; its per-label gradient comes from ONE batched autograd
  call over the label axis.
- ``gradcam`` with more than one tail block (or ``force_general``): the
  general path (ViT-L/14 at num_layers=10 has 13 tail blocks), one batched
  backward through the tail over the labels, then for each tail block the
  accumulation R <- R + mean_heads(relu(grad * attn)) @ R through
  ``ops.cam_accumulate`` (the CUDA kernel on the card, its plain version on
  the CPU). It is also the oracle that pins the closed form in the tests.

Output: (num_labels, num_tiles, g, g) f32, g = sqrt(tokens - 1), the
CLS-row relevancy over image patches.

Stage spans (``trace.span``): ``sa.relevancy.head`` around the head scan,
``sa.relevancy.tail`` around the rest (the tail blocks, the batched
``autograd.grad``, the cam; ``cam_accumulate`` on the general path).
"""
from __future__ import annotations

import torch

from .. import trace
from ..ops.cam_accumulate import cam_accumulate
from .model import (
    ClipConfig,
    _block_forward,
    _embed,
    _ln,
    _linear,
    _qkv,
    quick_gelu,
    transformer_forward,
)


def _vit_head(visual, pixels: torch.Tensor, cfg: ClipConfig, compute_dtype,
              n_head_blocks: int) -> torch.Tensor:
    """Patch embed + blocks [0, n_head_blocks), no-probs fused attention."""
    x = _embed(visual, pixels, cfg, compute_dtype)
    blocks = visual.transformer.resblocks[:n_head_blocks]
    x, _ = transformer_forward(blocks, x, cfg.vision_heads, need_probs=False)
    return x


def _features(visual, x_cls: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Final LN + projection + L2 normalization, in f32."""
    f = torch.matmul(_ln(visual.ln_post, x_cls), visual.proj.to(compute_dtype))
    f32 = f.float()
    return f32 / torch.linalg.norm(f32, dim=-1, keepdim=True)


def _vit_tail(visual, x: torch.Tensor, cfg: ClipConfig, compute_dtype,
              n_head_blocks: int, eps):
    """Blocks [n_head_blocks, L) with attention-prob perturbations ``eps``
    (one (B, H, T, T) tensor per tail block). Returns (normalized features
    (B, E) f32, per-tail-block probs)."""
    probs_all = []
    for j, block in enumerate(visual.transformer.resblocks[n_head_blocks:]):
        x, probs = _block_forward(block, x, cfg.vision_heads, mask=None,
                                  attn_eps=eps[j])
        probs_all.append(probs)
    return _features(visual, x[:, 0, :], compute_dtype), probs_all


def _label_cotangents(zeroshot_weights: torch.Tensor, b: int) -> torch.Tensor:
    """(E, L) weights -> (L, B, E) cotangents 100 * t_l of the normalized
    features: one per label, for ``is_grads_batched``."""
    zw = zeroshot_weights.float().t()
    return (100.0 * zw)[:, None, :].expand(zw.shape[0], b, zw.shape[1])


def _gradcam_single_tail(visual, x_mid, zeroshot_weights, cfg: ClipConfig,
                         n_head: int, positive_attn_only: bool,
                         compute_dtype) -> torch.Tensor:
    """Exact fast path for one tail block, from the head's output ``x_mid``.

    With one tail block, R = I + mean_heads(relu(grad * attn)) and the
    output is R[:, 0, 1:]: only the CLS row of d(logit)/d(probs) matters,
    and within one block the logits depend on probs row 0 alone. So the
    tail runs with the CLS query only, d(logit_l)/d(attn_out_row0) is a
    (W,)-sized gradient through the MLP/LN/proj chain, and
    d(logit_l)/d(probs[h, 0, k]) = <(g_a W_out^T)_h, v[h, k]>.
    """
    block = visual.transformer.resblocks[n_head]
    heads = cfg.vision_heads
    with torch.no_grad():
        b, t, w = x_mid.shape
        hd = w // heads
        q, k, v = _qkv(block, _ln(block.ln_1, x_mid)).chunk(3, dim=-1)
        q_cls = q[:, 0].reshape(b, heads, hd) * (hd**-0.5)
        k_h = k.reshape(b, t, heads, hd).transpose(1, 2)  # (B, H, T, hd)
        v_h = v.reshape(b, t, heads, hd).transpose(1, 2)
        logits_cls = torch.einsum("bhd,bhkd->bhk", q_cls.float(), k_h.float())
        probs_cls = torch.softmax(logits_cls, dim=-1)  # (B, H, T) f32
        s = torch.einsum("bhk,bhkd->bhd", probs_cls.to(v_h.dtype), v_h)
        attn_row0 = _linear(s.reshape(b, w), block.attn.out_proj)

    with torch.enable_grad():
        a0 = attn_row0.detach().requires_grad_()
        x2_0 = x_mid[:, 0] + a0
        m = quick_gelu(_linear(_ln(block.ln_2, x2_0), block.mlp.c_fc))
        feats = _features(visual, x2_0 + _linear(m, block.mlp.c_proj),
                          compute_dtype)
        # d(100 * <f, t_l>)/d(a0) for every label l in one batched call
        (g_a,) = torch.autograd.grad(
            feats, a0, _label_cotangents(zeroshot_weights, b),
            is_grads_batched=True,
        )  # (L, B, W)
    with torch.no_grad():
        w_out = block.attn.out_proj.weight.float()  # (W_out, W_in)
        ga_heads = (g_a.float() @ w_out).reshape(-1, b, heads, hd)
        grad_probs0 = torch.einsum("lbhd,bhkd->lbhk", ga_heads, v_h.float())
        cam = grad_probs0 * probs_cls[None]
        if positive_attn_only:
            cam = cam.clamp_min(0.0)
        relevance = cam.mean(dim=2)[..., 1:]  # mean heads, drop CLS column
        g = int(round((t - 1) ** 0.5))
        return relevance.reshape(zeroshot_weights.shape[1], b, g, g)


def gradcam(visual, tiles: torch.Tensor, zeroshot_weights: torch.Tensor,
            cfg: ClipConfig, num_layers: int = 10,
            positive_attn_only: bool = True, compute_dtype=torch.float32,
            force_general: bool = False) -> torch.Tensor:
    """Relevancy maps for a batch of tiles against a batch of labels.

    tiles: (B, 3, R, R) preprocessed pixels. zeroshot_weights: (E, L).
    Returns (L, B, g, g) f32. Only blocks with index > num_layers
    contribute cams (reference cutoff).
    """
    n_head = num_layers + 1
    n_tail = cfg.vision_layers - n_head
    if n_tail < 1:
        raise ValueError("num_layers leaves no tail blocks to interpret")
    with torch.no_grad(), trace.span("sa.relevancy.head"):
        x_mid = _vit_head(visual, tiles, cfg, compute_dtype, n_head)
    # the tail's span also holds its function's return
    with trace.span("sa.relevancy.tail"):
        if n_tail == 1 and not force_general:
            return _gradcam_single_tail(visual, x_mid, zeroshot_weights, cfg, n_head,
                                        positive_attn_only, compute_dtype)
        return _gradcam_general_tail(visual, x_mid, zeroshot_weights, cfg, n_head,
                                     n_tail, positive_attn_only, compute_dtype)


def _gradcam_general_tail(visual, x_mid, zeroshot_weights, cfg: ClipConfig,
                          n_head: int, n_tail: int, positive_attn_only: bool,
                          compute_dtype) -> torch.Tensor:
    """Every tail block from the head's output ``x_mid``: one batched
    backward over the labels, then R accumulated block by block."""
    b = x_mid.shape[0]
    h_heads = cfg.vision_heads
    t = cfg.vision_tokens
    with torch.enable_grad():
        eps = [torch.zeros((b, h_heads, t, t), dtype=compute_dtype,
                           device=x_mid.device, requires_grad=True)
               for _ in range(n_tail)]
        feats, probs = _vit_tail(visual, x_mid, cfg, compute_dtype, n_head, eps)
        grads = torch.autograd.grad(
            feats, eps, _label_cotangents(zeroshot_weights, b),
            is_grads_batched=True,
        )  # per tail block: (L, B, H, T, T)
    with torch.no_grad():
        num_labels = zeroshot_weights.shape[1]
        # the first R is the identity expanded with stride 0 over (L, B): the
        # kernel reads R through its strides, so it is never materialized
        eye = torch.eye(t, dtype=torch.float32, device=x_mid.device)
        r_mat = eye.expand(num_labels, b, t, t)
        for j in range(n_tail):
            r_mat = cam_accumulate(grads[j], probs[j], r_mat, positive_attn_only)
        g = int(round((t - 1) ** 0.5))
        return r_mat[:, :, 0, 1:].reshape(num_labels, b, g, g)


def zeroshot_weights_from_features(class_template_features: torch.Tensor
                                   ) -> torch.Tensor:
    """(L, P, E) per-class per-template text features -> (E, L) weights:
    normalize each template embedding, average over templates, and do NOT
    renormalize (reference zeroshot_classifier)."""
    feats = class_template_features.float()
    feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    return feats.mean(dim=1).t()
