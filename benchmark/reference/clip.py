"""Plain PyTorch reference of the multi-scale CLIP relevancy of one image,
in float32.

Written from the sources the program follows: OpenAI CLIP's ViT and text
transformer (github.com/openai/CLIP model.py) over an OpenAI state dict,
torchvision's ColorJitter ops, PIL's antialiased bicubic resample for the
tile preprocess, Chefer et al.'s attention-gradient relevancy (R = I;
R += mean_heads(relu(dlogit/dA * A)) @ R over the blocks past
``num_layers``) and semantic-abstraction's multi-scale tiling
(generate_relevancy.py / clip_explainability: per tile size one canvas and
one count seeded at 1e-5, the mean over the configured tile sizes). It
imports nothing of the program; tokens come from the frozen tokenizer copy
beside it.

``precision`` "fp8" is the control: every matmul operand rounded to float8
e4m3 under a per-tensor scale.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .semabs3d import operand_rounding
from .tokenizer import tokenize

PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def _ln(x, sd, key):
    return F.layer_norm(x, x.shape[-1:], sd[key + ".weight"], sd[key + ".bias"], eps=1e-5)


def _attention_probs(q, x, sd, p, heads, mask=None):
    n, t, w = x.shape
    hd = w // heads
    qkv = F.linear(q(x), q(sd[p + "attn.in_proj_weight"]), sd[p + "attn.in_proj_bias"])
    qh, kh, vh = (a.reshape(n, t, heads, hd).transpose(1, 2) for a in qkv.chunk(3, -1))
    logits = q(qh * hd ** -0.5) @ q(kh).transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    return torch.softmax(logits, -1), vh


def _block(q, x, sd, p, heads, mask=None, probs_leaf=False):
    """Pre-LN residual attention block; with ``probs_leaf`` the attention
    probs are returned as a leaf that requires grad, and the block's
    output depends on them."""
    probs, vh = _attention_probs(q, _ln(x, sd, p + "ln_1"), sd, p, heads, mask)
    if probs_leaf:
        probs = probs.detach().requires_grad_()
    n, t, w = x.shape
    a = (q(probs) @ q(vh)).transpose(1, 2).reshape(n, t, w)
    x = x + F.linear(q(a), q(sd[p + "attn.out_proj.weight"]), sd[p + "attn.out_proj.bias"])
    h = F.linear(q(_ln(x, sd, p + "ln_2")), q(sd[p + "mlp.c_fc.weight"]), sd[p + "mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    x = x + F.linear(q(h), q(sd[p + "mlp.c_proj.weight"]), sd[p + "mlp.c_proj.bias"])
    return x, probs


def text_features(sd, c: dict, texts: Sequence[str], precision: str = "float32"):
    """(N, E) text features: EOT-pooled, causal mask."""
    q = operand_rounding(precision)
    dev = sd["token_embedding.weight"].device
    tokens = torch.as_tensor(tokenize(list(texts)), device=dev).long()
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"]
    t = tokens.shape[1]
    mask = torch.triu(torch.full((t, t), float("-inf"), device=dev), diagonal=1)
    for i in range(c["text_layers"]):
        x, _ = _block(q, x, sd, f"transformer.resblocks.{i}.", c["text_width"] // 64, mask)
    x = _ln(x, sd, "ln_final")
    pooled = x[torch.arange(len(texts), device=dev), tokens.argmax(-1)]
    return q(pooled) @ q(sd["text_projection"])


def zeroshot_weights(sd, c, labels, prompt, precision="float32"):
    """(E, L): each label's prompt embedding normalized (one template: no
    ensemble mean to renormalize)."""
    f = text_features(sd, c, [prompt.format(label) for label in labels], precision)
    return (f / f.norm(dim=-1, keepdim=True)).t()


def tile_relevancy(sd, c: dict, pixels: torch.Tensor, zw: torch.Tensor, num_layers: int,
                   precision: str = "float32") -> torch.Tensor:
    """(N, 3, R, R) preprocessed tiles -> (L, N, g, g): the CLS row of R over
    the image patches, R accumulated over the blocks past ``num_layers``
    from the gradient of each label's logit 100 <f/|f|, zw_l>."""
    q = operand_rounding(precision)
    p, w = c["vision_patch_size"], c["vision_width"]
    heads, layers = w // 64, c["vision_layers"]
    n = pixels.shape[0]
    with torch.no_grad():
        x = F.conv2d(q(pixels), q(sd["visual.conv1.weight"]), stride=p)
        x = x.flatten(2).transpose(1, 2)
        cls = sd["visual.class_embedding"].expand(n, 1, w)
        x = torch.cat([cls, x], 1) + sd["visual.positional_embedding"]
        x = _ln(x, sd, "visual.ln_pre")
        for i in range(num_layers + 1):
            x, _ = _block(q, x, sd, f"visual.transformer.resblocks.{i}.", heads)
    probs = []
    with torch.enable_grad():
        for i in range(num_layers + 1, layers):
            x, pr = _block(q, x, sd, f"visual.transformer.resblocks.{i}.", heads,
                           probs_leaf=True)
            probs.append(pr)
        f = q(_ln(x[:, 0], sd, "visual.ln_post")) @ q(sd["visual.proj"])
        f = f / f.norm(dim=-1, keepdim=True)
        logits = 100.0 * f @ zw  # (N, L)
        t = x.shape[1]
        out = []
        for lab in range(zw.shape[1]):
            grads = torch.autograd.grad(logits[:, lab].sum(), probs, retain_graph=True)
            r = torch.eye(t, device=x.device).expand(n, t, t)
            for g, a in zip(grads, probs):
                cam = (g * a.detach()).clamp_min(0).mean(1)
                r = r + cam @ r
            out.append(r[:, 0, 1:].detach())
    g = int(round((t - 1) ** 0.5))
    return torch.stack(out).reshape(zw.shape[1], n, g, g)


# ---------------------------------------------------------------------------
# the image pipeline
# ---------------------------------------------------------------------------


def _gray(img):
    return 0.2989 * img[0] + 0.587 * img[1] + 0.114 * img[2]


def _rgb2hsv(img):
    r, g, b = img
    maxc, minc = img.max(0).values, img.min(0).values
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    div = torch.where(eqc, ones, cr)
    rc, gc, bc = (maxc - r) / div, (maxc - g) / div, (maxc - b) / div
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = torch.fmod((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return h, s, maxc


def _hsv2rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int32) % 6
    p = (v * (1.0 - s)).clamp(0, 1)
    q = (v * (1.0 - s * f)).clamp(0, 1)
    t = (v * (1.0 - s * (1.0 - f))).clamp(0, 1)
    mask = (i[None] == torch.arange(6, device=h.device)[:, None, None]).to(h.dtype)
    table = torch.stack([torch.stack(x) for x in ((v, q, p, p, t, v), (t, v, v, q, p, p),
                                                  (p, p, t, v, v, q))])
    return torch.einsum("kij,ckij->cij", mask, table)


def jitter(img: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """torchvision ColorJitter(0.6, 0.6, 0.6, 0.1) on a (3, H, W) image in
    [0, 1], its draws from ``gen``: four uniforms (float64) for brightness,
    contrast, saturation and hue, then the order as a permutation."""
    u = torch.rand(4, generator=gen, dtype=torch.float64)
    lo = torch.tensor([0.4, 0.4, 0.4, -0.1], dtype=torch.float64)
    hi = torch.tensor([1.6, 1.6, 1.6, 0.1], dtype=torch.float64)
    fac = [float(v) for v in (lo + u * (hi - lo)).float()]
    for op in torch.randperm(4, generator=gen).tolist():
        if op == 0:
            img = (img * fac[0]).clamp(0, 1)
        elif op == 1:
            img = (fac[1] * img + (1 - fac[1]) * _gray(img).mean()).clamp(0, 1)
        elif op == 2:
            img = (fac[2] * img + (1 - fac[2]) * _gray(img)[None]).clamp(0, 1)
        else:
            h, s, v = _rgb2hsv(img)
            img = _hsv2rgb((h + fac[3]) % 1.0, s, v)
    return img


def pil_bicubic(in_size: int, out_size: int) -> np.ndarray:
    """PIL's antialiased BICUBIC resample (ImagingResample's precomputed
    coefficients, a = -0.5) as an (out, in) matrix."""
    def cubic(x):
        x = abs(x)
        if x < 1:
            return (1.5 * x - 2.5) * x * x + 1
        if x < 2:
            return ((-0.5 * x + 2.5) * x - 4) * x + 2
        return 0.0

    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    m = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo, hi = max(int(center - support + 0.5), 0), min(int(center + support + 0.5), in_size)
        w = np.array([cubic((x - center + 0.5) / fs) for x in range(lo, hi)])
        m[i, lo:hi] = w / w.sum()
    return m


def crop_sizes(img_dim: int, config: str):
    """(tile size, stride) of each configured crop."""
    if config == "ours":
        sizes = (img_dim, int(img_dim * 2 / 3), img_dim // 2, img_dim // 4)
        return [(s, s // 4) for s in sizes], 5, True
    if config == "chefer_et_al":
        return [(img_dim, img_dim // 4)], 0, False
    raise ValueError(f"unknown saliency config {config!r}")


def tile_offsets(h: int, w: int, ts: int, stride: int):
    """(row, col) of each tile: columns outer, rows inner, tiles that
    start past the other axis's extent skipped (the source's loops)."""
    return [(x, y) for y in range(0, w - ts + 1, stride) if y < h
            for x in range(0, h - ts + 1, stride) if x < w]


def relevancy(sd, c: dict, img: np.ndarray, labels: List[str], prompt: str, config: str,
              seed: int, num_layers: int = 10, chunk: int = 256,
              precision: str = "float32") -> torch.Tensor:
    """(L, H, W) float32 relevancy of an (H, W, 3) uint8 image."""
    dev = sd["visual.proj"].device
    zw = zeroshot_weights(sd, c, labels, prompt, precision).detach()
    h, w = img.shape[:2]
    crops, augs, flip = crop_sizes(h, config)
    base = torch.as_tensor(np.ascontiguousarray(img.transpose(2, 0, 1)),
                           device=dev).float() / 255.0
    gen = torch.Generator().manual_seed(seed)
    images = torch.stack([base] + [jitter(base, gen) for _ in range(augs)])
    res = c["image_resolution"]
    mean = torch.tensor(PIXEL_MEAN, device=dev)[:, None, None]
    std = torch.tensor(PIXEL_STD, device=dev)[:, None, None]
    canvas: Dict[int, torch.Tensor] = {}
    count: Dict[int, torch.Tensor] = {}
    for ts, stride in crops:
        canvas.setdefault(ts, torch.zeros((len(labels), h, w), device=dev))
        count.setdefault(ts, torch.full((h, w), 1e-5, device=dev))
        offs = tile_offsets(h, w, ts, stride)
        if not offs:
            continue
        rm = torch.as_tensor(pil_bicubic(ts, res), device=dev, dtype=torch.float32)
        work = [(i, x, y) for i in range(len(images)) for (x, y) in offs]
        rel = []
        for k in range(0, len(work), chunk):
            part = work[k:k + chunk]
            tiles = torch.stack([images[i, :, x:x + ts, y:y + ts] for i, x, y in part])
            tiles = ((rm @ tiles @ rm.t()).clamp(0, 1) - mean) / std
            r = tile_relevancy(sd, c, tiles, zw, num_layers, precision)
            if flip:
                rf = tile_relevancy(sd, c, tiles.flip(-1), zw, num_layers, precision)
                r = (r + rf.flip(-1)) / 2.0
            rel.append(r)
        rel = torch.cat(rel, 1).reshape(len(labels), len(images), len(offs), *rel[0].shape[2:])
        for j, (x, y) in enumerate(offs):
            up = F.interpolate(rel[:, :, j], size=(ts, ts), mode="bilinear",
                               align_corners=False).sum(1)
            canvas[ts][:, x:x + ts, y:y + ts] += up
            count[ts][x:x + ts, y:y + ts] += len(images)
    return sum(canvas[s] / count[s] for s in canvas) / len(canvas)
