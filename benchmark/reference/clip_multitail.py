"""Plain PyTorch reference of the multi-scale CLIP relevancy of one image
when more than one block lies past ``num_layers`` (ViT-L/14 at the CLI's
``num_layers`` = 10: 13 blocks), in float32.

It follows the same sources as ``clip.py`` beside it and reuses its
pieces (the blocks, the text tower, the jitter, the resample, the crop
plan), with the two places where those sources say more than ``clip.py``
does for a ViT of another token count than 50 or with several tail
blocks:

- the positional embedding: semantic-abstraction's CLIP
  (``clip/model_explainability.py``, ``VisionTransformer.forward``) adds
  ``interpolate_positional_emb(positional_embedding, T)``
  (``clip/auxiliary.py``) whenever the token count T is not 50: the
  embedding's first 50 rows, linearly interpolated to T positions,
  whatever its own length (ViT-L/14 has 257);
- the gradient: Chefer et al.'s ``interpret`` takes each tail block's
  gradient of the label's logit with respect to the attention probs that
  the forward pass computed (``attn_probs``, saved by a hook, not
  detached), so it flows through every later block's attention as well as
  its values. ``clip.py`` gives each block's probs as a leaf of its own,
  which cuts the later blocks' attention out of the gradient; with one
  tail block (ViT-B/32) the two agree.

It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import clip as base
from .semabs3d import operand_rounding


def positional_embedding(pos: torch.Tensor, tokens: int) -> torch.Tensor:
    """(P, W) -> (tokens, W): as ``interpolate_positional_emb`` builds it,
    row by row: position i at i / (tokens / 50) on the embedding's rows,
    linearly between the rows below and above, the last row past its end;
    the embedding itself where tokens is 50."""
    if tokens == 50:
        return pos
    rows = []
    for i in range(tokens):
        at = i / (tokens / 50)
        lo, hi = math.floor(at), math.ceil(at)
        if hi < len(pos):
            rows.append(torch.lerp(pos[lo], pos[hi], at - lo))
        else:
            rows.append(pos[-1])
    return torch.stack(rows)


def tile_relevancy(sd, c: dict, pixels: torch.Tensor, zw: torch.Tensor, num_layers: int,
                   precision: str = "float32") -> torch.Tensor:
    """(N, 3, R, R) preprocessed tiles -> (L, N, g, g): the CLS row of R over
    the image patches, R = I accumulated over the blocks past
    ``num_layers`` as R += mean_heads(relu(dlogit/dA * A)) @ R, where
    dlogit/dA is the gradient of the label's logit 100 <f/|f|, zw_l> with
    respect to the block's attention probs A as the forward pass made them."""
    q = operand_rounding(precision)
    p, w = c["vision_patch_size"], c["vision_width"]
    heads, layers = w // 64, c["vision_layers"]
    n = pixels.shape[0]
    with torch.no_grad():
        x = F.conv2d(q(pixels), q(sd["visual.conv1.weight"]), stride=p)
        x = x.flatten(2).transpose(1, 2)
        cls = sd["visual.class_embedding"].expand(n, 1, w)
        x = torch.cat([cls, x], 1)
        x = x + positional_embedding(sd["visual.positional_embedding"], x.shape[1])
        x = base._ln(x, sd, "visual.ln_pre")
        for i in range(num_layers + 1):
            x, _ = base._block(q, x, sd, f"visual.transformer.resblocks.{i}.", heads)
    probs = []
    with torch.enable_grad():
        # the weights hold no grad: the tail's input does, so that the probs
        # it makes are in the graph
        x = x.requires_grad_()
        for i in range(num_layers + 1, layers):
            x, pr = base._block(q, x, sd, f"visual.transformer.resblocks.{i}.", heads)
            probs.append(pr)
        f = q(base._ln(x[:, 0], sd, "visual.ln_post")) @ q(sd["visual.proj"])
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


def relevancy(sd, c: dict, img: np.ndarray, labels: List[str], prompt: str, config: str,
              seed: int, num_layers: int = 10, chunk: int = 32,
              precision: str = "float32") -> torch.Tensor:
    """(L, H, W) float32 relevancy of an (H, W, 3) uint8 image: ``clip.py``'s
    pipeline over this file's ``tile_relevancy``. ``chunk`` tiles go
    through the tower at a time: every tail block's activations stay alive
    for the labels' backward passes."""
    dev = sd["visual.proj"].device
    zw = base.zeroshot_weights(sd, c, labels, prompt, precision).detach()
    h, w = img.shape[:2]
    crops, augs, flip = base.crop_sizes(h, config)
    im = torch.as_tensor(np.ascontiguousarray(img.transpose(2, 0, 1)), device=dev)
    im = im.float() / 255.0
    gen = torch.Generator().manual_seed(seed)
    images = torch.stack([im] + [base.jitter(im, gen) for _ in range(augs)])
    res = c["image_resolution"]
    mean = torch.tensor(base.PIXEL_MEAN, device=dev)[:, None, None]
    std = torch.tensor(base.PIXEL_STD, device=dev)[:, None, None]
    canvas: Dict[int, torch.Tensor] = {}
    count: Dict[int, torch.Tensor] = {}
    for ts, stride in crops:
        canvas.setdefault(ts, torch.zeros((len(labels), h, w), device=dev))
        count.setdefault(ts, torch.full((h, w), 1e-5, device=dev))
        offs = base.tile_offsets(h, w, ts, stride)
        if not offs:
            continue
        rm = torch.as_tensor(base.pil_bicubic(ts, res), device=dev, dtype=torch.float32)
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
