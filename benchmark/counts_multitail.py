"""The operations and bytes of CLIP relevancy on the general path: more
than one block past ``num_layers`` (ViT-L/14 at the CLI's 10 has 13), one
backward pass a label through the tail, and the Chefer accumulation
R <- R + mean_heads(relu(g A)) @ R a label and tail block (K2,
``ops/csrc/cam_accumulate.cu``). Counted from the shapes the algorithm
needs, as ``counts.py`` counts the closed form, whose peaks, crop plan and
block count it uses.

FLOPs count a multiply-add as 2; the weights take no gradient.
"""
from __future__ import annotations

from benchmark import counts


def block_backward_flops(t: int, w: int) -> int:
    """The gradient of one pre-LN block's input from its output's: back
    through the MLP, out, qkv projections (24 T W^2) and the attention
    (dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q: 8 T^2 W)."""
    return 24 * t * w * w + 8 * t * t * w


def first_block_backward_flops(t: int, w: int) -> int:
    """The first tail block, back only as far as its attention probs: the
    MLP (16 T W^2), the out projection (2 T W^2) and dP = dO V^T (2 T^2 W)."""
    return 18 * t * w * w + 2 * t * t * w


def tail_blocks(c: dict, num_layers: int) -> int:
    n = c["vision_layers"] - num_layers - 1
    if n < 1:
        raise ValueError("num_layers leaves no tail blocks")
    return n


def relevancy_tile_flops(c: dict, labels: int, num_layers: int = 10) -> int:
    """One tile: the patch embed, the head blocks (up to ``num_layers``)
    and the tail blocks over all T tokens, the CLS row's final projection;
    per label, the backward from the features to the first tail block's
    probs (the final projection, then every tail block at full T, since
    every row of every later block reaches the CLS output) and one
    (T, T) @ (T, T) product a tail block."""
    t, w = counts.vit_tokens(c), c["vision_width"]
    e, p = c["embed_dim"], c["vision_patch_size"]
    n_tail = tail_blocks(c, num_layers)
    embed = 2 * (t - 1) * 3 * p * p * w
    forward = (num_layers + 1 + n_tail) * counts.block_flops(t, w) + 2 * w * e
    backward = (2 * w * e + first_block_backward_flops(t, w)
                + (n_tail - 1) * block_backward_flops(t, w))
    cam = n_tail * 2 * t ** 3
    return embed + forward + labels * (backward + cam)


def relevancy_image_flops(c: dict, h: int, w: int, config: str, labels: int,
                          num_layers: int = 10) -> int:
    return (counts.text_flops(c, labels)
            + counts.tiles_per_image(h, w, config) * relevancy_tile_flops(c, labels, num_layers))


def cam_bound_s(labels: int, b: int, heads: int, t: int, dtype: str) -> float:
    """Least seconds of one K2 launch: the gradient (L, B, H, T, T) and the
    probs (B, H, T, T) read once in ``dtype``, R (L, B, T, T) read and
    written once in f32, at the HBM rate; or the L B products
    (T, T) @ (T, T) as three TF32 products; the larger."""
    tt = t * t
    nbytes = (labels * b * heads * tt + b * heads * tt) * counts.DTYPE_BYTES[dtype]
    nbytes += 2 * labels * b * tt * 4
    flops = 2 * labels * b * t ** 3
    return max(nbytes / counts.HBM_BYTES_PER_S, 3 * flops / counts.PEAK_FLOPS["tf32"])


def relevancy_cam_bound_s(c: dict, h: int, w: int, config: str, dtype: str, labels: int,
                          num_layers: int = 10) -> float:
    """Least seconds of K2 an image: every tile through every tail block."""
    width = c["vision_width"]
    return tail_blocks(c, num_layers) * cam_bound_s(
        labels, counts.tiles_per_image(h, w, config), width // 64, counts.vit_tokens(c), dtype)
