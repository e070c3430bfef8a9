"""The yardstick's arithmetic: the chip's published peaks, and the
operations and bytes that each piece of work needs, counted from the
shapes the algorithm needs, whatever implements it.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16 and fp16, 495
TFLOP/s TF32, 67 TFLOP/s f32 outside the tensor cores, HBM3 at 3.35 TB/s;
at the card's full 700 W.

FLOPs count a multiply-add as 2. A roofline bound reads each input once
and writes each output once.
"""
from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def mha_bound_s(b: int, t: int, w: int, heads: int, dtype: str) -> float:
    """Least seconds of fused multi-head attention over (B, T, W) q, k, v:
    q, k, v read and out written once at the HBM rate, or QK^T and PV
    (4 B H T T hd flops) on the tensor cores (bf16 at its rate; f32 as
    three TF32 products), the larger."""
    elt = DTYPE_BYTES[dtype]
    bytes_s = 4 * b * t * w * elt / HBM_BYTES_PER_S
    flops = 4 * b * heads * t * t * (w // heads)
    flops_s = (flops / PEAK_FLOPS["bfloat16"] if dtype != "float32"
               else 3 * flops / PEAK_FLOPS["tf32"])
    return max(bytes_s, flops_s)


def moments_bound_s(b: int, c: int, s: int, dtype: str) -> float:
    """Least seconds of the per-channel (sum x, sum x^2) of a (B, C, S)
    tensor: x read once and the two (B, C) f32 outputs written once, or 3
    flops an element at the f32 peak, the larger."""
    bytes_s = (b * c * s * DTYPE_BYTES[dtype] + 8 * b * c) / HBM_BYTES_PER_S
    return max(bytes_s, 3 * b * c * s / PEAK_FLOPS["float32"])


def moments_backward_bound_s(b: int, c: int, s: int, dtype: str) -> float:
    """Least seconds of gx = g1 + 2 x g2 over a (B, C, S) tensor: x read
    and gx written once, the two (B, C) f32 gradients read once, or 3
    flops an element at the f32 peak, the larger."""
    bytes_s = (2 * b * c * s * DTYPE_BYTES[dtype] + 8 * b * c) / HBM_BYTES_PER_S
    return max(bytes_s, 3 * b * c * s / PEAK_FLOPS["float32"])


# ---------------------------------------------------------------------------
# CLIP relevancy
# ---------------------------------------------------------------------------


def crop_plan(h: int, w: int, config: str) -> Tuple[List[Tuple[int, int]], int, bool]:
    """((tile size, stride) of each crop, jittered copies, flip) of a
    saliency config on an (H, W) image, the crops sized from H."""
    if config == "ours":
        sizes = (h, int(h * 2 / 3), h // 2, h // 4)
        return [(s, s // 4) for s in sizes], 5, True
    if config == "chefer_et_al":
        return [(h, h // 4)], 0, False
    raise ValueError(f"unknown saliency config {config!r}")


def tiles_per_image(h: int, w: int, config: str) -> int:
    """CLIP inputs an image needs: each crop's tiles (columns outer, rows
    inner, tiles starting past the other axis skipped), over the image and
    its jittered copies, twice with the flip."""
    crops, augs, flip = crop_plan(h, w, config)
    n = 0
    for ts, stride in crops:
        cols = [y for y in range(0, w - ts + 1, stride) if y < h]
        rows = [x for x in range(0, h - ts + 1, stride) if x < w]
        n += len(cols) * len(rows)
    return n * (1 + augs) * (2 if flip else 1)


def block_flops(t: int, w: int) -> int:
    """One pre-LN transformer block over T tokens of width W: the qkv, out
    and MLP (4W) projections, QK^T and PV."""
    return 24 * t * w * w + 4 * t * t * w


def vit_tokens(c: dict) -> int:
    return (c["image_resolution"] // c["vision_patch_size"]) ** 2 + 1


def text_flops(c: dict, prompts: int) -> int:
    """The text tower over ``prompts`` prompts at the full context, and
    the projection."""
    t, w = c["context_length"], c["text_width"]
    return prompts * (c["text_layers"] * block_flops(t, w) + 2 * w * c["embed_dim"])


def relevancy_tile_flops(c: dict, labels: int, num_layers: int = 10) -> int:
    """One tile's forward through the ViT (the patch embed, the blocks up to
    ``num_layers``, and the last block as far as its CLS output needs: qkv
    of every token, the CLS row's attention, out and MLP projections, the
    final LN and projection) and, per label, the closed-form tail gradient
    (back through the projection, the MLP and the out projection, then the
    CLS row against V)."""
    t, w, e, p = vit_tokens(c), c["vision_width"], c["embed_dim"], c["vision_patch_size"]
    if c["vision_layers"] - num_layers - 1 != 1:
        raise ValueError("counted for one tail block")
    embed = 2 * (t - 1) * 3 * p * p * w
    head = (num_layers + 1) * block_flops(t, w)
    tail = 6 * t * w * w + 4 * t * w + 2 * w * w + 16 * w * w + 2 * w * e
    grad = 2 * w * e + 16 * w * w + 2 * w * w + 2 * t * w
    return embed + head + tail + labels * grad


def relevancy_image_flops(c: dict, h: int, w: int, config: str, labels: int,
                          num_layers: int = 10) -> int:
    return (text_flops(c, labels)
            + tiles_per_image(h, w, config) * relevancy_tile_flops(c, labels, num_layers))


def relevancy_mha_bound_s(c: dict, h: int, w: int, config: str, dtype: str,
                          num_layers: int = 10) -> float:
    """Least seconds of the fused attention an image needs: every tile
    through every head-scan block (the blocks up to ``num_layers``)."""
    tiles = tiles_per_image(h, w, config)
    width = c["vision_width"]
    return (num_layers + 1) * mha_bound_s(tiles, vit_tokens(c), width, width // 64, dtype)


# ---------------------------------------------------------------------------
# SemAbs3D
# ---------------------------------------------------------------------------


def unet_fmaps(c: dict) -> List[int]:
    return [c["unet_f_maps"] * 2 ** k for k in range(c["unet_num_levels"])]


def _levels(c: dict) -> List[int]:
    """Voxels of each level's volume, finest first."""
    vox = c["voxel_shape"][0] * c["voxel_shape"][1] * c["voxel_shape"][2]
    return [vox // 8 ** k for k in range(c["unet_num_levels"])]


def unet3d_flops(c: dict, volumes: int) -> int:
    """Forward of the ResidualUNet3D over ``volumes`` volumes: each
    ExtResNetBlock's three 3^3 convs, each decoder's 3^3 transposed conv
    (every input voxel to 27 outputs), the final 1^3 conv."""
    fm, vox, ch = unet_fmaps(c), _levels(c), c["unet_num_channels"]
    n = 0
    ins = [ch] + fm[:-1]
    for i, (a, b) in enumerate(zip(ins, fm)):
        n += 2 * 27 * vox[i] * (a * b + 2 * b * b)
    for i in range(len(fm) - 1, 0, -1):
        a, b = fm[i], fm[i - 1]
        n += 2 * 27 * vox[i] * a * b  # transposed conv
        n += 2 * 27 * vox[i - 1] * 3 * b * b
    n += 2 * vox[0] * fm[0] * ch
    return volumes * n


def unet_groupnorm_shapes(c: dict, volumes: int) -> List[Tuple[int, int, int]]:
    """(B, C, S) of every GroupNorm's input: three a block, over the
    conv's input channels."""
    fm, vox, ch = unet_fmaps(c), _levels(c), c["unet_num_channels"]
    shapes = []
    for i, (a, b) in enumerate(zip([ch] + fm[:-1], fm)):
        shapes += [(volumes, a, vox[i]), (volumes, b, vox[i]), (volumes, b, vox[i])]
    for i in range(len(fm) - 1, 0, -1):
        shapes += [(volumes, fm[i - 1], vox[i - 1])] * 3
    return shapes


def semabs3d_forward_flops(c: dict, batch: int, parts: int, num_input: int,
                           num_output: int) -> int:
    """The point-feature MLP over every patch's input points, the UNet over
    every patch's volume, and the decoder at every query point (the 8
    corners of its trilinear sample, then its two linears)."""
    vols = batch * parts
    h, ch = c["pts_feat_extractor_hidden_dim"], c["unet_num_channels"]
    pfe = vols * num_input * 2 * (4 * h + h * h + h * ch)
    d_in = ch + 3 * bool(c["decoder_concat_xyz_pts"])
    dec = vols * num_output * (2 * 8 * ch + 2 * (d_in * ch + ch * c["output_dim"]))
    return pfe + unet3d_flops(c, vols) + dec


def semabs3d_step_flops(c: dict, batch: int, parts: int, num_input: int,
                        num_output: int) -> int:
    """A train step: the forward, and twice the forward for the backward."""
    return 3 * semabs3d_forward_flops(c, batch, parts, num_input, num_output)


def moments_step_bound_s(c: dict, volumes: int, dtype: str) -> float:
    """The forward and backward moments of every GroupNorm of a step."""
    return sum(moments_bound_s(*s, dtype) + moments_backward_bound_s(*s, dtype)
               for s in unet_groupnorm_shapes(c, volumes))

