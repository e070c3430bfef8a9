"""Multi-scale CLIP relevancy extraction (``ClipSaliency``).

Counterpart of ``semantic_abstraction_tpu/clip/saliency.py``, run eagerly:

- a static crop plan per (H, W, config) (``tile_plan``, count canvas
  bit-exact with the reference's sequential f32 adds);
- color jitter with factors and op order drawn from a caller-seeded
  ``torch.Generator`` (the draws are inputs of ``color_jitter``);
- per scale, tile chunks (same divisor rule as the JAX package): crop,
  PIL-parity bicubic resize as two matmuls, CLIP normalization, gradcam
  with the label axis chunked, and the horizontal-flip average;
- the scatter-free overlap-add canvas (``_accumulate_body``), normalized
  by the plan's count;
- the cross-scale mean over the number of unique tile sizes of ALL
  configured crops (dead ones too), with duplicate tile sizes merged, cast
  to float16;
- distractor labels stacked beside the labels and subtracted in f32.

``get_visual_feature`` gives one image's CLIP features (ViT or ResNet
tower) through the reference preprocess.

Stage spans (``trace.span``; nothing unless the torch profiler is on):
``sa.relevancy.image`` around ``get_clip_saliency``, and within it, every
launch in one of ``sa.relevancy.text`` (the zeroshot weights),
``.images`` (upload and jitter), ``.plan`` (the crop plan; a scale's
chunking, index, offset and count arrays and their uploads), ``.tiles``
(``extract_tiles``, the flip), ``.head`` and ``.tail``
(``clip/relevancy.py``) and ``.canvas`` (flip average, overlap-add,
normalisation, merge, mean, cast, distractor subtraction).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..ops.sampling import resize_matrix
from .model import CLIP, ClipConfig, VIT_B_32, encode_image, encode_text
from .relevancy import gradcam, zeroshot_weights_from_features
from .tokenizer import tokenize

CLIP_PIXEL_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_PIXEL_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def gradcam_label_chunked(visual, tiles, zw, prompt_batch_size, **kw):
    """gradcam with the label axis chunked at ``prompt_batch_size``
    (reference prompt_batch_size=32): one chunk's attention grads live at a
    time on the general path. Labels are independent, so chunks need no
    padding."""
    l = zw.shape[1]
    if l <= prompt_batch_size:
        return gradcam(visual, tiles, zw, **kw)
    parts = [gradcam(visual, tiles, zw[:, i:i + prompt_batch_size], **kw)
             for i in range(0, l, prompt_batch_size)]
    with trace.span("sa.relevancy.tail"):
        return torch.cat(parts, dim=0)


@dataclasses.dataclass(frozen=True)
class CropSpec:
    tile_size: int
    stride: int


@dataclasses.dataclass(frozen=True)
class SaliencyConfig:
    """Mirror of the reference saliency_configs entries. ``distractor_labels``:
    labels whose mean relevancy is subtracted from every requested label's
    map, merged with any per-call distractors."""

    crops: Tuple[CropSpec, ...]
    horizontal_flipping: bool = True
    augmentations: int = 5
    positive_attn_only: bool = True
    imagenet_prompt_ensemble: bool = False
    distractor_labels: Tuple[str, ...] = ()


def ours_config(img_dim: int) -> SaliencyConfig:
    return SaliencyConfig(
        crops=(
            CropSpec(img_dim, img_dim // 4),
            CropSpec(int(img_dim * 2 / 3), int(img_dim * 2 / 3) // 4),
            CropSpec(img_dim // 2, (img_dim // 2) // 4),
            CropSpec(img_dim // 4, (img_dim // 4) // 4),
        ),
        horizontal_flipping=True,
        augmentations=5,
    )


def chefer_et_al_config(img_dim: int) -> SaliencyConfig:
    return SaliencyConfig(
        crops=(CropSpec(img_dim, img_dim // 4),),
        horizontal_flipping=False,
        augmentations=0,
        distractor_labels=(),
    )


saliency_configs = {"ours": ours_config, "chefer_et_al": chefer_et_al_config}

# The standard OpenAI CLIP ImageNet prompt-ensemble templates (used when
# SaliencyConfig.imagenet_prompt_ensemble is set).
IMAGENET_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.",
    "the embroidered {}.", "a photo of a hard to see {}.",
    "a bright photo of a {}.", "a photo of a clean {}.",
    "a photo of a dirty {}.", "a dark photo of the {}.",
    "a drawing of a {}.", "a photo of my {}.", "the plastic {}.",
    "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.",
    "a photo of the dirty {}.", "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.", "a photo of the {}.",
    "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.",
    "the origami {}.", "the {} in a video game.", "a sketch of a {}.",
    "a doodle of the {}.", "a origami {}.",
    "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.",
    "a photo of a nice {}.", "a photo of a weird {}.",
    "a blurry photo of a {}.", "a cartoon {}.", "art of a {}.",
    "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.",
    "a photo of the small {}.", "a photo of the weird {}.",
    "the cartoon {}.", "art of the {}.", "a drawing of the {}.",
    "a photo of the large {}.", "a black and white photo of a {}.",
    "the plushie {}.", "a dark photo of a {}.", "itap of a {}.",
    "graffiti of the {}.", "a toy {}.", "itap of my {}.",
    "a photo of a cool {}.", "a photo of a small {}.", "a tattoo of the {}.",
]


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    tile_size: int
    stride: int
    nx: int  # tiles along rows (x offsets = arange(nx) * stride)
    ny: int  # tiles along cols
    offsets: np.ndarray  # (T, 2) int32 rows (x) / cols (y), per base image
    count: np.ndarray  # (H, W) float32 accumulation normalizer (all images)


@functools.lru_cache(maxsize=64)
def tile_plan(hw: Tuple[int, int], crops: Tuple[CropSpec, ...],
              num_images: int) -> Tuple[ScalePlan, ...]:
    """Static crop plan for an (H, W) image (reference create_tiles,
    including its y<H / x<W skip quirks and the 1e-5-seeded per-scale count
    canvases). Tiles form a regular (nx, ny) grid with spacing ``stride``.
    The count canvas replays the reference's sequential f32 adds
    (1e-5 += num_images, k times) through a k-indexed table over the
    separable per-axis coverage: bit-exact at O(H*W)."""
    h, w = hw
    plans = []
    for crop in crops:
        ts, stride = crop.tile_size, crop.stride
        ys = [y for y in range(0, w - ts + 1, stride) if y < h]
        xs = [x for x in range(0, h - ts + 1, stride) if x < w]
        # reference iterates y (cols) outer, x (rows) inner
        offs = [(x, y) for y in ys for x in xs]
        offsets = np.asarray(offs, dtype=np.int32).reshape(-1, 2)
        rowc = np.zeros(h + 1, np.int64)
        for x in xs:
            rowc[x] += 1
            rowc[min(x + ts, h)] -= 1
        colc = np.zeros(w + 1, np.int64)
        for y in ys:
            colc[y] += 1
            colc[min(y + ts, w)] -= 1
        cover = np.outer(np.cumsum(rowc[:-1]), np.cumsum(colc[:-1]))
        seq = np.empty(int(cover.max()) + 1, np.float32)
        seq[0] = np.float32(1e-5)
        for k in range(1, len(seq)):
            seq[k] = np.float32(seq[k - 1] + np.float32(num_images))
        count = seq[cover]
        plans.append(ScalePlan(ts, stride, len(xs), len(ys), offsets, count))
    return tuple(plans)


# ---------------------------------------------------------------------------
# Color jitter (torchvision ColorJitter(brightness=.6, contrast=.6,
# saturation=.6, hue=.1) distribution; the draws are inputs)
# ---------------------------------------------------------------------------


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    # torchvision rgb_to_grayscale weights
    return 0.2989 * img[0] + 0.587 * img[1] + 0.114 * img[2]


def _adjust_brightness(img, factor):
    return torch.clamp(img * factor, 0.0, 1.0)


def _adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean()
    return torch.clamp(img * factor + (1.0 - factor) * mean, 0.0, 1.0)


def _adjust_saturation(img, factor):
    gray = _rgb_to_gray(img)[None]
    return torch.clamp(img * factor + (1.0 - factor) * gray, 0.0, 1.0)


def _adjust_hue(img, shift):
    r, g, b = img[0], img[1], img[2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    zero = torch.zeros_like(c)
    s = torch.where(maxc > 0, c / torch.clamp_min(maxc, 1e-12), zero)
    safe_c = torch.clamp_min(c, 1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    hr = torch.where(maxc == r, bc - gc, zero)
    hg = torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, zero)
    hb = torch.where((maxc != r) & (maxc != g), 4.0 + gc - rc, zero)
    hue = torch.remainder((hr + hg + hb) / 6.0, 1.0)
    hue = torch.where(c > 0, hue, zero)
    hue = torch.remainder(hue + shift, 1.0)
    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # vals[k] where i == k (jnp.select)
        out = vals[-1]
        for k in range(len(vals) - 2, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=0)


_JITTER_OPS = (_adjust_brightness, _adjust_contrast, _adjust_saturation,
               _adjust_hue)


def draw_jitter(generator: torch.Generator, brightness: float = 0.6,
                contrast: float = 0.6, saturation: float = 0.6,
                hue: float = 0.1):
    """One jitter draw on the host: (factors (4,) f32 = brightness,
    contrast, saturation, hue shift; op order (4,) permutation)."""
    u = torch.rand(4, generator=generator, dtype=torch.float64)
    lo = torch.tensor([1 - brightness, 1 - contrast, 1 - saturation, -hue],
                      dtype=torch.float64)
    hi = torch.tensor([1 + brightness, 1 + contrast, 1 + saturation, hue],
                      dtype=torch.float64)
    factors = (lo + u * (hi - lo)).float()
    return factors, torch.randperm(4, generator=generator)


def color_jitter(img: torch.Tensor, factors, order) -> torch.Tensor:
    """One jittered copy of a (3, H, W) image in [0, 1]: the four ops with
    ``factors`` (brightness, contrast, saturation, hue shift), applied in
    ``order`` (a permutation of 0..3)."""
    for op in [int(o) for o in order]:
        img = _JITTER_OPS[op](img, float(factors[op]))
    return img


# ---------------------------------------------------------------------------
# Tiles and the overlap-add canvas
# ---------------------------------------------------------------------------


def extract_tiles(images: torch.Tensor, img_idx: torch.Tensor,
                  offsets: torch.Tensor, tile_size: int,
                  resolution: int = 224) -> torch.Tensor:
    """(I, 3, H, W) images, (N,) image indices and (N, 2) offsets ->
    (N, 3, R, R) CLIP inputs: crop, PIL-parity bicubic resize as two
    matmuls, clip to [0, 1], CLIP normalization."""
    dev = images.device
    ar = torch.arange(tile_size, device=dev)
    rows = (offsets[:, 0, None] + ar)[:, None, :, None]
    cols = (offsets[:, 1, None] + ar)[:, None, None, :]
    ch = torch.arange(3, device=dev)[None, :, None, None]
    tiles = images[img_idx[:, None, None, None], ch, rows, cols]  # (N,3,ts,ts)
    rm = torch.as_tensor(resize_matrix(tile_size, resolution, "bicubic_pil"),
                         device=dev)
    tiles = torch.matmul(rm, tiles)          # "bchw,oh->bcow"
    tiles = torch.matmul(tiles, rm.t())      # "bcow,pw->bcop"
    mean = torch.as_tensor(CLIP_PIXEL_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(CLIP_PIXEL_STD, device=dev)[:, None, None]
    return (tiles.clamp(0.0, 1.0) - mean) / std


def _accumulate_body(rel: torch.Tensor, plan: ScalePlan, hw: Tuple[int, int],
                     n_images: int) -> torch.Tensor:
    """(L, I*ny*nx, g, g) tile relevancies -> (L, H, W) canvas sum.

    Scatter-free overlap-add: tiles form a regular grid with spacing s, so
    each covers k = ceil(ts / s) stride-cells per axis. Summing over the
    image axis first (the upsample is linear), the canvas is k*k shifted
    slice-adds of upsampled s-blocks."""
    ts, s, nx, ny = plan.tile_size, plan.stride, plan.nx, plan.ny
    g = rel.shape[-1]
    k = -(-ts // s)  # ceil
    up = np.zeros((k * s, g), np.float32)
    up[:ts] = resize_matrix(g, ts, "bilinear_torch")
    up = torch.as_tensor(up, device=rel.device)
    h, w = hw
    l = rel.shape[0]
    gsum = rel.reshape(l, n_images, ny, nx, g, g).sum(dim=1)
    cells = torch.zeros((l, nx + k - 1, ny + k - 1, s, s), dtype=torch.float32,
                        device=rel.device)
    for di in range(k):
        rrow = up[di * s:(di + 1) * s]
        for dj in range(k):
            rcol = up[dj * s:(dj + 1) * s]
            block = torch.einsum("lyxgh,pg,qh->lxypq", gsum, rrow, rcol)
            cells[:, di:di + nx, dj:dj + ny] += block
    big = cells.permute(0, 1, 3, 2, 4).reshape(
        l, (nx + k - 1) * s, (ny + k - 1) * s)
    bh, bw = big.shape[1:]
    big = torch.nn.functional.pad(big, (0, max(0, w - bw), 0, max(0, h - bh)))
    return big[:, :h, :w]


def _chunk_size(n: int, tile_batch_size: int) -> int:
    """Tile chunk: an exact divisor of n near the configured batch where
    one exists (no dead padded tiles), else the batch with padding."""
    bs = min(tile_batch_size, n)
    if n > bs:
        lo, hi = max(1, bs // 2), bs + bs // 2
        divisors = [d for d in range(lo, hi + 1) if n % d == 0]
        if divisors:
            bs = max(divisors)
    return bs


# ---------------------------------------------------------------------------
# The extractor
# ---------------------------------------------------------------------------


class ClipSaliency:
    """Multi-scale Chefer relevancy extractor over the port's CLIP.

    ``model`` is a ``CLIP`` module; it runs on the device its parameters
    are on, and its parameters are set to not require grad (the gradcam
    differentiates with respect to activations only)."""

    def __init__(self, model: CLIP, cfg: ClipConfig = VIT_B_32,
                 compute_dtype=torch.float32, tile_batch_size: int = 32,
                 prompt_batch_size: int = 32, num_layers: int = 10):
        self.model = model.requires_grad_(False)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.tile_batch_size = tile_batch_size
        self.prompt_batch_size = prompt_batch_size
        self.num_layers = num_layers

    @property
    def device(self) -> torch.device:
        return self.model.logit_scale.device

    def text_features(self, texts: Sequence[str]) -> torch.Tensor:
        """Raw (unnormalized) CLIP text features (N, E), f32."""
        tokens = torch.as_tensor(tokenize(list(texts)), device=self.device)
        with torch.no_grad():
            return encode_text(self.model, tokens, self.cfg, torch.float32)

    def zeroshot_weights(self, labels: Sequence[str],
                         templates: Sequence[str]) -> torch.Tensor:
        """(E, L) prompt-ensembled zeroshot weights."""
        texts = [t.format(label) for label in labels for t in templates]
        feats = self.text_features(texts).reshape(len(labels), len(templates), -1)
        return zeroshot_weights_from_features(feats)

    def get_clip_saliency(
        self,
        img: np.ndarray,
        text_labels: Sequence[str],
        prompts: Sequence[str] = ("{}",),
        config: Optional[SaliencyConfig] = None,
        generator: Optional[torch.Generator] = None,
        distractor_labels: Sequence[str] = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H, W, 3) uint8 image + labels -> ((L, H, W) float16 relevancy,
        (L, E) prompt-ensembled text features). The jitter draws come from
        ``generator`` (a CPU ``torch.Generator``; seed 0 when None)."""
        with trace.span("sa.relevancy.image"):
            if self.cfg.vision_arch != "vit":
                raise ValueError(
                    "relevancy extraction is transformer-only (the reference "
                    "ClipGradcam supports only ViT models, clip_gradcam.py:51-56); "
                    "ModifiedResNet checkpoints serve text/visual features only")
            if config is None:
                config = ours_config(min(img.shape[:2]))
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            if config.imagenet_prompt_ensemble:
                prompts = IMAGENET_TEMPLATES
            with trace.span("sa.relevancy.text"):
                zw = self.zeroshot_weights(list(text_labels), list(prompts))
            n_labels = zw.shape[1]
            label_feats = zw.t()
            distractor_labels = tuple(distractor_labels) + tuple(
                d for d in config.distractor_labels if d not in set(distractor_labels)
            )
            extra = [d for d in distractor_labels if d not in set(text_labels)]
            if not extra:
                return self._saliency_convolve(img, zw, config, generator), label_feats
            # one shared pass: each label's gradcam is independent, so the
            # distractor columns ride beside the labels
            with trace.span("sa.relevancy.text"):
                both = torch.cat([zw, self.zeroshot_weights(extra, list(prompts))], dim=1)
            all_maps = self._saliency_convolve(img, both, config, generator)
            with trace.span("sa.relevancy.canvas"):
                # subtract in f32: differencing nearly-equal f16 maps loses precision
                maps = (all_maps[:n_labels].float()
                        - all_maps[n_labels:].float().mean(dim=0)).half()
            return maps, label_feats

    def get_visual_feature(self, rgb: np.ndarray, tile_attn_mask=None) -> torch.Tensor:
        """(E,) CLIP image features of an (H, W, 3) uint8 image in the
        extractor's compute dtype, optionally with an additive (T, T)
        attention mask in every ViT block (reference
        ClipWrapper.get_visual_feature, __init__.py:92-101).

        The reference clip_preprocess: the SHORT side resized to the
        model's resolution r with PIL's bicubic (the long side to
        ``int(r * long / short)``, truncated), a CenterCrop at
        ``round((o - r) / 2)``, a clip to [0, 1], the CLIP mean and std.
        Without a mask the ViT blocks run the fused attention kernel."""
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        r = self.cfg.image_resolution
        oh, ow = (int(r * h / w), r) if w <= h else (r, int(r * w / h))
        dev = self.device
        rm_h = torch.as_tensor(resize_matrix(h, oh, "bicubic_pil"), device=dev)
        rm_w = torch.as_tensor(resize_matrix(w, ow, "bicubic_pil"), device=dev)
        top, left = int(round((oh - r) / 2.0)), int(round((ow - r) / 2.0))
        img = torch.as_tensor(np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                              device=dev).float()[None] / 255.0
        img = torch.matmul(torch.matmul(rm_h, img), rm_w.t())  # rows, then columns
        img = img[:, :, top:top + r, left:left + r].clamp(0.0, 1.0)
        mean = torch.as_tensor(CLIP_PIXEL_MEAN, device=dev)[:, None, None]
        std = torch.as_tensor(CLIP_PIXEL_STD, device=dev)[:, None, None]
        mask = None if tile_attn_mask is None else torch.as_tensor(tile_attn_mask,
                                                                   device=dev)
        with torch.no_grad():
            return encode_image(self.model, (img - mean) / std, self.cfg,
                                self.compute_dtype, tile_attn_mask=mask)[0]

    def _images(self, img: np.ndarray, augmentations: int,
                generator: torch.Generator) -> torch.Tensor:
        """uint8 (H, W, 3) -> (1 + augs, 3, H, W) f32 image stack on the
        device: the base image and its jittered copies."""
        base = torch.as_tensor(np.ascontiguousarray(img.transpose(2, 0, 1)),
                               device=self.device).float() / 255.0
        draws = [draw_jitter(generator) for _ in range(augmentations)]
        return torch.stack([base] + [color_jitter(base, f, o) for f, o in draws])

    def _scale_canvas(self, images: torch.Tensor, zw: torch.Tensor,
                      plan: ScalePlan, config: SaliencyConfig) -> torch.Tensor:
        """One scale: chunked tiles -> gradcam (+ flip average) ->
        overlap-add canvas divided by the plan's count."""
        with trace.span("sa.relevancy.plan"):
            n_images, _, h, w = images.shape
            t_count = plan.offsets.shape[0]
            n = n_images * t_count
            bs = _chunk_size(n, self.tile_batch_size)
            pad = (-n) % bs
            img_idx = np.concatenate([np.arange(n) // t_count,
                                      np.zeros(pad, np.int64)])
            offs = np.concatenate([np.tile(plan.offsets, (n_images, 1)),
                                   np.zeros((pad, 2), np.int32)]).astype(np.int64)
            img_idx = torch.as_tensor(img_idx, device=self.device)
            offs = torch.as_tensor(offs, device=self.device)
            count = torch.as_tensor(plan.count, device=self.device)
            kw = dict(prompt_batch_size=self.prompt_batch_size, cfg=self.cfg,
                      num_layers=self.num_layers,
                      positive_attn_only=config.positive_attn_only,
                      compute_dtype=self.compute_dtype)
        rels = []
        for c in range(0, n + pad, bs):
            with trace.span("sa.relevancy.tiles"):
                tiles = extract_tiles(images, img_idx[c:c + bs], offs[c:c + bs],
                                      plan.tile_size, self.cfg.image_resolution)
            rel = gradcam_label_chunked(self.model.visual, tiles, zw, **kw)
            if config.horizontal_flipping:
                with trace.span("sa.relevancy.tiles"):
                    flipped = tiles.flip(-1)
                rel_f = gradcam_label_chunked(self.model.visual, flipped, zw, **kw)
                with trace.span("sa.relevancy.canvas"):
                    rel = (rel + rel_f.flip(-1)) / 2.0
            rels.append(rel)  # (L, bs, g, g)
        with trace.span("sa.relevancy.canvas"):
            rel = torch.cat(rels, dim=1)[:, :n]
            canvas = _accumulate_body(rel, plan, (h, w), n_images)
            return canvas / count[None]

    def _saliency_convolve(self, img: np.ndarray, zw: torch.Tensor,
                           config: SaliencyConfig,
                           generator: torch.Generator) -> torch.Tensor:
        h, w = img.shape[:2]
        with trace.span("sa.relevancy.plan"):
            plans = tile_plan((h, w), config.crops, 1 + config.augmentations)
            live = [p for p in plans if p.offsets.shape[0] > 0]
        if not live:
            raise ValueError(
                f"no crop in the saliency config fits a {h}x{w} image "
                f"(tile sizes {[p.tile_size for p in plans]})"
            )
        with trace.span("sa.relevancy.images"):
            images = self._images(img, config.augmentations, generator)
        by_size: dict = {}
        for plan in live:
            cv = self._scale_canvas(images, zw, plan, config)
            by_size.setdefault(plan.tile_size, []).append((plan, cv))
        with trace.span("sa.relevancy.canvas"):
            merged = []
            for items in by_size.values():
                if len(items) == 1:
                    merged.append(items[0][1])
                    continue
                # duplicate tile sizes share one canvas and count (the reference
                # keys both by tile size): un-normalize, sum, renormalize by the
                # shared count (1e-5 seeded once, not per crop)
                s = sum(cv * torch.as_tensor(p.count, device=self.device)[None]
                        for p, cv in items)
                shared = (sum(p.count for p, _ in items)
                          - (len(items) - 1) * np.float32(1e-5))
                merged.append(s / torch.as_tensor(shared, device=self.device)[None])
            # divide by the unique tile sizes of ALL configured crops: sizes
            # whose crops fit no tile still count (reference quirk)
            n_unique = len({p.tile_size for p in plans})
            return (sum(merged) / n_unique).half()
